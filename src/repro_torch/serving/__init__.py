"""Batched serving engine."""
from repro_torch.serving.engine import Completion, Request, ServingEngine

__all__ = ["Completion", "Request", "ServingEngine"]
