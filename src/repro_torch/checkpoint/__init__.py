"""Pytree checkpointing (npz-based, with a JSON manifest), in the
reference's on-disk format."""
from repro_torch.checkpoint.io import (latest_step, restore_checkpoint,
                                       save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
