"""Roofline terms of one step of the port, counted by PyTorch itself.

Ported from ``repro.launch.roofline``, whose terms are read off compiled
XLA artifacts. The port has no compiled artifact to read; it counts what
one eager call of a step does (``analyze_step``):

  compute    = FLOPs / PEAK_FLOPS_BF16
  memory     = bytes moved / HBM_BYTES_PER_S
  collective = bytes a node exchanges / NVLINK_BYTES_PER_S

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
convolutions and attention products; elementwise work is free, as in the
FLOP count of a roofline). Bytes come from ``ByteCounter``: the operand
and result bytes of every aten op the call dispatches, views excluded. It
is the eager, unfused analogue of XLA's "bytes accessed": every
intermediate is written once and read again by each op that takes it, so
it over-counts the DRAM traffic of a run whose ops are fused or whose
operands stay in L2. The step runs on ``meta`` tensors
(``models.init_params(..., abstract=True)``), so the count allocates
nothing and is the same on any host; under ``torch.func.vmap`` it counts
the batched ops, N nodes' work. Collective bytes have no HLO to parse: on
the sparse engine they are what ``core.sharded.NodeGroup.shift_exchange``
packs and sends (its ``exchange_bytes``); on the dense engine one card
holds every node and a gossip step moves none.

The card's constants are NVIDIA's published specifications of the NVIDIA
H100 80GB HBM3 (SXM5) at its 700 W power limit, dense rates without
sparsity, not measurements. ``OverlapPrediction`` / ``predict_overlap``
are the reference's max-form model of the pipelined round, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["PEAK_FLOPS_BF16", "HBM_BYTES_PER_S", "HBM_BYTES",
           "NVLINK_BYTES_PER_S", "ByteCounter", "Roofline", "analyze_step",
           "OverlapPrediction", "predict_overlap", "model_flops_train",
           "model_flops_decode"]

# NVIDIA H100 80GB HBM3 (SXM5), 700 W: NVIDIA's data sheet.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12       # bytes/s of HBM3
HBM_BYTES = 80e9                # bytes of HBM3
NVLINK_BYTES_PER_S = 450e9      # bytes/s a direction (NVLink 4, 900 GB/s both)

# ops that allocate without reading or writing data
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "empty_like"))


class ByteCounter(TorchDispatchMode):
    """Counts, for every aten op dispatched inside it, the bytes of its
    tensor operands and results (``total``) and the ops (``ops``). Views
    (``func.is_view``) and allocations move no data and count nothing."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
            self.ops += 1
        return out


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BYTES_PER_S
    link_bw: float = NVLINK_BYTES_PER_S

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def analyze_step(fn: Callable, *args, chips: int = 1,
                 collective_bytes: float = 0.0) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and ``ByteCounter``
    and return its counts: ``flops``, ``bytes`` (the eager operand and
    result bytes, module docstring), ``ops`` (aten ops counted),
    ``flops_by_op`` (FLOPs by aten op) and ``roofline``
    (``Roofline.as_dict`` with ``collective_bytes``, which the caller
    measures: a step's own counters see no exchange). Give ``meta``
    tensors to count without allocating."""
    flops = FlopCounterMode(display=False)
    moved = ByteCounter()
    with flops, moved:
        fn(*args)
    total = float(flops.get_total_flops())
    roof = Roofline(flops=total, hbm_bytes=float(moved.total),
                    collective_bytes=float(collective_bytes), chips=chips)
    by_op = {str(op): int(n) for op, n in
             flops.get_flop_counts().get("Global", {}).items()}
    return {"flops": total, "bytes": float(moved.total), "ops": moved.ops,
            "flops_by_op": by_op, "roofline": roof.as_dict()}


def _as_roofline(obj) -> Roofline:
    """Coerce an ``analyze_step`` result dict (or a Roofline) to a
    Roofline so the overlap predictor takes either."""
    if isinstance(obj, Roofline):
        return obj
    if isinstance(obj, dict):
        d = obj.get("roofline", obj)
        return Roofline(
            flops=float(d.get("flops", 0.0)),
            hbm_bytes=float(d.get("hbm_bytes", 0.0)),
            collective_bytes=float(d.get("collective_bytes", 0.0)),
            chips=int(d.get("chips", 1)))
    raise TypeError(f"expected Roofline or analyze_step dict, got "
                    f"{type(obj).__name__}")


@dataclasses.dataclass
class OverlapPrediction:
    """Predicted round times of a (tau1, tau2) round under both executor
    overlap modes, from roofline terms alone.

    additive_s  = tau1*t_local + tau2*t_gossip          (overlap="none")
    pipelined_s = tau1*t_local + max(0, tau2*t_gossip - tau1*t_local)
                                                        (overlap="pipeline")

    This is the same max-form model ``planner.cost.CostModel`` prices with,
    evaluated here from measured per-step exchange bytes
    (``NodeGroup.exchange_bytes``) and the device's roofline terms, so the
    win is predicted before a single round runs.
    """

    t_local_step_s: float
    t_gossip_step_s: float
    tau1: int
    tau2: int

    @property
    def additive_s(self) -> float:
        return self.tau1 * self.t_local_step_s + self.tau2 * self.t_gossip_step_s

    @property
    def pipelined_s(self) -> float:
        window = self.tau1 * self.t_local_step_s
        return window + max(0.0, self.tau2 * self.t_gossip_step_s - window)

    @property
    def hidden_s(self) -> float:
        return self.additive_s - self.pipelined_s

    @property
    def speedup(self) -> float:
        return (self.additive_s / self.pipelined_s
                if self.pipelined_s > 0.0 else 1.0)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "t_local_step_s": self.t_local_step_s,
            "t_gossip_step_s": self.t_gossip_step_s,
            "tau1": self.tau1,
            "tau2": self.tau2,
            "additive_s": self.additive_s,
            "pipelined_s": self.pipelined_s,
            "hidden_s": self.hidden_s,
            "speedup": self.speedup,
        }


def predict_overlap(local_step, gossip_step, tau1: int, tau2: int,
                    *, t_local_step_s: Optional[float] = None,
                    ) -> OverlapPrediction:
    """Predict the overlap="pipeline" win for a (tau1, tau2) round.

    local_step / gossip_step: ``Roofline``s (or ``analyze_step`` dicts) of
    ONE local-update step and ONE gossip step. The local step is priced at
    its roofline bound max(compute_s, memory_s); the gossip step at its
    wire time collective_s (its exchanged bytes over the link bandwidth).
    ``t_local_step_s`` overrides the modeled local-step time with a
    measured one (the bench calibrates it from wall-clock tau2=0 runs)
    while keeping the gossip side byte-measured.
    """
    rl = _as_roofline(local_step)
    rg = _as_roofline(gossip_step)
    tl = (t_local_step_s if t_local_step_s is not None
          else max(rl.compute_s, rl.memory_s))
    return OverlapPrediction(t_local_step_s=float(tl),
                             t_gossip_step_s=float(rg.collective_s),
                             tau1=int(tau1), tau2=int(tau2))


def model_flops_train(active_params: int, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D for one optimizer step."""
    return 6.0 * active_params * tokens


def model_flops_decode(active_params: int, batch: int) -> float:
    """2 * N_active per generated token (fwd only)."""
    return 2.0 * active_params * batch
