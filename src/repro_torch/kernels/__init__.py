"""Kernels written by hand for Hopper (CUDA C++ for ``sm_90a``, bound with
ctypes), each beside its plain PyTorch version; the public wrappers are in
``repro_torch.kernels.ops``: one for each of the reference's seven Pallas
kernels, and K1's received-buffer form (``gossip_mix_received_many``) for
the sparse engine's ``core.substrate.ShardedSubstrate``. The submodules
keep the kernels' names (``gossip_mix``, ``topk``, ...), so the package
exports no function of the same name."""
from repro_torch.kernels.ops import (LAUNCHES, gossip_mix_received,
                                     gossip_mix_received_many,
                                     reset_launches)

__all__ = ["LAUNCHES", "reset_launches", "gossip_mix_received",
           "gossip_mix_received_many"]
