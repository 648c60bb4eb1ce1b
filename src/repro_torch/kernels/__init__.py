"""Kernels written by hand for Hopper (CUDA C++ for ``sm_90a``, bound with
ctypes), each beside its plain PyTorch version; the public wrappers are in
``repro_torch.kernels.ops``."""
