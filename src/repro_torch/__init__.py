"""PyTorch / CUDA port of the DFL / C-DFL system in ``repro``.

The JAX package ``repro`` is the reference; this package computes the same
round on an NVIDIA Hopper card through kernels written by hand in CUDA C++
(``repro_torch.kernels``). It imports ``torch`` and numpy only, never
``jax`` and nothing of ``repro``.

Every public entry point that creates tensors takes ``device=`` and
defaults to ``"cuda"``; without a card it raises unless the caller asks
for ``"cpu"``, where each kernel runs its plain PyTorch version.
``repro_torch.obs`` (the telemetry stream and its CLI) is stdlib only, so
importing the package imports torch only when ``resolve_device`` is first
asked for.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from repro_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
