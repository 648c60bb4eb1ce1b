"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``), for ``sm_90a``. The first use of any
kernel builds every source, one ``nvcc`` per file, all started together:
a few seconds, against minutes for an extension that includes PyTorch's
headers. The hash covers the sources and the flags, so an edit rebuilds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0, so a refused launch is never silent.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gossip_mix", "topk", "choco_fused", "qsgd", "choco_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; the "
                       "CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; returns
    ``{name: library path}``. Raises with nvcc's output on a failed build."""
    paths = {name: _library_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_all()[name]))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernel(source: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built and
    loaded at first use, with its argument types set (``c_void_p`` for
    every pointer and the stream, so none is cut to 32 bits)."""
    fn = getattr(_library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def rows_aligned(t) -> bool:
    """True when every row of the 2-D tensor ``t`` starts 16-byte aligned,
    so a kernel may read and write it 16 bytes at a time."""
    return t.data_ptr() % 16 == 0 and t.shape[1] * t.element_size() % 16 == 0


BLOCKS_PER_SM = 4   # blocks a streaming kernel's chunk aims for on each SM


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once and
    cached: the wrappers also run while a CUDA graph is captured."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def fill_chunk(spans: Sequence, ceiling: int, floor: int, sms: int) -> int:
    """Elements a block of a streaming kernel over ``spans`` (``(rows,
    length)`` pairs, each row cut into chunks): ``ceiling`` halved while
    the chunks number fewer than ``BLOCKS_PER_SM`` an SM, down to
    ``floor``. ``ceiling`` is ``floor`` times a power of 2, so the chunk
    stays a multiple of ``floor``."""
    if floor < 1 or ceiling % floor or (ceiling // floor) & (ceiling // floor - 1):
        raise ValueError(f"chunk ceiling {ceiling} is not {floor} times a "
                         "power of 2")
    chunk = ceiling
    while chunk > floor and sum(rows * -(-length // chunk) for rows, length
                                in spans) < BLOCKS_PER_SM * sms:
        chunk //= 2
    return chunk


def check(source: str, symbol: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = _library(source).error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")
