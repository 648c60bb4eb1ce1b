"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.convert import params_from_jax
from repro_torch.core.rng import GeneratorDraws, ReplayDraws
from repro_torch.kernels import build
from repro_torch.launch import cnn_run
from repro_torch.models.cnn import init_cnn

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_PROBE = """
import json, pkgutil, importlib, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
print(json.dumps(sorted(sys.modules)))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.cnn_run" in mods
    assert "repro_torch.kernels.ops" in mods
    assert {"repro_torch.core.rng", "repro_torch.kernels.qsgd",
            "repro_torch.kernels.choco_update"} <= set(mods)
    assert {"repro_torch.core.executor", "repro_torch.core.metrics",
            "repro_torch.optim.schedules", "repro_torch.examples.quickstart",
            "repro_torch.benchmarks.common", "repro_torch.benchmarks.run",
            "repro_torch.benchmarks.fig7_tau2",
            "repro_torch.benchmarks.fig8_tau1",
            "repro_torch.benchmarks.fig9_zeta",
            "repro_torch.benchmarks.fig10_cdfl",
            "repro_torch.benchmarks.table1_methods",
            "repro_torch.benchmarks.bench_round_overhead",
            "repro_torch.benchmarks.bench_faults",
            "repro_torch.benchmarks.bench_megascale",
            "repro_torch.faults", "repro_torch.planner",
            "repro_torch.planner.cost", "repro_torch.planner.bounds",
            "repro_torch.planner.optimize", "repro_torch.planner.adaptive",
            "repro_torch.benchmarks.theory_check",
            "repro_torch.benchmarks.bench_balance",
            "repro_torch.benchmarks.bench_trajectory",
            "repro_torch.examples.plan_schedule",
            "repro_torch.examples.compression_sweep",
            "repro_torch.launch.planned_run"} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cnn(torch.Generator().manual_seed(0), "mnist")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn_run.run_dfl_cnn(cnn_run.RunSpec(name="t", rounds=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeneratorDraws(0, 4, ["w"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplayDraws({})
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_plan():
    """Every kernel source is built on its own for sm_90a into the ignored
    build directory, under a name that changes with the source."""
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))
    assert {"qsgd", "choco_update"} <= set(build.SOURCES)
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build._library_path(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
