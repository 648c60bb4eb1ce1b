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
from repro_torch.core.sharded import spawn
from repro_torch.kernels import build
from repro_torch.configs import REGISTRY
from repro_torch.launch import cnn_run, serve, train
from repro_torch.models import init_decode_state, init_params
from repro_torch.models.cnn import init_cnn
from repro_torch.serving import ServingEngine

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
            "repro_torch.launch.planned_run",
            "repro_torch.models.common", "repro_torch.models.policy",
            "repro_torch.models.attention", "repro_torch.models.moe",
            "repro_torch.models.mamba", "repro_torch.models.transformer",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen3_1_7b",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.data.lm", "repro_torch.checkpoint",
            "repro_torch.checkpoint.io", "repro_torch.launch.steps",
            "repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.train", "repro_torch.serving",
            "repro_torch.serving.engine", "repro_torch.launch.serve",
            "repro_torch.examples.serve_decode", "repro_torch.obs",
            "repro_torch.obs.events", "repro_torch.obs.telemetry",
            "repro_torch.obs.history", "repro_torch.obs.report",
            "repro_torch.obs.trace", "repro_torch.obs.__main__",
            "repro_torch.kernels.registry", "repro_torch.kernels.ref",
            "repro_torch.benchmarks.bench_kernels",
            "repro_torch.benchmarks.timing", "repro_torch.analysis",
            "repro_torch.analysis.lint", "repro_torch.analysis.rules",
            "repro_torch.analysis.audits",
            "repro_torch.analysis.__main__"} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                                  "ml_dtypes")]
    assert bad == []


def test_obs_is_stdlib_only():
    """The telemetry package and its CLI import neither torch nor numpy
    (the reference's ``repro.obs`` is stdlib only too), so a stream can be
    read wherever it is copied."""
    env = dict(os.environ, PYTHONPATH=SRC)
    probe = ("import json, sys, repro_torch.obs, repro_torch.obs.__main__; "
             "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {"torch", "numpy", "jax", "repro"} & {m.split(".")[0]
                                                     for m in mods}


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(REGISTRY["qwen3-1.7b"].reduced,
                    torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-1.7b", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-1.7b", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(REGISTRY["qwen3-1.7b"].reduced, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_state(REGISTRY["qwen3-1.7b"].reduced, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(print, 2)
    from repro_torch.benchmarks import bench_overlap
    from repro_torch.examples import train_lm
    from repro_torch.launch import steps

    qwen3 = REGISTRY["qwen3-1.7b"]
    for build in (steps.build_local_step, steps.build_train_round):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(qwen3, "train_4k", 2, reduced=True, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_gossip_step(qwen3, 2, reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_planned_round(qwen3, "train_4k", 2, budget_s=60.0,
                                  reduced=True, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_overlap.main(["--smoke"])
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
