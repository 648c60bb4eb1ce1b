"""The port's launch builders (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), on the CPU.

Tolerances, each with its reason:
  * The analytic ``plan_train_schedule`` at ``nodes=1`` against the
    reference's on ``make_host_mesh(1, 1)`` (both given the same peak and
    link rates; the reference's defaults are another chip's): tau1, tau2,
    the round count and the compressor equal, ``eta`` and
    ``predicted_bound`` to rtol 1e-12 (the planner is numpy in both, the
    parameter counts integers). At ``nodes=4`` the plan equals
    ``repro.planner.plan`` fed the same ``CostModel``, as exactly.
  * The measured plan (``use_roofline=True``) equals the planner fed the
    counted FLOPs: its FLOPs are integer counts on ``meta`` tensors (held
    to an analytic count in ``tests/test_torch_roofline.py``), and the
    dense engine's gossip bytes are 0.0, as the reference's on one device.
  * ``build_planned_round``'s ``meta["plan"]`` has the reference's keys
    (read from the reference's source: its own builder fails to lower
    under the jax this suite runs); the round runs on the executor with no
    build or capture after its warmup.
  * The local step and the gossip step run the round's arithmetic: the
    local step's loss is ``train_loss`` at the initial weights exactly,
    the plain gossip step is bitwise the dense substrate's ``mix``.
"""
import ast
import inspect
import math

import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.core import compression as jcompression
from repro.core import topology as jtopology
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.planner import Budget as JBudget
from repro.planner import ComputeModel as JComputeModel
from repro.planner import CostModel as JCostModel
from repro.planner import LinkModel as JLinkModel
from repro.planner import plan as jplan
from repro_torch.configs import REGISTRY
from repro_torch.core import compression, topology
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.models import train_loss

RATES = dict(flops_per_s=R.PEAK_FLOPS_BF16,
             link_bytes_per_s=R.NVLINK_BYTES_PER_S)


def _same_plan(p, q):
    assert (p.tau1, p.tau2, p.rounds, p.compressor_name) == (
        q.tau1, q.tau2, q.rounds, q.compressor_name)
    assert p.eta == pytest.approx(q.eta, rel=1e-12, abs=0.0)
    assert p.predicted_bound == pytest.approx(q.predicted_bound, rel=1e-12,
                                              abs=0.0)
    assert p.round_cost.time_s == pytest.approx(q.round_cost.time_s,
                                                rel=1e-12, abs=0.0)
    assert p.round_cost.wire_bits == q.round_cost.wire_bits


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh(1, 1)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("budget", [3600.0, 60.0])
@pytest.mark.parametrize("comp", [None, "top_k"])
def test_analytic_plan_equals_reference_on_one_node(host_mesh, arch, budget,
                                                    comp):
    kw = dict(budget_s=budget, reduced=True, **RATES)
    mine = S.plan_train_schedule(
        REGISTRY[arch], "train_4k", 1,
        compression=compression.make_compressor(comp, frac=0.25)
        if comp else None, **kw)
    want = JS.plan_train_schedule(
        JREGISTRY[arch], "train_4k", host_mesh,
        compression=jcompression.make_compressor(comp, frac=0.25)
        if comp else None, **kw)
    _same_plan(mine, want)


def test_default_rates_are_the_cards():
    arch = REGISTRY["qwen3-1.7b"]
    assert S.plan_train_schedule(arch, "train_4k", 1, budget_s=3600.0,
                                 reduced=True) == S.plan_train_schedule(
        arch, "train_4k", 1, budget_s=3600.0, reduced=True, **RATES)


def _reference_plan(cfg_params, tokens_per_node, n, budget, step_flops=None):
    """``repro.planner.plan`` fed the analytic (or a given) CostModel."""
    cm = JCostModel(
        compute=JComputeModel(
            step_flops=(6.0 * cfg_params * tokens_per_node
                        if step_flops is None else step_flops),
            flops_per_s=R.PEAK_FLOPS_BF16),
        link=JLinkModel(bytes_per_s=R.NVLINK_BYTES_PER_S),
        topology=jtopology.ring(n), model_bits=32.0 * cfg_params,
        engine="auto")
    return jplan(JBudget(wall_clock_s=budget), cm, sigma=1.0, f_gap=1.0)


@pytest.mark.parametrize("budget", [3600.0, 60.0])
def test_four_node_plan_equals_planner_fed_the_same_cost_model(budget):
    arch = REGISTRY["qwen3-1.7b"]
    mine = S.plan_train_schedule(arch, "train_4k", 4, budget_s=budget,
                                 reduced=True)
    p = arch.reduced.param_count()
    assert p == JREGISTRY["qwen3-1.7b"].reduced.param_count() == 1_115_520
    _same_plan(mine, _reference_plan(p, 256 * 4096 / 4, 4, budget))
    # a node's batch and length given: the phase-11 tree's override
    mine = S.plan_train_schedule(arch, "train_4k", 4, budget_s=budget,
                                 reduced=True, batch=2, seq=64)
    _same_plan(mine, _reference_plan(p, 2 * 64, 4, budget))


def test_roofline_cost_inputs_and_measured_plan():
    arch = REGISTRY["qwen3-1.7b"]
    got = S.roofline_cost_inputs(arch, "train_4k", 4, reduced=True, batch=2,
                                 seq=64)
    assert set(got) == {"step_flops", "step_hbm_bytes",
                        "gossip_collective_bytes", "nodes"}
    assert got["nodes"] == 4
    assert got["step_flops"] == 880_803_840       # one node's, of four
    assert got["gossip_collective_bytes"] == 0.0  # one device holds all
    one = S.roofline_cost_inputs(arch, "train_4k", 1, reduced=True,
                                 batch=2, seq=64)
    assert one["step_flops"] == got["step_flops"]
    assert 0 < one["step_hbm_bytes"] < got["step_hbm_bytes"]
    mine = S.plan_train_schedule(arch, "train_4k", 4, budget_s=3600.0,
                                 reduced=True, batch=2, seq=64,
                                 use_roofline=True)
    _same_plan(mine, _reference_plan(arch.reduced.param_count(), 128, 4,
                                     3600.0, step_flops=got["step_flops"]))


def _reference_plan_keys():
    """The keys of the reference's ``build_planned_round`` meta["plan"]."""
    tree = ast.parse(inspect.getsource(JS.build_planned_round))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and ast.unparse(node.targets[0]) == "built.meta['plan']"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no meta['plan'] in the reference's builder")


def test_planned_round_meta_and_run():
    arch = REGISTRY["qwen3-1.7b"]
    built = S.build_planned_round(arch, "train_4k", 2, budget_s=3600.0,
                                  reduced=True, batch=1, seq=8, rounds=2,
                                  device="cpu", grid=[(1, 1), (2, 1)])
    plan = built.meta["plan"]
    assert set(plan) == _reference_plan_keys()
    assert (built.meta["tau1"], built.meta["tau2"]) == (plan["tau1"],
                                                        plan["tau2"])
    assert built.meta["nodes"] == 2 and plan["use_roofline"] is False
    assert math.isfinite(plan["predicted_bound"])
    built.warmup()
    ex = built.executor
    warm = (ex.compile_count, ex.capture_count)
    state, m = built.run()
    state, m = built.run()
    assert (ex.compile_count, ex.capture_count) == warm
    assert m["loss"].shape == (2,) and torch.isfinite(m["loss"]).all()
    assert state.round_idx == 4


def test_local_and_gossip_steps_run_the_rounds_arithmetic():
    arch = REGISTRY["qwen3-1.7b"]
    cfg = arch.reduced
    local = S.build_local_step(arch, "train_4k", 3, reduced=True, batch=1,
                               seq=8, device="cpu")
    params, _, batch = local.args
    _, _, loss = local.run()
    want = torch.stack([train_loss({k: v[i] for k, v in params.items()},
                                   {k: v[i] for k, v in batch.items()}, cfg)
                        for i in range(3)]).mean()
    assert torch.equal(loss, want)
    gossip = S.build_gossip_step(arch, 3, reduced=True, device="cpu")
    (x,) = gossip.args
    x = {k: v + torch.arange(3, dtype=v.dtype).reshape(
        (3,) + (1,) * (v.dim() - 1)) for k, v in x.items()}
    got = gossip.fn(x)
    want = DenseSubstrate(topology.ring(3)).mix(x)
    assert all(torch.equal(got[k], want[k]) for k in x)
    comp = compression.make_compressor("top_k", frac=0.5)
    choco = S.build_gossip_step(arch, 3, reduced=True, device="cpu",
                                compression=comp)
    x_new, y_new = choco.run()
    assert set(x_new) == set(y_new) == set(x)
    assert gossip.meta["kind"] == choco.meta["kind"] == "gossip"
    assert np.isfinite(float(sum(v.float().sum() for v in y_new.values())))
