"""The port's roofline counts (``repro_torch.launch.roofline``) and the
sparse engine's exchange counter (``core.sharded.pack_layout``,
``NodeGroup.exchange_bytes``), on the CPU.

Tolerances: none. FLOPs and bytes are integer counts from shapes, held
exactly: ``analyze_step``'s FLOPs on the reduced Qwen3 (batch 2, seq 64)
against an analytic count of its matmuls and attention products written
here from the config; one ``linear``; ``vmap`` over 4 nodes (4x one
node) and ``meta`` against CPU tensors (batch 1, seq 32); the byte counter on one matmul
(|x| + |W| + |y|). ``Roofline``'s terms are float arithmetic on the
card's published constants, held bitwise to the same expressions. The
packed exchange differs from ``mixing.mixing_bytes_per_step`` only by each
leaf's padding to 16 bytes, asserted leaf by leaf; the counter itself is
read on 4 gloo ranks (one spawn under its own time limit), where
``launch.steps.roofline_cost_inputs`` on a ``NodeGroup`` measures a gossip
step's bytes, exactly the ring's two shifts of the packed tree, and
``plan_train_schedule(use_roofline=True)`` prices the wire from them: the
plan equals ``planner.plan`` fed that cost model, bitwise. ``bench_overlap``
reads the same counter on 8 ranks (``tests/test_torch_benches.py``).
"""
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch.configs import get_arch
from repro_torch.core import mixing, topology
from repro_torch.core.sharded import pack_layout, spawn
from repro_torch.launch import roofline as R
from repro_torch.models import init_params, train_loss
from repro_torch.models.common import pad_vocab

B, S = 2, 64


def _cfg():
    return get_arch("qwen3-1.7b").reduced


def _inputs(cfg, device, nodes=None, b=B, s=S):
    """One node's (or ``nodes`` stacked) parameters and a batch of ``b`` x
    ``s`` tokens: shapes only on ``meta``, seeded values on the CPU."""
    if device == "meta":
        params, _ = init_params(cfg, None, "cpu", abstract=True)
        batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
    else:
        params, _ = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                                  dtype=np.int32))
                 for k in ("tokens", "labels")}
    if nodes is not None:
        params = {k: v.unsqueeze(0).repeat((nodes,) + (1,) * v.dim())
                  for k, v in params.items()}
        batch = {k: v.unsqueeze(0).repeat(nodes, 1, 1)
                 for k, v in batch.items()}
    return params, batch


def analytic_train_flops(cfg, b, s):
    """FLOPs of one grad(train_loss) of a dense decoder: per layer the q, k,
    v, o projections, the three MLP matmuls and the two attention products
    over every chunk pair (the chunked attention computes the masked pairs
    too), plus the tied logits over the padded vocab; backward is twice the
    forward (an input and a weight gradient a matmul)."""
    t = b * s
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    layer = (2 * t * d * (h + 2 * kv) * hd      # q, k, v
             + 2 * t * h * hd * d               # o
             + 3 * 2 * t * d * f                # gate, up, down
             + 2 * 2 * b * h * s * s * hd)      # q k^T and p v
    logits = 2 * t * d * pad_vocab(cfg.vocab_size)
    return 3 * (cfg.num_layers * layer + logits)


def test_linear_flops_and_bytes_are_exact():
    x, w = torch.randn(8, 16), torch.randn(32, 16)
    got = R.analyze_step(torch.nn.functional.linear, x, w)
    assert got["flops"] == 2 * 8 * 16 * 32
    y_bytes = 8 * 32 * 4
    assert got["bytes"] == x.nbytes + w.nbytes + y_bytes
    assert got["ops"] == 1                      # the transpose is a view
    meta = R.analyze_step(torch.nn.functional.linear,
                          x.to("meta"), w.to("meta"))
    assert (meta["flops"], meta["bytes"]) == (got["flops"], got["bytes"])


def test_matmul_bytes_are_operands_and_result():
    a, b = torch.randn(5, 7, dtype=torch.bfloat16), torch.randn(7, 3)
    got = R.analyze_step(torch.matmul, a.float(), b)
    assert got["bytes"] == 5 * 7 * 4 + 7 * 3 * 4 + 5 * 3 * 4
    assert got["flops"] == 2 * 5 * 7 * 3


def test_reduced_qwen3_flops_equal_the_analytic_count():
    cfg = _cfg()
    params, batch = _inputs(cfg, "meta")
    got = R.analyze_step(grad(lambda p, b: train_loss(p, b, cfg)),
                         params, batch)
    want = analytic_train_flops(cfg, B, S)
    assert got["flops"] == want == 880_803_840
    # 1.028x the 6 P T rule of thumb: attention and the padded vocab
    assert got["flops"] / R.model_flops_train(cfg.param_count(), B * S) \
        == pytest.approx(1.0281, abs=1e-4)


def test_meta_counts_equal_cpu_counts_and_vmap_is_4x():
    cfg = _cfg()
    fn = grad_and_value(lambda p, b: train_loss(p, b, cfg))
    one = {dev: R.analyze_step(fn, *_inputs(cfg, dev, b=1, s=32))
           for dev in ("meta", "cpu")}
    assert one["meta"]["flops"] == one["cpu"]["flops"]
    assert one["meta"]["bytes"] == one["cpu"]["bytes"]
    four = {dev: R.analyze_step(vmap(fn), *_inputs(cfg, dev, 4, 1, 32))
            for dev in ("meta", "cpu")}
    assert four["meta"]["flops"] == four["cpu"]["flops"]
    assert four["meta"]["bytes"] == four["cpu"]["bytes"]
    assert four["meta"]["flops"] == 4 * one["meta"]["flops"]


def test_roofline_terms_and_constants():
    assert (R.PEAK_FLOPS_BF16, R.HBM_BYTES_PER_S, R.HBM_BYTES,
            R.NVLINK_BYTES_PER_S) == (989e12, 3.35e12, 80e9, 450e9)
    r = R.Roofline(flops=2e12, hbm_bytes=1e9, collective_bytes=9e8, chips=1)
    assert r.compute_s == 2e12 / 989e12
    assert r.memory_s == 1e9 / 3.35e12
    assert r.collective_s == 9e8 / 450e9
    assert r.dominant == "compute"
    assert R.Roofline(0.0, 1e12, 0.0, 1).dominant == "memory"
    d = r.as_dict()
    assert d["dominant"] == "compute" and d["chips"] == 1
    assert R._as_roofline({"roofline": d}).as_dict() == d
    assert R._as_roofline(r) is r
    with pytest.raises(TypeError, match="Roofline"):
        R._as_roofline(3.0)
    assert R.model_flops_decode(10, 4) == 80.0


@pytest.mark.parametrize("topo", ["ring8", "full8"])
def test_packed_exchange_differs_from_mixing_bytes_by_padding(topo):
    cfg = _cfg()
    leaves = list(init_params(cfg, None, "cpu", abstract=True)[0].values())
    leaves.append(torch.empty(5, dtype=torch.bfloat16, device="meta"))
    t = topology.ring(8) if topo == "ring8" else topology.fully_connected(8)
    offsets, total = pack_layout(leaves)
    ends = offsets[1:] + [total]
    raw = [x.numel() * x.element_size() for x in leaves]
    for at, end, nb in zip(offsets, ends, raw):
        assert at % 16 == 0
        assert end - at - nb == (-nb) % 16     # the leaf's padding only
    shifts = len(t.shifts())
    pad = sum((-nb) % 16 for nb in raw)
    assert shifts * total == (mixing.mixing_bytes_per_step(t, sum(raw), True)
                              + shifts * pad)


def _group_rank(group, out_dir):
    """One rank of the group case: the measured inputs and plan of the
    reduced Qwen3 with this rank's node, written for the test."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch import steps

    arch = REGISTRY["qwen3-1.7b"]
    kw = dict(reduced=True, batch=1, seq=8)
    got = steps.roofline_cost_inputs(arch, "train_4k", group, **kw)
    p = steps.plan_train_schedule(arch, "train_4k", group, budget_s=60.0,
                                  use_roofline=True, **kw)
    torch.save({"inputs": got, "plan": (p.tau1, p.tau2, p.rounds, p.eta,
                                        p.predicted_bound),
                "exchange_bytes": group.exchange_bytes},
               f"{out_dir}/rank{group.rank}.pt")


def test_group_inputs_read_the_exchange_counter(tmp_path):
    from repro_torch.launch import steps
    from repro_torch.planner import (Budget, ComputeModel, CostModel,
                                     LinkModel, plan)

    spawn(_group_rank, 4, (str(tmp_path),), device="cpu", timeout_s=150.0)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    cfg = _cfg()
    packed = pack_layout(list(init_params(cfg, None, "cpu",
                                          abstract=True)[0].values()))[1]
    one = init_params(cfg, None, "cpu", abstract=True)[0]
    dense = steps.roofline_cost_inputs(get_arch("qwen3-1.7b"), "train_4k", 4,
                                       reduced=True, batch=1, seq=8)
    for r in ranks:
        got = r["inputs"]
        assert got["nodes"] == 4
        assert got["gossip_collective_bytes"] == 2 * packed   # two shifts
        assert got["step_flops"] == dense["step_flops"]
        assert got["step_hbm_bytes"] < dense["step_hbm_bytes"]
        # two gossip steps ran: the inputs' and the measured plan's
        assert r["exchange_bytes"] == 2 * 2 * packed
    cm = CostModel(
        compute=ComputeModel(step_flops=dense["step_flops"],
                             flops_per_s=R.PEAK_FLOPS_BF16),
        link=LinkModel(bytes_per_s=R.NVLINK_BYTES_PER_S),
        topology=topology.ring(4), model_bits=8.0 * 2 * packed / 2,
        engine="auto")
    p = plan(Budget(wall_clock_s=60.0), cm, sigma=1.0, f_gap=1.0)
    assert all(r["plan"] == (p.tau1, p.tau2, p.rounds, p.eta,
                             p.predicted_bound) for r in ranks)
    raw = 8 * sum(x.numel() * x.element_size() for x in one.values())
    assert cm.model_bits >= raw and cm.model_bits - raw < 8 * 16 * len(one)
