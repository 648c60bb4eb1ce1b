"""The port's paper-figure benches (``repro_torch.benchmarks``) against the
reference's (``benchmarks/``).

Their spec tables are the reference's; ``run_dfl_cnn`` on a
``fully_connected(10)`` spec (Table I's sync-SGD, which runs K1 with 9
shifts on the card), on a ``label_shard`` spec (Fig. 8's tau1 = 2), on
Fig. 9's quasi-ring spec (not circulant: ``mix_dense``) and on Fig. 10's
randomized-gossip C-DFL variant (the reference's draws replayed through
the port's seam) holds the reference harness's history (loss, global
loss, consensus, test accuracy, wire bits) to rtol 1e-4, from the
reference's initial weights on a small dataset; every bench runs on the
CPU at 1 round and writes its JSON where asked.
"""
import json

import jax
import numpy as np
import pytest

import benchmarks.common as jcommon
from benchmarks import (fig7_tau2, fig8_tau1, fig9_zeta, fig10_cdfl,
                        table1_methods)
from repro.models import cnn as jcnn
from repro_torch.benchmarks import common
from repro_torch.benchmarks import fig7_tau2 as tfig7
from repro_torch.benchmarks import fig8_tau1 as tfig8
from repro_torch.benchmarks import fig9_zeta as tfig9
from repro_torch.benchmarks import fig10_cdfl as tfig10
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import table1_methods as ttable1
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import make_compressor
from repro_torch.core.rng import ReplayDraws
from repro_torch.data.images import SyntheticImages
from repro_torch.launch import cnn_run


def small_data(flavor):
    return SyntheticImages(flavor=flavor, train_size=200, test_size=40,
                           seed=7)


def test_spec_tables_equal_reference():
    assert tfig7.TAU2S == fig7_tau2.TAU2S
    assert tfig8.TAU1S == fig8_tau1.TAU1S
    assert tfig9.TOPOLOGIES == fig9_zeta.TOPOLOGIES
    assert tfig10.VARIANTS == fig10_cdfl.VARIANTS
    assert ttable1.METHODS == table1_methods.METHODS
    hist = {"gbits": [0.1, 0.2, 0.3], "global_loss": [3.0, 2.0, 1.0]}
    for budget in (0.05, 0.2, 0.25, 9.0):
        assert tfig10.loss_at_gbits(hist, budget) == \
            fig10_cdfl.loss_at_gbits(hist, budget)
    for field in jcommon.RunSpec.__dataclass_fields__:
        assert getattr(common.RunSpec("x"), field) == \
            getattr(jcommon.RunSpec("x"), field)


SPECS = {
    "full10": dict(tau1=1, tau2=1, topology="full", rounds=3),
    "label_shard": dict(tau1=2, tau2=4, topology="ring", rounds=2,
                        partition="label_shard"),
    # Fig. 9's quasi-ring run (fig9_zeta.run) and Fig. 10's p = 0.8
    # randomized-gossip run (fig10_cdfl.run), cut to 2 rounds
    "fig9_quasi": dict(tau1=2, tau2=1, topology="quasi", rounds=2,
                       partition="label_shard"),
    "fig10_rand_gossip": dict(tau1=4, tau2=4, topology="ring",
                              compression="rand_gossip",
                              comp_kwargs={"p": 0.8}, gamma=0.6, rounds=2),
}


@pytest.mark.parametrize("label", sorted(SPECS))
def test_run_dfl_cnn_history_matches_reference_harness(monkeypatch, label):
    monkeypatch.setattr(jcommon, "get_data", small_data)
    monkeypatch.setattr(cnn_run, "get_data", small_data)
    kw = dict(SPECS[label], flavor="mnist", batch=8)
    want = jcommon.run_dfl_cnn(jcommon.RunSpec(name=label, **kw), log_every=1)
    p0 = params_from_jax({k: np.asarray(v) for k, v in jcnn.init_cnn(
        jax.random.key(0), "mnist").items()}, "cpu")
    monkeypatch.setattr(cnn_run, "init_cnn", lambda *a, **kw: p0)
    spec = common.RunSpec(name=label, **kw)
    draws = None
    if spec.compression:  # the harness seeds the reference's rng seed + 1
        from test_torch_round import _reference_draws
        draws = ReplayDraws(_reference_draws(
            make_compressor(spec.compression, **spec.comp_kwargs),
            jax.random.key(spec.seed + 1),
            {k: tuple(v.shape) for k, v in p0.items()}, rounds=spec.rounds,
            tau2=spec.tau2, n=spec.nodes), device="cpu")
    got = common.run_dfl_cnn(spec, device="cpu", log_every=1, draws=draws)
    assert got["bits_per_round"] == want["bits_per_round"]
    assert got["zeta"] == pytest.approx(want["zeta"], abs=1e-12)
    h, jh = got["history"], want["history"]
    for key in ("round", "iteration", "gbits"):
        assert h[key] == jh[key]
    for key in ("loss", "global_loss", "consensus", "test_acc"):
        np.testing.assert_allclose(h[key], jh[key], rtol=1e-4, atol=1e-7)


FIGURES = {
    "fig7": lambda **kw: tfig7.run(rounds=1, **kw),
    "fig8": lambda **kw: tfig8.run(rounds=1, **kw),
    "fig9": lambda **kw: tfig9.run(rounds=1, **kw),
    "fig10": lambda **kw: tfig10.run(rounds=1, **kw),
    "table1": lambda **kw: ttable1.run(budget_iters=8, **kw),
}
FILES = {"fig7": "fig7_mnist_ring", "fig8": "fig8_mnist",
         "fig9": "fig9_mnist", "fig10": "fig10_mnist",
         "table1": "table1_mnist"}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_runs_on_cpu(monkeypatch, tmp_path, capsys, name):
    monkeypatch.setattr(cnn_run, "get_data", small_data)
    rows = FIGURES[name](device="cpu", results_dir=str(tmp_path))
    assert rows and all(r["bench"] == name for r in rows)
    for r in rows:
        for key, v in r.items():
            if isinstance(v, float):
                assert np.isfinite(v), (key, v)
    with open(tmp_path / f"{FILES[name]}.json") as f:
        payload = json.load(f)
    assert len(payload) == len(rows)
    assert capsys.readouterr().out.startswith("bench,")


def test_run_entry_point_rejects_unknown_benches():
    # the reference's roofline report reads TPU dry-run artifacts: not ported
    with pytest.raises(SystemExit):
        trun.main(["--only", "roofline", "--device", "cpu"])


def test_bench_round_overhead_runs_on_cpu(monkeypatch, tmp_path):
    """The executor bench end to end at a tiny size: every strategy runs
    the re-planned schedule, the executor builds nothing after warmup, and
    the sync count is left unmeasured off the card."""
    from repro_torch.benchmarks import bench_round_overhead as bro

    monkeypatch.setattr(bro, "get_data", small_data)
    out = bro.main(["--flavor", "mnist", "--rounds", "4", "--superstep", "2",
                    "--compression", "top_k", "--device", "cpu",
                    "--repeats", "2",
                    "--out", str(tmp_path / "bro")])
    assert out["config"]["schedule"] == [(4, 4), (2, 1)]
    assert len(out["repeats"]) == 2
    for rep in out["repeats"]:
        assert rep["legacy"]["builds"] == 2
        assert rep["executor_round"]["dispatches"] == 4
        assert rep["executor_superstep"]["dispatches"] == 2
        for mode in ("executor_round", "executor_superstep"):
            assert rep[mode]["builds_after_warmup"] == 0
    assert list(out["repeats"][1]) == ["executor_superstep", "executor_round",
                                       "legacy", "superstep_vs_round"]
    assert set(out["median_ms_per_round"]) == {
        "legacy", "executor_round", "executor_superstep"}
    assert out["syncs_in_dispatch"] is None
    assert (tmp_path / "bro.json").is_file()
    assert bro.replan_schedule(12, 3) == [(4, 4)] * 6 + [(2, 1)] * 6


def test_bench_round_overhead_dispatch_measurement_on_cpu(tmp_path):
    """The reference's dispatch measurement, ported: the 8-node quadratic
    ring, (2, 2) then (4, 1) at the superstep boundary, no build after the
    warmup; rounds/s of the three strategies and their ratio. ``--check``
    holds the 2x bar; the CNN measurement refuses it."""
    from repro_torch.benchmarks import bench_round_overhead as bro

    out = bro.main(["--measure", "dispatch", "--device", "cpu",
                    "--out", str(tmp_path / "d")])
    assert out["config"]["schedule"] == [[2, 2], [4, 1]]
    (rep,) = out["repeats"]
    assert rep["legacy"]["builds"] == 2
    assert rep["executor_round"]["dispatches"] == 20
    assert rep["executor_superstep"]["dispatches"] == 2
    assert all(v > 0 for v in out["median_rounds_per_s"].values())
    assert out["speedup_superstep_vs_legacy"] == pytest.approx(
        out["median_rounds_per_s"]["executor_superstep"]
        / out["median_rounds_per_s"]["legacy"])
    assert (tmp_path / "d.json").is_file()
    s = bro.quad_setup(4, device="cpu")
    assert s.batches[0][0].shape == (4, 8, 64)
    with pytest.raises(SystemExit):
        bro.main(["--check", "--device", "cpu"])
