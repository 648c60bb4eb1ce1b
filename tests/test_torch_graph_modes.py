"""The executor's last two modes on the graph machinery's CPU path, the
sink's neutrality, and ``run_dfl_cnn`` through the executor.

* ``RoundExecutor(engine="batched", population=V)``: each round gathers its
  cohort's rows into the graphs' ``[C, ...]`` buffers, replays the steps
  and writes the rows back; a dispatch is bitwise ``make_round_fn(engine=
  "batched")``'s eager rounds (the random compressors drawing by global id
  under the device key and id buffer), rows outside the cohorts untouched,
  nothing captured after the warmup whatever the cohorts.
* ``RoundExecutor(dynamic=False)``: one graph set per distinct (tau1, tau2),
  each a whole static round; a dispatch is bitwise the eager static rounds
  (``dense_power``, a topology schedule, TopK and QSGD), and a key seen
  before builds and captures nothing.
* Telemetry: a dispatch with a sink is bitwise the same dispatch without
  one, with the same builds and captures, and the stream validates under
  the reference's ``repro.obs`` too.
* ``run_dfl_cnn``: the rounds between log points are one superstep, so
  logging more often changes no logged value.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.obs import validate_stream as jvalidate_stream
from repro_torch import faults
from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                              make_round_fn, ring, stack_round_batches)
from repro_torch.core.topology import fully_connected, paper_quasi_ring
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import cnn_run
from repro_torch.obs import Telemetry, validate_stream
from repro_torch.optim import momentum_sgd, sgd
from test_torch_faults import (DIM, N, assert_state_bitwise, comp_of, fresh,
                               lin_loss, lin_round_batches)

POP, C = 20, 8
SCHEDULE = [(3, 2), (2, 1), (3, 0), (1, 2)]


def cohort_rows(taus, seed=4):
    sampler = faults.CohortSampler(population=POP, cohort=C, seed=seed)
    return sampler.cohort_trajectory(np.asarray(taus, np.int32),
                                     num_edges=ring(C).num_edges)


def population(opt, compressed):
    st = init_state({"w": torch.zeros(DIM)}, POP, opt, compressed=compressed,
                    seed=3)
    w = np.random.default_rng(0).normal(size=(POP, DIM)).astype(np.float32)
    return st._replace(params={"w": torch.from_numpy(w)})


def cohort_batches(k, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, 3, C, 4, DIM)).astype(np.float32)
    return {"x": torch.from_numpy(x),
            "y": torch.from_numpy(x.sum(-1).astype(np.float32))}


def clone(st):
    return st._replace(params=tree_map(torch.clone, st.params),
                       opt_state=tree_map(torch.clone, st.opt_state),
                       hat_params=tree_map(torch.clone, st.hat_params))


# ---------------------------------------------------------------------------
# The batched engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["dfl", "top_k", "qsgd"])
def test_batched_graph_path_bitwise_eager_rounds(label):
    c = comp_of(label)
    opt = momentum_sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(C), compression=c,
                    gamma=0.5)
    rows = cohort_rows(SCHEDULE)
    batches = cohort_batches(len(SCHEDULE))
    start = population(opt, c is not None)
    ex = RoundExecutor(cfg, lin_loss, opt, engine="batched", population=POP,
                       donate=False)
    out, m = ex.dispatch_trajectory(start, batches, rows)
    eager = make_round_fn(cfg, lin_loss, opt, dynamic_taus=True,
                          engine="batched", population=POP)
    ref = clone(start)
    for k, row in enumerate(rows):
        ref, mr = eager(ref, {key: v[k] for key, v in batches.items()},
                        int(row[0]), int(row[1]), row[2:2 + C],
                        row[2 + C:2 + 2 * C], row[2 + 2 * C:])
        for key in mr:
            assert torch.equal(m[key][k], mr[key]), (key, k)
    assert_state_bitwise(ref, out)
    # donate=False: the passed population is as it was
    assert_state_bitwise(population(opt, c is not None), start)
    touched = np.unique(rows[:, 2:2 + C])
    untouched = np.setdiff1d(np.arange(POP), touched)
    assert untouched.size
    assert torch.equal(out.params["w"][untouched],
                       start.params["w"][untouched])
    assert ex.capture_count == 7 and ex.compile_count == 1


def test_batched_no_capture_after_warmup_whatever_the_cohorts():
    opt = sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(C),
                    compression=comp_of("qsgd"), gamma=0.5)
    ex = RoundExecutor(cfg, lin_loss, opt, engine="batched", population=POP)
    st = population(opt, True)
    ex.warmup(st, cohort_batches(1))
    counts = (ex.capture_count, ex.compile_count)
    ptrs = [t.data_ptr() for t in tree_leaves((st.params, st.opt_state,
                                               st.hat_params))]
    for seed, k in ((1, 4), (2, 1), (3, 2)):
        st, m = ex.dispatch_trajectory(st, cohort_batches(k, seed),
                                       cohort_rows(SCHEDULE[:k], seed))
        assert m["loss"].shape == (k,)
    assert (ex.capture_count, ex.compile_count) == counts == (7, 1)
    assert [t.data_ptr() for t in tree_leaves(
        (st.params, st.opt_state, st.hat_params))] == ptrs
    assert torch.isfinite(st.params["w"]).all()


# ---------------------------------------------------------------------------
# The static fallback
# ---------------------------------------------------------------------------


STATIC = {
    "dense_power": dict(mixing_impl="dense_power"),
    "schedule": dict(topology_schedule=(ring(N), fully_connected(N))),
    "quasi": dict(topology=paper_quasi_ring()),
    "top_k": dict(compression=comp_of("top_k"), gamma=0.5),
    "qsgd": dict(compression=comp_of("qsgd"), gamma=0.5),
}


@pytest.mark.parametrize("label", sorted(STATIC))
def test_static_graph_path_bitwise_eager_rounds(label):
    kw = dict(STATIC[label])
    topo = kw.pop("topology", ring(N))
    n = topo.num_nodes
    cfg = DFLConfig(tau1=3, tau2=2, topology=topo, **kw)
    opt = momentum_sgd(0.05)
    compressed = cfg.is_compressed
    taus = [(3, 2), (1, 1), (3, 2), (2, 0)]
    rng = np.random.default_rng(9)
    per_round = [{"x": rng.normal(size=(3, n, 4, DIM)).astype(np.float32),
                  "y": rng.normal(size=(3, n, 4)).astype(np.float32)}
                 for _ in taus]

    def start():
        return init_state({"w": torch.zeros(DIM)}, n, opt,
                          compressed=compressed, seed=2)

    ex = RoundExecutor(cfg, lin_loss, opt, dynamic=False)
    out, m = ex.dispatch_trajectory(start(), stack_round_batches(
        per_round, 3, "cpu"), np.array(taus, np.int32))
    ref = start()
    for k, (t1, t2) in enumerate(taus):
        fn = make_round_fn(dataclasses.replace(cfg, tau1=t1, tau2=t2),
                           lin_loss, opt)
        ref, mr = fn(ref, {key: torch.from_numpy(v[:t1])
                           for key, v in per_round[k].items()})
        for key in mr:
            assert torch.equal(m[key][k], mr[key]), (key, k)
    assert_state_bitwise(ref, out)
    assert (ex.compile_count, ex.capture_count) == (3, 3)
    ex.dispatch(out, stack_round_batches(per_round[:2], 3, "cpu"), 1, 1)
    assert (ex.compile_count, ex.capture_count) == (3, 3)
    ex.warmup(start(), stack_round_batches(per_round[:1], 3, "cpu"), 2, 2)
    assert (ex.compile_count, ex.capture_count) == (4, 4)


# ---------------------------------------------------------------------------
# Telemetry neutrality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "pipeline", "batched", "static"])
def test_dispatch_with_a_sink_bitwise_without(mode):
    opt = sgd(0.05)
    c = comp_of("qsgd")
    kw, n = {}, N
    if mode == "pipeline":
        kw = dict(overlap="pipeline")
    elif mode == "batched":
        kw, n = dict(engine="batched", population=POP), C
    elif mode == "static":
        kw = dict(dynamic=False)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(n), compression=c,
                    gamma=0.5)
    if mode == "batched":
        rows, batches = cohort_rows(SCHEDULE), cohort_batches(len(SCHEDULE))
    else:
        rows = np.array(SCHEDULE if mode != "static" else [(3, 2)] * 4,
                        np.int32)
        batches = stack_round_batches(lin_round_batches([3] * 4), 3, "cpu")

    def start():
        return population(opt, True) if mode == "batched" else fresh(opt,
                                                                     True)

    tel = Telemetry(meta={"mode": mode})
    runs = {}
    for sink in (None, tel):
        ex = RoundExecutor(cfg, lin_loss, opt, telemetry=sink, **kw)
        ex.warmup(start(), batches, 3, 2)
        warm = (ex.compile_count, ex.capture_count)
        out, m = ex.dispatch_trajectory(start(), batches, rows)
        assert (ex.compile_count, ex.capture_count) == warm
        runs[sink is None] = (out, m)
    assert_state_bitwise(runs[True][0], runs[False][0])
    for key in runs[True][1]:
        assert torch.equal(runs[True][1][key], runs[False][1][key])
    events = tel.events
    assert validate_stream(events) == [] == jvalidate_stream(events)
    types = [e["type"] for e in events]
    assert types.count("superstep") == 2 and "span" in types
    compiles = [e for e in events if e["type"] == "compile"]
    assert compiles and all("captures" in e["data"] for e in compiles)
    assert types.count("overlap") == (1 if mode == "pipeline" else 0)
    warmups = [e["data"]["warmup"] for e in events
               if e["type"] == "superstep"]
    assert warmups == [True, False]


# ---------------------------------------------------------------------------
# run_dfl_cnn through the executor
# ---------------------------------------------------------------------------


def small_data(flavor):
    from repro_torch.data.images import SyntheticImages
    return SyntheticImages(flavor=flavor, train_size=200, test_size=40,
                           seed=7)


def test_run_dfl_cnn_supersteps_change_no_logged_value(monkeypatch):
    """The rounds between two log points are one superstep: logging every
    round or every 2 after the first gives the same values at the rounds
    both log, and ``round_ms`` has one entry a round."""
    monkeypatch.setattr(cnn_run, "get_data", small_data)
    spec = cnn_run.RunSpec(name="windows", tau1=1, tau2=1, rounds=5,
                           batch=2, flavor="mnist")
    tel = Telemetry()
    every = cnn_run.run_dfl_cnn(spec, device="cpu", log_every=1)
    sparse = cnn_run.run_dfl_cnn(spec, device="cpu", log_every=2,
                                 log_first=1, telemetry=tel)
    assert cnn_run.log_points(5, 2, 1) == [0, 1, 3, 4]
    h, s = every["history"], sparse["history"]
    assert s["round"] == [1, 2, 4, 5] and h["round"] == [1, 2, 3, 4, 5]
    for key in ("loss", "global_loss", "consensus", "test_acc", "gbits"):
        assert [h[key][r - 1] for r in s["round"]] == s[key], key
    assert len(sparse["round_ms"]) == len(every["round_ms"]) == 5
    dispatched = [e["data"]["k"] for e in tel.events
                  if e["type"] == "superstep" and not e["data"]["warmup"]]
    assert dispatched == [1, 1, 2, 1]
    assert sum(e["type"] == "flush" for e in tel.events) == 4
