"""The executor's capture-ready rounds (``repro_torch.core.graphs``) on the
CPU, where ``capture`` binds each step to run eagerly into the static
buffers that a CUDA graph reads on the card.

Within the port the contract is bitwise: the step path is
``make_round_fn(..., dynamic_taus=True)``'s eager rounds, for plain DFL,
every compressor (the random ones drawing under the seam's device key) and
masked rows; the seam's device-key draw is its host-key draw. Against the
reference's ``RoundExecutor``: plain DFL and TopK to rtol 1e-5, C-DFL 1e-4
(QSGD fed the reference's own draws), as ``test_torch_executor`` and
``test_torch_faults`` hold the executor. After ``warmup`` nothing is
captured or built again, a fresh batch tensor is read, and a capture that
fails raises and leaves nothing to run eagerly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DFLConfig as JDFLConfig
from repro.core import RoundExecutor as JRoundExecutor
from repro.core import init_state as jinit_state
from repro.core import stack_round_batches as jstack_round_batches
from repro.optim import sgd as jsgd
from repro_torch.core import (DFLConfig, RoundExecutor, make_round_fn, ring,
                              stack_round_batches)
from repro_torch.core import graphs
from repro_torch.core.dfl import loss_over_tau1
from repro_torch.core.rng import GeneratorDraws, KeyedDraws, ReplayDraws
from repro_torch.core.topology import ring as tring
from repro_torch.optim import momentum_sgd, sgd
from test_torch_faults import (COMPRESSORS, DIM, N, assert_state_bitwise,
                               comp_of, fresh, jlin_loss, lin_loss,
                               lin_round_batches, plan_rows)
from test_torch_round import _reference_draws
from repro.core import ring as jring

SCHEDULE = [(3, 2), (2, 1), (3, 0), (1, 2)]


# ---------------------------------------------------------------------------
# The seam under a device key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("round_idx,step,ids", [
    (0, 0, None), (3, 2, None), (17, 0, [5, 1, 3]), (2**31 + 5, 7, [0]),
    (9, 1, list(range(30))), (1, 3, [999, 0, 42])])
def test_keyed_draws_bitwise_host_draws(round_idx, step, ids):
    """``KeyedDraws`` with the key tensor holding ``step_key(r, t)`` draws
    the host-keyed bits, for every leaf at once and leaf by leaf."""
    leaves = {"a": (7,), "b": (3, 4), "c": ()}
    draws = GeneratorDraws(11, 1000, leaves, "cpu")
    key = torch.zeros((), dtype=torch.int64)
    keyed = draws.keyed(key)
    assert isinstance(keyed, KeyedDraws)
    key.copy_(torch.tensor(draws.step_key(round_idx, step)))
    names, shapes = list(leaves), list(leaves.values())
    want = draws.uniform_many(round_idx, step, names, shapes, ids)
    got = keyed.uniform_many(round_idx + 1, step + 1, names, shapes, ids)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
    for name, shape, b in zip(names, shapes, want):
        assert torch.equal(keyed.uniform(0, 0, name, shape, ids), b)
    # a [T] key is one key a gossip step (the static fallback's captured
    # round); anything of more dimensions is refused
    per_step = draws.keyed(torch.tensor(
        [draws.step_key(round_idx, t) for t in range(step + 2)]))
    for a, b in zip(per_step.uniform_many(round_idx + 5, step, names, shapes,
                                          ids), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int64"):
        draws.keyed(torch.zeros(2, 2, dtype=torch.int64))


def test_loss_over_tau1_is_true_division():
    """The dynamic round divides its summed loss by tau1 as a tensor: true
    division, so tau1 = 3 gives the correctly rounded quotient (the card's
    division by a host number multiplies by a rounded reciprocal)."""
    s = torch.tensor([1.0, 0.7, 2.3, 5.1], dtype=torch.float32)
    got = loss_over_tau1(s, torch.full((), 3, dtype=torch.float32))
    want = (s.double() / 3).float()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The step path is make_round_fn's eager rounds, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("label", sorted(COMPRESSORS))
def test_step_path_bitwise_eager_rounds(label, masked):
    topo = ring(N)
    c = comp_of(label)
    opt = momentum_sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=topo, compression=c, gamma=0.5)
    rows = plan_rows(topo, SCHEDULE)
    if not masked:
        rows = rows[:, :2].copy()
    per_round = lin_round_batches([3] * len(SCHEDULE))
    ex = RoundExecutor(cfg, lin_loss, opt, participation=masked)
    out, m = ex.dispatch_trajectory(fresh(opt, c is not None),
                                    stack_round_batches(per_round, 3, "cpu"),
                                    rows)
    round_fn = make_round_fn(cfg, lin_loss, opt, dynamic_taus=True,
                             participation=masked)
    ref = fresh(opt, c is not None)
    for k, (t1, t2) in enumerate(SCHEDULE):
        b = {key: torch.from_numpy(v) for key, v in per_round[k].items()}
        args = (rows[k, 2:2 + N], rows[k, 2 + N:]) if masked else ()
        ref, mr = round_fn(ref, b, t1, t2, *args)
        for key in ("loss", "consensus_sq"):
            assert torch.equal(m[key][k], mr[key])
    assert_state_bitwise(ref, out)
    assert ex.capture_count == (7 if masked else 4)


@pytest.mark.parametrize("overlap", ["none", "pipeline"])
def test_step_path_topology_schedule(overlap):
    """Round k of a topology schedule gossips over schedule[k % len] by the
    dense product: the step path copies that round's matrix into its
    operand buffer, bitwise the eager rounds (and the eager pipeline)."""
    from repro_torch.core.dfl import make_pipeline_fns
    from repro_torch.core.executor import make_pipeline_superstep
    from repro_torch.core.topology import from_adjacency

    adj = np.zeros((N, N), np.int64)
    for i in range(0, N, 2):
        adj[i, (i + 1) % N] = adj[(i + 1) % N, i] = 1
    sched = (from_adjacency("pairs", adj), ring(N))
    opt = sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=sched[0],
                    topology_schedule=sched)
    per_round = lin_round_batches([3] * len(SCHEDULE))
    batches = stack_round_batches(per_round, 3, "cpu")
    rows = np.array(SCHEDULE, np.int32)
    out, m = RoundExecutor(cfg, lin_loss, opt, overlap=overlap)\
        .dispatch_trajectory(fresh(opt), batches, rows)
    if overlap == "pipeline":
        ref, mr = make_pipeline_superstep(
            *make_pipeline_fns(cfg, lin_loss, opt))(fresh(opt), batches, rows)
        assert torch.equal(m["loss"], mr["loss"])
    else:
        round_fn = make_round_fn(cfg, lin_loss, opt, dynamic_taus=True)
        ref = fresh(opt)
        for k, (t1, t2) in enumerate(SCHEDULE):
            ref, mk = round_fn(ref, {key: torch.from_numpy(v) for key, v
                                     in per_round[k].items()}, t1, t2)
            assert torch.equal(m["consensus_sq"][k], mk["consensus_sq"])
    assert_state_bitwise(ref, out)


@pytest.mark.parametrize("label,masked", [("dfl", False), ("top_k", False),
                                          ("qsgd", False), ("dfl", True),
                                          ("qsgd", True)])
def test_step_path_matches_reference_executor(label, masked):
    """The step path against the reference's executor on the same numpy
    batches and rows: plain DFL and TopK to rtol 1e-5, C-DFL QSGD with the
    reference's own draws replayed (host-keyed) to rtol 1e-4, the masked
    rows as ``test_torch_faults`` holds them (1e-4 in C-DFL)."""
    topo = ring(N)
    rows = plan_rows(topo, SCHEDULE)
    if not masked:
        rows = rows[:, :2].copy()
    c, jc = comp_of(label), comp_of(label, "ref")
    rtol = 1e-4 if label == "qsgd" else 1e-5
    per_round = lin_round_batches([t1 for t1, _ in SCHEDULE])
    rng = jax.random.key(3)
    draws = None
    if label == "qsgd":
        draws = ReplayDraws(_reference_draws(
            c, rng, {"w": (DIM,)}, rounds=len(SCHEDULE),
            tau2=[t2 for _, t2 in SCHEDULE], n=N), device="cpu")
    jex = JRoundExecutor(JDFLConfig(tau1=3, tau2=2, topology=jring(N),
                                    compression=jc, gamma=0.5),
                         jlin_loss, jsgd(0.05), participation=masked)
    jst, jm = jex.dispatch_trajectory(
        jinit_state({"w": jnp.zeros((DIM,))}, N, jsgd(0.05), rng,
                    compressed=c is not None),
        jstack_round_batches(per_round, 3), rows)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=tring(N),
                                 compression=c, gamma=0.5),
                       lin_loss, sgd(0.05), participation=masked)
    out, m = ex.dispatch_trajectory(fresh(sgd(0.05), c is not None, draws),
                                    stack_round_batches(per_round, 3, "cpu"),
                                    rows)
    for key in ("loss", "consensus_sq"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=rtol)
    trees = [(out.params, jst.params)]
    if c is not None:
        trees.append((out.hat_params, jst.hat_params))
    for got, want in trees:
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=rtol, atol=1e-4 if c and masked
                                   else 1e-6)


# ---------------------------------------------------------------------------
# Captures, batches and failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", ["none", "pipeline"])
@pytest.mark.parametrize("label", ["dfl", "qsgd"])
def test_no_capture_or_build_after_warmup(label, overlap):
    """After ``warmup`` a re-plan, a new K and new masks capture and build
    nothing: every step a dispatch can need was captured there."""
    topo = ring(N)
    c = comp_of(label)
    opt = sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=topo, compression=c, gamma=0.5)
    ex = RoundExecutor(cfg, lin_loss, opt, participation=True,
                       overlap=overlap)
    per_round = lin_round_batches([3] * 4)
    st = fresh(opt, c is not None)
    ex.warmup(st, stack_round_batches(per_round[:1], 3, "cpu"))
    counts = (ex.capture_count, ex.compile_count)
    assert counts == ((7 if overlap == "none" else 10), 1)
    rows = plan_rows(topo, SCHEDULE)
    for k, taus in ((4, rows), (2, np.array([[1, 1], [3, 2]], np.int32)),
                    (1, rows[2:3]), (3, rows[1:])):
        st, _ = ex.dispatch_trajectory(
            st, stack_round_batches(per_round[:k], 3, "cpu"), taus)
        st, _ = ex.dispatch(st, stack_round_batches(per_round[:k], 3, "cpu"),
                            2, 1)
    assert (ex.capture_count, ex.compile_count) == counts
    assert torch.isfinite(st.params["w"]).all()


def test_fresh_batch_tensor_is_read():
    """The local step reads a static batch buffer filled from each
    dispatch's batches: a new batch tensor gives that tensor's rounds, not
    the previous dispatch's."""
    opt = sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N))
    a = stack_round_batches(lin_round_batches([3, 3], seed=5), 3, "cpu")
    b = stack_round_batches(lin_round_batches([3, 3], seed=6), 3, "cpu")
    ex = RoundExecutor(cfg, lin_loss, opt, donate=False)
    ex.dispatch(fresh(opt), a, 3, 2)
    got, mg = ex.dispatch(fresh(opt), b, 3, 2)
    want, mw = RoundExecutor(cfg, lin_loss, opt).dispatch(fresh(opt), b, 3, 2)
    assert_state_bitwise(want, got)
    assert torch.equal(mg["loss"], mw["loss"])
    other, _ = RoundExecutor(cfg, lin_loss, opt).dispatch(fresh(opt), a, 3, 2)
    assert not torch.equal(other.params["w"], got.params["w"])


@pytest.mark.parametrize("overlap", ["none", "pipeline"])
def test_failed_capture_raises_and_runs_nothing(monkeypatch, overlap):
    """A capture that fails raises out of the dispatch, which then leaves
    the caller's state untouched; the next dispatch captures again (and
    raises again) rather than running the round some other way."""
    opt = sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N),
                    compression=comp_of("qsgd"), gamma=0.5)
    batches = stack_round_batches(lin_round_batches([3]), 3, "cpu")
    calls = []

    def broken(fn, device, pool=None):
        calls.append(fn)
        if len(calls) == 3:
            raise RuntimeError("capture failed")
        return real(fn, device, pool)

    real = graphs.capture
    monkeypatch.setattr(graphs, "capture", broken)
    ex = RoundExecutor(cfg, lin_loss, opt, overlap=overlap)
    st = fresh(opt, True)
    w0 = st.params["w"].clone()
    with pytest.raises(RuntimeError, match="capture failed"):
        ex.dispatch(st, batches, 3, 2)
    assert torch.equal(st.params["w"], w0) and st.round_idx == 0
    assert ex.capture_count == 2 and ex.dispatch_count == 1
    def always_broken(fn, device, pool=None):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "capture", always_broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        ex.warmup(st, batches)
    monkeypatch.setattr(graphs, "capture", real)
    out, _ = ex.dispatch(st, batches, 3, 2)
    want, _ = RoundExecutor(cfg, lin_loss, opt, overlap=overlap).dispatch(
        fresh(opt, True), batches, 3, 2)
    assert_state_bitwise(want, out)


def test_card_needs_a_counter_based_seam():
    """A host-keyed seam (the replayed draws) runs on the CPU path only: the
    graphs on the card read each step's key from the device."""
    cfg = DFLConfig(tau1=2, tau2=1, topology=ring(N),
                    compression=comp_of("qsgd"), gamma=0.5)
    st = fresh(sgd(0.1), True, ReplayDraws({}, device="cpu"))
    steps = graphs.StepRound(cfg, lin_loss, sgd(0.1), st,
                             {k: torch.from_numpy(v[0]) for k, v in
                              lin_round_batches([1])[0].items()},
                             masked=False, pipeline=False)
    steps.bind_draws(st.draws)
    assert steps.draws is st.draws
    steps.device = torch.device("cuda")
    steps.draws = None
    with pytest.raises(ValueError, match="GeneratorDraws"):
        steps.bind_draws(st.draws)
