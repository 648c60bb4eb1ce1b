"""The port's optimizers and schedules against the reference's.

The reference runs ``opt.update`` under ``jax.vmap`` with a scalar step
per node; the port writes the node axis out (``step`` [N] int32, a
schedule's value [N] f32). Both get the same numpy gradients and
parameters for several steps; every update, slot and step is held to
rtol 1e-6 or 1 f32 ulp of the reference's value (``assert_close``), the
element-wise arithmetic being the same but ``pow``, ``cos`` and ``sqrt``
coming from two libraries. Constant-lr ``sgd`` is held bitwise against
``-lr * g``, which every round-parity test depends on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

N = 4
SHAPES = {"w": (3, 5), "b": (5,), "c": (2, 2, 3)}
STEPS = 4


def assert_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    ok = (np.abs(got - want) <= 1e-6 * np.abs(want)) | (
        np.abs(got - want) <= ulp)
    assert ok.all(), np.max(np.abs(got - want))


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(N,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(make_j, make_t):
    """STEPS updates of both optimizers on the same gradients; returns the
    per-step (reference, port) updates and the final states."""
    params = _trees(0)
    jo, to = make_j(), make_t()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jax.vmap(jo.init)(jp), to.init(tp)
    pairs = []
    for step in range(STEPS):
        grads = _trees(10 + step)
        ju, js = jax.vmap(jo.update)({k: jnp.asarray(v)
                                      for k, v in grads.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v)
                            for k, v in grads.items()}, ts, tp)
        pairs.append((ju, tu))
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
    return pairs, (js, ts), (jp, tp)


def _check(pairs, params):
    for ju, tu in pairs:
        for k in SHAPES:
            assert_close(tu[k].numpy(), ju[k])
    jp, tp = params
    for k in SHAPES:
        assert_close(tp[k].numpy(), jp[k])
        assert tp[k].dtype == torch.float32


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_sgd_matches_reference(nesterov):
    pairs, (js, ts), params = _run_both(
        lambda: jopt.momentum_sgd(0.05, beta=0.8, nesterov=nesterov),
        lambda: topt.momentum_sgd(0.05, beta=0.8, nesterov=nesterov))
    _check(pairs, params)
    np.testing.assert_array_equal(ts["step"].numpy(), np.asarray(js.step))
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == (N,)
    for k in SHAPES:
        assert ts["velocity"][k].dtype == torch.float32
        assert_close(ts["velocity"][k].numpy(), js.velocity[k])


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    pairs, (js, ts), params = _run_both(
        lambda: jopt.adamw(1e-2, weight_decay=weight_decay),
        lambda: topt.adamw(1e-2, weight_decay=weight_decay))
    _check(pairs, params)
    np.testing.assert_array_equal(ts["step"].numpy(), np.asarray(js.step))
    for k in SHAPES:
        assert_close(ts["mu"][k].numpy(), js.mu[k])
        assert_close(ts["nu"][k].numpy(), js.nu[k])


def test_schedules_drive_the_optimizers():
    """sgd, momentum and adamw with a schedule: the [N] step drives each
    node's learning rate."""
    for name in ("sgd", "momentum_sgd", "adamw"):
        pairs, _, params = _run_both(
            lambda: getattr(jopt, name)(jsched.cosine_decay(0.1, 3, 0.01)),
            lambda: getattr(topt, name)(tsched.cosine_decay(0.1, 3, 0.01)))
        _check(pairs, params)


def test_constant_sgd_is_minus_lr_times_g():
    g = {k: torch.from_numpy(v) for k, v in _trees(3).items()}
    opt = topt.sgd(0.05)
    state = opt.init(g)
    upd, state = opt.update(g, state, g)
    for k in g:
        assert torch.equal(upd[k], -0.05 * g[k])
    assert state["step"].tolist() == [1] * N
    pairs, _, params = _run_both(lambda: jopt.sgd(0.05),
                                 lambda: topt.sgd(0.05))
    for ju, tu in pairs:
        for k in SHAPES:
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))


SCHEDULES = {
    "constant": ((0.3,), {}),
    "cosine_decay": ((0.1, 50), {"floor": 0.01}),
    "warmup_cosine": ((0.2, 10, 60), {"floor": 0.02}),
    "step_decay": ((0.5, 0.3, 7), {}),
    "cdfl_decay": ((0.7, 20.0), {}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    args, kw = SCHEDULES[name]
    steps = np.arange(0, 80, dtype=np.int32)
    want = np.asarray(getattr(jsched, name)(*args, **kw)(jnp.asarray(steps)))
    got = getattr(tsched, name)(*args, **kw)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.broadcast_to(want, steps.shape))


def test_clip_by_global_norm_alone_and_under_vmap():
    """One node's tree: clipped to the global norm when above it, unchanged
    below; under torch.func.vmap over a stacked tree, each node clipped by
    its own norm, as the reference under jax.vmap."""
    tree = _trees(7)
    one = {k: v[0] for k, v in tree.items()}
    for max_norm in (0.5, 1e6):
        got = topt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in one.items()}, max_norm)
        want = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in one.items()}, max_norm)
        for k in SHAPES:
            assert_close(got[k].numpy(), want[k])
    got = torch.func.vmap(lambda t: topt.clip_by_global_norm(t, 1.5))(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    want = jax.vmap(lambda t: jopt.clip_by_global_norm(t, 1.5))(
        {k: jnp.asarray(v) for k, v in tree.items()})
    for k in SHAPES:
        assert_close(got[k].numpy(), want[k])
    norms = np.sqrt(sum((got[k].numpy().reshape(N, -1) ** 2).sum(1)
                        for k in SHAPES))
    np.testing.assert_allclose(norms, 1.5, rtol=1e-5)
