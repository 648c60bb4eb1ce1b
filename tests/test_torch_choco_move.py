"""K7 choco_move, ``RandK`` and ``RandomizedGossip`` in the PyTorch port
against the JAX reference, and one CHOCO-G step of each random compressor
on the dense substrate with the reference's own draws replayed through the
RNG seam.

K7's plain version (what ``repro_torch.kernels.ops`` runs on CPU tensors)
is held against the reference's Pallas kernel in interpret mode and its
oracle to the tolerances of ``tests/test_kernels.py`` (1e-4 in f32, 8e-3 in
bf16). K7 takes the gap from the f32 ``x_new``, as the TPU kernel does; the
reference's dense path takes it in the leaf dtype from the cast ``x_new``,
which for bf16 differs within the registry's bf16 tolerance of 1e-2. RandK
and RandomizedGossip are bitwise with the same draws. The CUDA kernel is
held bitwise against the plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcompression
from repro.core import substrate as jsubstrate
from repro.core import topology as jtopology
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.registry import PARITY_SHAPES
from repro_torch.core import compression, topology
from repro_torch.core.rng import ReplayDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.kernels import choco_fused, choco_update, ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOVE_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
GAMMA = 0.37


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(a):
    return np.ascontiguousarray(_f32(a)).view(np.uint32)


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_move_matches_reference_kernel_and_oracle(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(int(np.prod(shape)) + 41)
    arrs = [rng.normal(size=(2,) + shape).astype(np.float32) for _ in range(3)]
    xj, yj, myj = (jnp.asarray(a).astype(jdt) for a in arrs)
    xt, yt, myt = (torch.from_numpy(a).to(tdt).reshape(2, -1) for a in arrs)
    x_new, d = ops.choco_move(xt, yt, myt, GAMMA)
    assert x_new.dtype == d.dtype == tdt
    # K7's gap is the fused kernels' gap, bitwise
    assert np.array_equal(_bits(d), _bits(choco_fused.gap(xt, yt, myt, GAMMA)))
    tol = MOVE_TOL[dtype]
    for i in range(2):
        for want_x, want_d in (
                jops.choco_move(xj[i], yj[i], myj[i], GAMMA, interpret=True),
                jref.choco_move_ref(xj[i], yj[i], myj[i], GAMMA)):
            np.testing.assert_allclose(_f32(x_new[i]),
                                       _f32(want_x).reshape(-1),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(_f32(d[i]), _f32(want_d).reshape(-1),
                                       rtol=tol, atol=tol)
        # the reference's dense path takes the gap from the cast x_new
        dense_x, dense_d = jsubstrate.DenseSubstrate(
            jtopology.ring(2)).choco_move(xj[i], yj[i], myj[i], GAMMA)
        np.testing.assert_allclose(_f32(d[i]), _f32(dense_d).reshape(-1),
                                   rtol=1e-2, atol=1e-2)
        if dtype == "float32":
            assert np.array_equal(_bits(d[i]), _bits(dense_d).reshape(-1))


def test_plain_is_the_kernel_arithmetic():
    """x_new rounds gamma (my - y) and the add separately (no fma); d is
    x_new - y before the cast: numpy's f32 operations, bitwise, and in bf16
    one rounding of the f32 gap."""
    rng = np.random.default_rng(6)
    x, y, my = (rng.normal(size=(3, 700)).astype(np.float32) for _ in range(3))
    g = np.float32(GAMMA)
    want_x = x + g * (my - y)
    got_x, got_d = choco_update.plain(*(torch.from_numpy(a) for a in (x, y, my)),
                                      GAMMA)
    assert np.array_equal(got_x.numpy().view(np.uint32), want_x.view(np.uint32))
    assert np.array_equal(got_d.numpy().view(np.uint32),
                          (want_x - y).view(np.uint32))
    xb, yb, mb = (torch.from_numpy(a).bfloat16() for a in (x, y, my))
    bx, bd = ops.choco_move(xb, yb, mb, GAMMA)
    f = choco_fused.move(xb, yb, mb, GAMMA)
    assert torch.equal(bx, f.bfloat16())
    assert torch.equal(bd, (f - yb.float()).bfloat16())


@pytest.mark.parametrize("frac", [0.1, 0.5, 0.67, 1.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rand_k_matches_reference_compressor(frac, dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(3).normal(size=(4, 30, 7)).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), 4)
    scores = np.stack([np.asarray(jax.random.uniform(k, (210,))) for k in keys])
    scores[1, :50] = scores[1, 60]          # ties at the threshold are kept
    jcomp = jcompression.make_compressor("rand_k", frac=frac)
    comp = compression.make_compressor("rand_k", frac=frac)
    xt = torch.from_numpy(x).to(tdt)
    got = comp.per_node(xt, torch.from_numpy(scores))
    assert got.shape == xt.shape and got.dtype == tdt
    for i in range(4):
        if i == 1:  # the reference draws its own scores: take the mask route
            k = jcomp._k(210)
            t = jax.lax.top_k(jnp.asarray(scores[1]), k)[0][-1]
            want = jnp.where(jnp.asarray(scores[1]) >= t,
                             jnp.asarray(x[1]).astype(jdt).reshape(-1), 0.0)
        else:
            want = jcomp(jnp.asarray(x[i]).astype(jdt), keys[i])
        assert np.array_equal(_bits(got[i]).reshape(-1),
                              _bits(want).reshape(-1))
    # one vector, as the reference's __call__
    one = comp(xt[0], torch.from_numpy(scores[0]))
    assert np.array_equal(_bits(one), _bits(jcomp(jnp.asarray(x[0]).astype(
        jdt), keys[0])))


def test_bernoulli_is_uniform_below_p():
    """The reference's ``jax.random.bernoulli(key, p)`` is
    ``uniform(key, ()) < p`` in f32 on the installed jax, so the port's
    injected uniforms reproduce its keep decisions."""
    for seed in range(64):
        key = jax.random.fold_in(jax.random.key(5), seed)
        for p in (0.8, 0.6, 0.5):
            u = jax.random.uniform(key, ())
            assert bool(jax.random.bernoulli(key, p)) == bool(
                u < jnp.float32(p))


@pytest.mark.parametrize("p", [0.8, 0.6])
def test_randomized_gossip_matches_reference_compressor(p):
    x = np.random.default_rng(4).normal(size=(16, 5, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(7), 16)
    u = np.array([float(jax.random.uniform(k, ())) for k in keys], np.float32)
    u[0] = np.float32(p)                    # u == p is dropped, as u < p
    u[1] = np.nextafter(np.float32(p), np.float32(0))
    jcomp = jcompression.make_compressor("rand_gossip", p=p)
    comp = compression.make_compressor("rand_gossip", p=p)
    got = comp.per_node(torch.from_numpy(x), torch.from_numpy(u))
    kept = [bool(got[i].any()) for i in range(16)]
    assert kept[:2] == [False, True] and 0 < sum(kept) < 16
    for i in range(2, 16):
        want = jcomp(jnp.asarray(x[i]), keys[i])
        assert np.array_equal(_bits(got[i]), _bits(want))
    for i in range(16):
        assert kept[i] == bool(u[i] < np.float32(p))
    one = comp(torch.from_numpy(x[2]), torch.tensor(u[2]))
    assert torch.equal(one, got[2])


@pytest.mark.parametrize("name,kw", [("identity", {}), ("qsgd", {}),
                                     ("qsgd", {"levels": 4}),
                                     ("rand_k", {"frac": 0.67}),
                                     ("rand_gossip", {"p": 0.6})])
def test_substrate_choco_step_with_reference_draws(name, kw):
    """One CHOCO-G step on stacked leaves from the same mixed estimates,
    the reference's per-node, per-leaf keys turned into the seam's draws,
    against the reference dense substrate's unfused composition (eager):
    x_new bitwise; y_new bitwise but for QSGD, whose per-node norm may
    differ in the last bit (no level flips; see test_torch_choco_fused)."""
    topo, jtopo = topology.ring(4), jtopology.ring(4)
    shapes = {"c": (3, 3, 1, 16), "b": (16,), "d": (98, 10)}
    rng = np.random.default_rng(13)
    x, y = ({k: rng.normal(size=(4,) + s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2))
    sub, jsub = DenseSubstrate(topo), jsubstrate.DenseSubstrate(jtopo)
    comp = compression.make_compressor(name, **kw)
    tx, ty = ({k: torch.from_numpy(v) for k, v in t.items()} for t in (x, y))
    my = {k: v.numpy() for k, v in sub.mix(ty).items()}
    step_key = jax.random.fold_in(jax.random.key(3), 1)
    node_keys = jsub.node_keys(step_key)
    names = sorted(shapes)
    table = {}
    for j, leaf in enumerate(names):
        shape = comp.draw_shape(int(np.prod(shapes[leaf])))
        if shape is not None:
            table[(5, 1, leaf)] = np.stack([np.asarray(jax.random.uniform(
                jax.random.split(node_keys[i], len(names))[j], shape))
                for i in range(4)])
    ops.reset_launches()
    got_x, got_y = sub.choco_step(
        comp, tx, ty, {k: torch.from_numpy(v) for k, v in my.items()}, GAMMA,
        ReplayDraws(table, device="cpu"), 5, 1)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    want_x, want_y = jsub.choco_step(
        jcompression.make_compressor(name, **kw),
        *({k: jnp.asarray(v) for k, v in t.items()} for t in (x, y, my)),
        GAMMA, node_keys)
    for k in shapes:
        assert np.array_equal(_bits(got_x[k]), _bits(want_x[k]))
        if name == "qsgd":
            np.testing.assert_allclose(_f32(got_y[k]), _f32(want_y[k]),
                                       rtol=1e-6, atol=1e-6)
        else:
            assert np.array_equal(_bits(got_y[k]), _bits(want_y[k]))


def test_random_compressor_without_draws_raises():
    sub = DenseSubstrate(topology.ring(4))
    t = {"a": torch.zeros(4, 6)}
    for name in ("qsgd", "rand_k", "rand_gossip"):
        with pytest.raises(ValueError, match="draws"):
            sub.choco_step(compression.make_compressor(name), t, t, t, GAMMA)


def test_move_wrapper_rejects_bad_operands():
    x = torch.zeros(2, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.choco_move(x, x.bfloat16(), x, GAMMA)
    with pytest.raises(ValueError, match="shape"):
        ops.choco_move(x, x, torch.zeros(2, 9), GAMMA)
    with pytest.raises(ValueError, match="contiguous"):
        ops.choco_move(torch.zeros(8, 2).t(), x, x, GAMMA)
    with pytest.raises(ValueError, match="draws"):
        compression.make_compressor("rand_k").per_node(x, torch.zeros(2, 7))
