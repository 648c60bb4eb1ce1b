"""K3 choco_topk and K2 choco_qsgd (the fused CHOCO-TopK and CHOCO-QSGD
steps) in the PyTorch port against the JAX reference.

TopK: the port runs the gap in the leaf dtype, its per-node threshold (K4)
and the fused move-and-update (K3); on CPU tensors these are the plain
versions. Contract against the reference's Pallas kernel (interpret mode)
and its oracle ``ref.choco_topk_ref``: ``x_new`` within 1 f32 ulp (XLA may
contract ``x + gamma (my - y)`` into an fma where torch rounds twice) and
``y_new`` bitwise wherever the two gaps are bitwise equal (the threshold
is then the same and every keep decision with it).

QSGD: the port takes the gap's per-node f32 norm with
``torch.linalg.vector_norm`` and runs K2, with the reference's own uniform
noise. Against ``choco_qsgd_2d`` (interpret mode) and ``ref.choco_qsgd_ref``:
``x_new`` within 1 ulp as above; ``y_new`` to the reference's own contract
(``tests/test_kernels.py``) when handed the reference's norm: the
quantization level picked identical and the value within 1 ulp (bitwise
against the eager oracle). With the port's own norm, which may differ in
the last bit, a coordinate could change level by one step of
||d||/(s c); the count of such coordinates allowed is ``MAX_LEVEL_FLIPS``
= 0, and it is 0 at every parity size; the values then agree to
``NORM_BIT_ULPS``. The CUDA kernels are held bitwise against the plain versions
on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import substrate as jsubstrate
from repro.core import topology as jtopology
from repro.core.compression import make_compressor as jmake_compressor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.registry import PARITY_SHAPES
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.kernels import choco_fused, ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GAMMA = 0.6
MAX_LEVEL_FLIPS = 0
# With its own norm, which differs from JAX's in the last bit at most
# parity sizes, K2's q = sign ||d|| lvl / (s c) carries that relative
# 2^-23 through two roundings: up to 6 ulps of q, and one more in y + q.
NORM_BIT_ULPS = 8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _bits(a):
    return np.ascontiguousarray(_f32(a)).view(np.uint32)


def _ulp_diff(want, got, x, y, my, dtype):
    """max |want - got| in ulps of the leaf dtype at the larger addend of
    x + gamma (my - y): an fma skips the rounding of the product, which
    moves the sum by up to that much, however small the sum itself is."""
    scale = np.maximum(np.abs(x), np.abs(np.float32(GAMMA) * (my - y)))
    scale = np.maximum(scale, np.abs(_f32(got))).astype(np.float32)
    ulp = np.spacing(scale) * (2.0 ** 16 if dtype == "bfloat16" else 1.0)
    return np.max(np.abs(_f32(want) - _f32(got)) / ulp, initial=0.0)


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n,) + shape).astype(np.float32) for _ in range(3)]


def _port_step(x, y, my, k):
    d = choco_fused.gap(x, y, my, GAMMA)
    t = ops.topk_threshold(d, k)
    return d, ops.choco_topk(x, y, my, d, t, GAMMA)


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_step_matches_reference_kernel_and_oracle(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(2, shape, seed=int(np.prod(shape)) + 17)
    xj, yj, myj = (jnp.asarray(a).astype(jdt) for a in arrs)
    xt, yt, myt = (torch.from_numpy(a).to(tdt).reshape(2, -1) for a in arrs)
    x, y, my = (_f32(t) for t in (xt, yt, myt))
    k = max(1, int(np.prod(shape)) // 3)
    d, (x_new, y_new) = _port_step(xt, yt, myt, k)
    jit_gap = jax.jit(jops._fused_diff)
    for i in range(2):
        # the jitted reference (its kernel wrapper) may contract the move
        # into an fma, in the gap as well; its eager oracle does not
        gaps = {"kernel": jit_gap(xj[i], yj[i], myj[i], jnp.float32(GAMMA)),
                "oracle": jops._fused_diff(xj[i], yj[i], myj[i],
                                           jnp.float32(GAMMA))}
        for name, (want_x, want_y) in (
                ("kernel", jops.choco_topk_move(xj[i], yj[i], myj[i], GAMMA,
                                                k, interpret=True)),
                ("oracle", jref.choco_topk_ref(xj[i], yj[i], myj[i], GAMMA,
                                               k))):
            assert _ulp_diff(want_x.reshape(-1), x_new[i], x[i], y[i], my[i],
                             dtype) <= 1.0, name
            same = _bits(gaps[name]) == _bits(d[i])
            assert np.array_equal(_bits(want_y.reshape(-1))[same],
                                  _bits(y_new[i])[same]), name
        # the eager oracle is the port's arithmetic exactly
        assert np.array_equal(_bits(gaps["oracle"]), _bits(d[i]))


def _qsgd_level(d, norm, noise, levels):
    """The QSGD level floor(s |d| / ||d|| + xi), in f32 as the kernels."""
    safe = np.float32(norm) if norm > 0 else np.float32(1)
    return np.floor(np.float32(levels) * np.abs(d) / safe + noise)


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_qsgd_step_matches_reference_kernel_and_oracle(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    seed = int(np.prod(shape)) + 29
    arrs = _inputs(2, shape, seed=seed)
    keys = jax.random.split(jax.random.key(seed), 2)
    noise = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])
    xj, yj, myj = (jnp.asarray(a).astype(jdt) for a in arrs)
    xt, yt, myt = (torch.from_numpy(a).to(tdt).reshape(2, -1) for a in arrs)
    x, y, my = (_f32(t) for t in (xt, yt, myt))
    d_size = int(np.prod(shape))
    c = 1.0 + min(d_size / 256.0, d_size ** 0.5 / 16.0)
    d = choco_fused.gap(xt, yt, myt, GAMMA)
    nt = torch.from_numpy(noise.reshape(2, -1))
    # the port's own norm, as the substrate takes it, and the reference's
    norm = torch.linalg.vector_norm(d.float(), dim=1)
    x_new, y_new = ops.choco_qsgd(xt, yt, myt, nt, norm, GAMMA, 16, c)
    jit_gap = jax.jit(jops._fused_diff)
    for i in range(2):
        gaps = {"kernel": jit_gap(xj[i], yj[i], myj[i], jnp.float32(GAMMA)),
                "oracle": jops._fused_diff(xj[i], yj[i], myj[i],
                                           jnp.float32(GAMMA))}
        nz = jnp.asarray(noise[i])
        for name, (want_x, want_y) in (
                ("kernel", jops.choco_qsgd_move(xj[i], yj[i], myj[i], GAMMA,
                                                nz, levels=16,
                                                interpret=True)),
                ("oracle", jref.choco_qsgd_ref(xj[i], yj[i], myj[i], GAMMA,
                                               nz, levels=16, c=c))):
            assert _ulp_diff(want_x.reshape(-1), x_new[i], x[i], y[i], my[i],
                             dtype) <= 1.0, name
            ref_gap = _f32(gaps[name])
            ref_norm = np.float32(jnp.linalg.norm(ref_gap))
            flips = np.sum(_qsgd_level(ref_gap, ref_norm, noise[i].reshape(-1),
                                       16)
                           != _qsgd_level(_f32(d[i]), float(norm[i]),
                                          noise[i].reshape(-1), 16))
            assert flips <= MAX_LEVEL_FLIPS, (name, flips)
            # handed the reference's norm, K2 keeps its contract: 1 ulp
            # against the jitted kernel, bitwise against the eager oracle
            want_y = _f32(want_y).reshape(-1)
            _, y_same = ops.choco_qsgd(xt[i:i + 1], yt[i:i + 1], myt[i:i + 1],
                                       nt[i:i + 1], torch.tensor([ref_norm]),
                                       GAMMA, 16, c)
            assert _y_ulps(want_y, y_same[0], y[i], dtype) <= (
                1.0 if name == "kernel" else 0.0), name
            assert _y_ulps(want_y, y_new[i], y[i], dtype) <= NORM_BIT_ULPS


def _y_ulps(want_y, got_y, y, dtype):
    """max |want - got| in ulps of the leaf dtype at the largest of |y|,
    |q| and |y_new|."""
    got_y = _f32(got_y)
    scale = np.max([np.abs(y), np.abs(want_y - y), np.abs(want_y),
                    np.abs(got_y)], axis=0)
    ulp = np.spacing(scale.astype(np.float32)) * (
        2.0 ** 16 if dtype == "bfloat16" else 1.0)
    return np.max(np.abs(want_y - got_y) / ulp, initial=0.0)


def test_plain_is_the_kernel_arithmetic():
    """x_new rounds gamma (my - y) and the add separately (no fma), y_new
    adds the kept gap in the leaf dtype: the plain version written with
    numpy's f32 operations, bitwise."""
    x, y, my = (torch.from_numpy(a) for a in _inputs(3, (1000,), seed=4))
    d = choco_fused.gap(x, y, my, GAMMA)
    t = ops.topk_threshold(d, 670)
    x_new, y_new = choco_fused.plain(x, y, my, d, t, GAMMA)
    xs, ys, ms, ds = (a.numpy() for a in (x, y, my, d))
    g = np.float32(GAMMA)
    want_x = xs + g * (ms - ys)
    assert np.array_equal(x_new.numpy().view(np.uint32), want_x.view(np.uint32))
    assert np.array_equal(ds.view(np.uint32), (want_x - ys).view(np.uint32))
    q = np.where(np.abs(ds) >= t.numpy()[:, None], ds, np.float32(0))
    assert np.array_equal(y_new.numpy().view(np.uint32),
                          (ys + q).view(np.uint32))


@pytest.mark.parametrize("name", ["ring4", "quasi"])
def test_substrate_choco_step_matches_reference_dense_substrate(name):
    """One CHOCO-TopK iteration on stacked leaves, from the same mixed
    estimates, against the reference dense substrate's unfused composition
    (eager, so no fma: both outputs agree bitwise)."""
    make = (lambda m: m.ring(4)) if name == "ring4" else (
        lambda m: m.paper_quasi_ring())
    topo, jtopo = make(topology), make(jtopology)
    n = topo.num_nodes
    shapes = {"c": (3, 3, 1, 16), "b": (16,), "d": (98, 10)}
    rng = np.random.default_rng(11)
    x, y = ({k: rng.normal(size=(n,) + s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2))
    sub, jsub = DenseSubstrate(topo), jsubstrate.DenseSubstrate(jtopo)
    tx, ty = ({k: torch.from_numpy(v) for k, v in t.items()} for t in (x, y))
    my = {k: v.numpy() for k, v in sub.mix(ty).items()}
    got_x, got_y = sub.choco_step(
        make_compressor("top_k", frac=0.67), tx, ty,
        {k: torch.from_numpy(v) for k, v in my.items()}, GAMMA)
    keys = jsub.node_keys(jnp.zeros((2,), jnp.uint32))
    want_x, want_y = jsub.choco_step(
        jmake_compressor("top_k", frac=0.67),
        *({k: jnp.asarray(v) for k, v in t.items()} for t in (x, y, my)),
        GAMMA, keys)
    for k in shapes:
        assert np.array_equal(_bits(got_x[k]), _bits(want_x[k]))
        assert np.array_equal(_bits(got_y[k]), _bits(want_y[k]))


def test_identity_compressor_takes_the_unfused_path():
    topo = topology.ring(4)
    sub = DenseSubstrate(topo)
    x, y, my = ({"a": torch.from_numpy(a)} for a in _inputs(4, (50,), seed=9))
    ops.reset_launches()
    x_new, y_new = sub.choco_step(make_compressor("identity"), x, y, my, GAMMA)
    want_x = (x["a"] + GAMMA * (my["a"] - y["a"]))
    assert torch.equal(x_new["a"], want_x)
    assert torch.equal(y_new["a"], y["a"] + (want_x - y["a"]))
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def test_wrapper_rejects_bad_operands():
    x = torch.zeros(2, 8)
    t = torch.zeros(2)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.choco_topk(x, x, x, x.bfloat16(), t, GAMMA)
    with pytest.raises(ValueError, match="shape"):
        ops.choco_topk(x, x, x, torch.zeros(2, 9), t, GAMMA)
    with pytest.raises(ValueError, match="thresh"):
        ops.choco_topk(x, x, x, x, torch.zeros(3), GAMMA)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gap_in_column_chunks_is_bitwise_the_whole(monkeypatch, dtype):
    """A leaf above ``GAP_CHUNK`` elements takes its gap a column chunk at
    a time (bounded f32 temporaries): bitwise the one-pass gap, ragged last
    chunk included."""
    gen = torch.Generator().manual_seed(4)
    x, y, my = (torch.randn(4, 1001, generator=gen).to(dtype)
                for _ in range(3))
    want = choco_fused.gap(x, y, my, 0.6)
    monkeypatch.setattr(choco_fused, "GAP_CHUNK", 4 * 64)
    got = choco_fused.gap(x, y, my, 0.6)
    assert got.dtype == dtype and torch.equal(got, want)
