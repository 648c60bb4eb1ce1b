"""K6 qsgd_quantize and the ``QSGD`` compressor in the PyTorch port against
the JAX reference.

The noise is the reference's own: ``jax.random.uniform`` of a key, handed
to both. The port's plain version (what ``repro_torch.kernels.ops`` runs on
CPU tensors) is held against the reference's Pallas kernel in interpret
mode, its oracle ``ref.qsgd_ref`` and the ``QSGD`` compressor, over the
parity shapes in f32 and bf16, to 1e-5 in f32 and 1e-2 in bf16 (the
tolerances of ``tests/test_kernels.py``). Where both sides are handed the
same norm the levels and outputs agree bitwise with the eager oracle. The
CUDA kernel is held bitwise against the plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcompression
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.registry import PARITY_SHAPES
from repro_torch.core import compression
from repro_torch.kernels import ops, qsgd

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
N = 3


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _c(d, levels):
    s = float(levels)
    return 1.0 + min(d / (s * s), d ** 0.5 / s)


def _inputs(shape, dtype, seed):
    """N rows of x (scaled normal, row 1 all zero) and the reference's
    uniform noise for each, as (jax rows, torch [N, D], noise [N, D])."""
    jdt, tdt = DTYPES[dtype]
    x = 3 * np.random.default_rng(seed).normal(size=(N,) + shape)
    x = x.astype(np.float32)
    x[1] = 0.0
    keys = jax.random.split(jax.random.key(seed), N)
    noise = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt).reshape(N, -1)
    return xj, xt, noise, torch.from_numpy(noise.reshape(N, -1))


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("levels", [4, 16])
def test_qsgd_kernel_matches_reference_kernel_and_oracle(shape, dtype, levels):
    xj, xt, noise, nt = _inputs(shape, dtype, seed=int(np.prod(shape)) + 3)
    d = int(np.prod(shape))
    # the reference's norm, handed to both (the compressor test below
    # takes the port's own)
    norm = np.array([float(jnp.linalg.norm(xj[i].reshape(-1).astype(
        jnp.float32))) for i in range(N)], np.float32)
    got = ops.qsgd_quantize(xt, nt, torch.from_numpy(norm), levels,
                            _c(d, levels))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert not got[1].any()
    for i in range(N):
        want_k = jops.qsgd_quantize(xj[i], jnp.asarray(noise[i]),
                                    levels=levels, interpret=True)
        want_o = jref.qsgd_ref(xj[i], jnp.asarray(noise[i]), levels=levels,
                               c=_c(d, levels))
        for want in (want_k, want_o):
            np.testing.assert_allclose(_f32(got[i]), _f32(want).reshape(-1),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        # the eager oracle rounds every step on its own, as the port does
        np.testing.assert_array_equal(_f32(got[i]), _f32(want_o).reshape(-1))


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_qsgd_compressor_matches_reference_compressor(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    seed = int(np.prod(shape)) + 5
    x = np.random.default_rng(seed).normal(size=(N,) + shape).astype(
        np.float32)
    x[2] = 0.0
    keys = jax.random.split(jax.random.key(seed), N)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    jcomp = jcompression.make_compressor("qsgd")
    comp = compression.make_compressor("qsgd")
    want = np.stack([_f32(jcomp(xj[i], keys[i])) for i in range(N)])
    draws = np.stack([np.asarray(jax.random.uniform(
        k, (int(np.prod(shape)),))) for k in keys])
    got = comp.per_node(xt, torch.from_numpy(draws))
    assert got.shape == xt.shape and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not got[2].any()
    # one vector, as the reference's __call__
    one = comp(xt[0], torch.from_numpy(draws[0]).reshape(shape))
    np.testing.assert_allclose(_f32(one), want[0], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_plain_is_the_reference_arithmetic_and_settles_the_sign_of_zero():
    """sign(d) ||d|| floor(s |d| / ||d|| + xi) / (s c), every step rounded
    on its own in f32 (numpy's f32 operations), bitwise; +0 and -0 map to
    +0, a negative coordinate whose level is 0 to -0, a zero row to +0."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 500)).astype(np.float32)
    x[0, :7] = [0.0, -0.0, 1e-9, -1e-9, 0.0, -0.0, 2.0]
    x[2] = -0.0
    noise = rng.uniform(size=(3, 500)).astype(np.float32)
    noise[0, :6] = 0.0
    levels, c = 16, _c(500, 16)
    norm = np.array([float(jnp.linalg.norm(jnp.asarray(r))) for r in x],
                    np.float32)
    got = ops.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(noise),
                            torch.from_numpy(norm), levels, c).numpy()
    sc = np.float32(levels * c)
    assert qsgd.scale(levels, c) == float(sc)
    n = norm[:, None]
    safe = np.where(n > 0, n, np.float32(1))
    lvl = np.floor(np.float32(levels) * np.abs(x) / safe + noise)
    sign = (x > 0).astype(np.float32) - (x < 0).astype(np.float32)
    want = np.where(n > 0, sign * safe * lvl / sc, np.float32(0))
    assert want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    zero, neg_zero = np.float32(0).view(np.uint32), np.float32(-0.0).view(
        np.uint32)
    assert got[0, :2].view(np.uint32).tolist() == [zero, zero]
    assert got[0, 3].view(np.uint32) == neg_zero      # -1e-9, level 0
    assert (got[2].view(np.uint32) == zero).all()     # norm 0
    # the reference, which takes the same norm, agrees by value (-0 == +0)
    for i in range(3):
        want_ref = jref.qsgd_ref(jnp.asarray(x[i]), jnp.asarray(noise[i]),
                                 levels=levels, c=c)
        np.testing.assert_array_equal(got[i], np.asarray(want_ref))


def test_qsgd_wrapper_rejects_bad_operands():
    x, noise, norm = torch.zeros(2, 8), torch.zeros(2, 8), torch.ones(2)
    with pytest.raises(TypeError, match="noise"):
        ops.qsgd_quantize(x, noise.bfloat16(), norm, 16, 1.5)
    with pytest.raises(ValueError, match="noise"):
        ops.qsgd_quantize(x, torch.zeros(2, 9), norm, 16, 1.5)
    with pytest.raises(ValueError, match="norm"):
        ops.qsgd_quantize(x, noise, torch.ones(3), 16, 1.5)
    with pytest.raises(ValueError, match="norm"):
        ops.qsgd_quantize(x, noise, norm.double(), 16, 1.5)
    with pytest.raises(ValueError, match="draws"):
        compression.make_compressor("qsgd").per_node(x)
    with pytest.raises(ValueError, match="draws"):
        compression.make_compressor("qsgd").per_node(x, noise[:, :4])
