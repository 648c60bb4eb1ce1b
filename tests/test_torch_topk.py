"""K4 topk_threshold and K5 topk_mask in the PyTorch port against the JAX
reference, bitwise.

The port's plain versions (what ``repro_torch.kernels.ops`` runs on CPU
tensors) are held against the reference's Pallas kernels in interpret mode
and against the reference ``TopK`` compressor; the CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``. The contract
is bitwise: the threshold is the k-th largest |x| in the input dtype and
ties are kept.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcompression
from repro.kernels import ops as jops
from repro.kernels.registry import PARITY_SHAPES
from repro_torch.core import compression
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _bits(a):
    """Bit patterns via an exact f32 view (bf16 -> f32 is exact)."""
    if isinstance(a, torch.Tensor):
        f = a.float().numpy()
    else:
        f = np.asarray(a.astype(jnp.float32))
    return np.ascontiguousarray(f).view(np.uint32)


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_threshold_and_mask_match_reference_kernels(shape, dtype):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = rng.normal(size=(3,) + shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    k = max(1, int(np.prod(shape)) // 4)
    rows = xt.reshape(3, -1)
    t = ops.topk_threshold(rows, k)
    masked = ops.topk_mask(rows, t).reshape(xt.shape)
    for i in range(3):
        want_t = jops.topk_threshold(xj[i], k, interpret=True)
        assert np.array_equal(_bits(t[i:i + 1]), _bits(want_t[None]))
        want = jops.top_k_compress(xj[i], k, interpret=True)
        assert np.array_equal(_bits(masked[i]), _bits(want))


@pytest.mark.parametrize("frac", [0.1, 0.5, 0.67, 0.89, 1.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_topk_compressor_matches_reference_compressor(frac, dtype):
    x = np.random.default_rng(5).normal(size=(10, 300, 70)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    comp = compression.make_compressor("top_k", frac=frac)
    jcomp = jcompression.make_compressor("top_k", frac=frac)
    # one vector, as the reference's __call__
    assert np.array_equal(_bits(comp(xt[0])), _bits(jcomp(xj[0], None)))
    # every node's slice of a stacked leaf at once
    got = comp.per_node(xt)
    for i in range(10):
        assert np.array_equal(_bits(got[i]), _bits(jcomp(xj[i], None)))
    assert comp.delta(21000) == jcomp.delta(21000)
    assert comp.bits_per_value(21000) == jcomp.bits_per_value(21000)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ties_zeros_and_k_equals_d(dtype):
    # ties at the threshold are all kept; signs do not matter
    x = np.array([[3.0, -2.0, 2.0, 2.0, -1.0, 0.5, -2.0, 0.0]], np.float32)
    xj, xt = _pair(x, dtype)
    for k in (2, 8):
        t = ops.topk_threshold(xt, k)
        want = jops.top_k_compress(xj[0], k, interpret=True)
        assert np.array_equal(_bits(ops.topk_mask(xt, t)[0]), _bits(want))
    t = ops.topk_threshold(xt, 2)
    assert float(t[0]) == 2.0
    assert int((ops.topk_mask(xt, t) != 0).sum()) == 5
    # all tied: everything survives at any k
    tied = torch.full((2, 33), -0.75).to(DTYPES[dtype][1])
    assert torch.equal(ops.topk_mask(tied, ops.topk_threshold(tied, 4)), tied)
    # k = D keeps the whole row, zeros included
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 65)).astype(
        np.float32)).to(DTYPES[dtype][1])
    x[:, ::7] = 0
    assert torch.equal(ops.topk_mask(x, ops.topk_threshold(x, 65)), x)
    want = jops.top_k_compress(jnp.asarray(x[0].float().numpy()).astype(
        DTYPES[dtype][0]), 65, interpret=True)
    assert np.array_equal(_bits(x[0]), _bits(want))
    # an all-zero row (and -0.0) has threshold 0 and maps to itself
    z = torch.zeros(3, 100).to(DTYPES[dtype][1])
    z[1] = -0.0
    t = ops.topk_threshold(z, 10)
    assert _bits(t).tolist() == [0, 0, 0]
    assert np.array_equal(_bits(ops.topk_mask(z, t)), _bits(z))
    zj = jnp.zeros((100,), DTYPES[dtype][0])
    assert np.array_equal(_bits(jops.top_k_compress(zj, 10, interpret=True)),
                          _bits(z[0]))


def test_out_of_range_k_raises():
    x = torch.ones(2, 10)
    for k in (0, 11, -1):
        with pytest.raises(ValueError, match="out of range"):
            ops.topk_threshold(x, k)
        with pytest.raises(ValueError, match="out of range"):
            jops.topk_threshold(jnp.ones(10), k, interpret=True)


def test_wrappers_reject_bad_operands():
    x = torch.ones(2, 10)
    with pytest.raises(TypeError, match="dtype"):
        ops.topk_threshold(x.half(), 3)
    with pytest.raises(ValueError, match="thresh"):
        ops.topk_mask(x, torch.ones(3))
    with pytest.raises(ValueError, match="thresh"):
        ops.topk_mask(x, torch.ones(2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_threshold(torch.ones(10, 2).t(), 3)


def test_make_compressor_names():
    assert isinstance(compression.make_compressor("identity"),
                      compression.Identity)
    for name, kw in (("qsgd", {}), ("qsgd", {"levels": 4}), ("rand_k", {}),
                     ("rand_k", {"frac": 0.67}), ("rand_gossip", {}),
                     ("rand_gossip", {"p": 0.6})):
        comp = compression.make_compressor(name, **kw)
        jcomp = jcompression.make_compressor(name, **kw)
        assert comp.name == jcomp.name == name
        for d in (1, 10, 1000, 393216):
            assert comp.delta(d) == jcomp.delta(d)
            assert comp.bits_per_value(d) == jcomp.bits_per_value(d)
    with pytest.raises(ValueError, match="unknown compressor"):
        compression.make_compressor("nope")
    x = np.random.default_rng(2).normal(size=(5, 5, 3, 4)).astype(np.float32)
    got = compression.compress_tree(compression.make_compressor(
        "top_k", frac=0.3), {"a": torch.from_numpy(x)})
    want = jcompression.compress_tree(jcompression.make_compressor(
        "top_k", frac=0.3), {"a": jnp.asarray(x)}, None)
    assert np.array_equal(_bits(got["a"]), _bits(want["a"]))
    tree = {"a": np.zeros((5, 5, 3, 64)), "b": np.zeros(10)}
    for name, kw in (("identity", {}), ("top_k", {"frac": 0.67}),
                     ("qsgd", {}), ("rand_k", {"frac": 0.67}),
                     ("rand_gossip", {"p": 0.6})):
        assert compression.tree_wire_bits(
            compression.make_compressor(name, **kw), tree) == \
            jcompression.tree_wire_bits(
                jcompression.make_compressor(name, **kw), tree)
