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
from repro_torch.kernels import build, ops, topk

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


# --- K4 over a list of leaves (topk_threshold_many) -------------------------

CIFAR_SIZES = (4800, 64, 102400, 64, 393216, 384, 73728, 192, 1920, 10)
MANY_SIZES = CIFAR_SIZES + (64, 1000, 32768, 32769, 21000)


def _leaf_list(dtype, kind, seed):
    """[3, D] leaves of MANY_SIZES: normal data, or values on a grid of
    quarters (heavy ties) with row 1 all 0 and row 2 all -0.0."""
    rng = np.random.default_rng(seed)
    out = []
    for d in MANY_SIZES:
        x = rng.normal(size=(3, d)).astype(np.float32)
        if kind == "ties":
            x = np.round(x * 4) / 4
            x[1] = 0.0
            x[2] = -0.0
        out.append(_pair(x, dtype))
    return out


@pytest.mark.parametrize("kind,k_of", [("normal", "0.67"), ("ties", "1"),
                                       ("ties", "D")])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_threshold_many_matches_reference_and_per_leaf(dtype, kind, k_of):
    leaves = _leaf_list(dtype, kind, seed=len(kind) + len(k_of))
    ks = [{"0.67": int(np.ceil(0.67 * d)), "1": 1, "D": d}[k_of]
          for d in MANY_SIZES]
    got = ops.topk_threshold_many([t for _, t in leaves], ks)
    assert len(got) == len(leaves)
    for (xj, xt), k, t in zip(leaves, ks, got):
        assert t.shape == (3,) and t.dtype == xt.dtype
        assert np.array_equal(_bits(t), _bits(ops.topk_threshold(xt, k)))
        want = jops.topk_threshold(xj[0], k, interpret=True)
        assert np.array_equal(_bits(t[:1]), _bits(want[None]))
        if kind == "ties":
            assert _bits(t[1:]).tolist() == [0, 0]


def test_threshold_many_rejects_bad_lists():
    x = torch.ones(2, 10)
    with pytest.raises(ValueError, match="k values"):
        ops.topk_threshold_many([x, x], [3])
    with pytest.raises(ValueError, match="k values"):
        ops.topk_threshold_many([], [])
    with pytest.raises(TypeError, match="leaves of"):
        ops.topk_threshold_many([x, x.bfloat16()], [3, 3])
    with pytest.raises(ValueError, match="out of range"):
        ops.topk_threshold_many([x, torch.ones(2, 4)], [3, 5])


@pytest.mark.parametrize("chunk", [16, 64, 1024, topk.CHUNK])
def test_select_plans_cover_every_key_once(chunk):
    """Every key of every row is in exactly one block's chunk, no chunk
    crosses a row, the leaves of several chunks a row come first with one
    scratch segment per row, and lists longer than MAX_LEAVES split."""
    shapes = [(10, d) for d in MANY_SIZES] * 3 + [(1, 1), (7, 17), (2, 33)]
    plans = topk.select_plans(shapes, chunk)
    assert [len(p.index) for p in plans] == [
        min(topk.MAX_LEAVES, len(shapes) - i)
        for i in range(0, len(shapes), topk.MAX_LEAVES)]
    assert sorted(i for p in plans for i in p.index) == list(
        range(len(shapes)))
    for plan in plans:
        seen = {i: np.zeros(shapes[i], np.int32) for i in plan.index}
        multi = [i for i in plan.index if shapes[i][1] > chunk]
        assert list(plan.index[:len(multi)]) == multi
        for block in range(plan.blocks):
            i, row, start, stop = topk.chunk_span(plan, block)
            assert 0 <= row < shapes[i][0]
            assert 0 <= start < stop <= shapes[i][1]
            assert stop - start <= chunk and start % chunk == 0
            assert (block < plan.multi_blocks) == (shapes[i][1] > chunk)
            seen[i][row, start:stop] += 1
        assert all(np.all(s == 1) for s in seen.values())
        segs = [(plan.seg_begin[j], plan.rows[j])
                for j in range(len(plan.index)) if plan.chunks_per_row[j] > 1]
        starts = np.cumsum([0] + [rows for _, rows in segs])
        assert [s for s, _ in segs] == list(starts[:-1])
        assert plan.segments == starts[-1]
    with pytest.raises(ValueError, match="multiple of 16"):
        topk.select_plans(shapes, 100)


def _emulate_select(xs, ks, chunk):
    """The kernel's radix select in numpy, block by block as select_plans
    cuts the rows and digit by digit as digit_passes gives them: every
    block histograms the keys of its chunk that match the row's prefix, the
    row's bins are summed, and the bin holding the remaining rank fixes
    the next digit."""
    dtype = xs[0].dtype
    wide = dtype == torch.float32
    abs_mask = 0x7FFFFFFF if wide else 0x7FFF
    keys = [(x.view(torch.int32 if wide else torch.int16).numpy()
             .astype(np.int64) & abs_mask) for x in xs]
    passes = topk.digit_passes(dtype)
    assert sum(bits for _, bits in passes) == (31 if wide else 15)
    assert all(bits <= topk.MAX_DIGIT_BITS for _, bits in passes)
    assert len(passes) <= topk.MAX_PASSES
    out = [np.zeros(x.shape[0], np.int64) for x in xs]
    for plan in topk.select_plans([tuple(x.shape) for x in xs], chunk):
        state = {(i, r): (0, ks[i]) for i in plan.index
                 for r in range(xs[i].shape[0])}
        for shift, bits in passes:
            fixed = abs_mask & ~((1 << (shift + bits)) - 1)
            hist = {seg: np.zeros(1 << bits, np.int64) for seg in state}
            for block in range(plan.blocks):
                i, r, start, stop = topk.chunk_span(plan, block)
                k = keys[i][r, start:stop]
                k = k[(k & fixed) == state[(i, r)][0]]
                hist[(i, r)] += np.bincount((k >> shift) & ((1 << bits) - 1),
                                            minlength=1 << bits)
            for seg, h in hist.items():
                prefix, rank = state[seg]
                above = np.cumsum(h[::-1])[::-1] - h  # keys in higher bins
                digit = np.flatnonzero((above < rank) & (rank <= above + h))
                assert digit.size == 1
                state[seg] = (prefix | int(digit[0]) << shift,
                              rank - int(above[digit[0]]))
        for (i, r), (prefix, _) in state.items():
            out[i][r] = prefix
    return [torch.from_numpy(o.astype(np.int32 if wide else np.int16)).view(
        dtype) for o in out]


@pytest.mark.parametrize("data", ["normal", "ties", "shared_top_digit",
                                  "zeros_and_tiny"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_digit_schedule_emulation_matches_topk(dtype, data):
    """The digit schedule and the per-chunk histograms find torch.topk's
    threshold: on normal data, on heavy ties, on keys that all share their
    top digit (|x| in [1, 1 + 2^-4): one exponent, one top mantissa
    prefix), and on zeros, -0.0 and subnormals."""
    rng = np.random.default_rng(11)
    shapes = [(3, 1000), (2, 64), (4, 4097), (1, 1), (2, 300)]
    xs = []
    for rows, cols in shapes:
        x = rng.normal(size=(rows, cols)).astype(np.float32)
        if data == "ties":
            x = np.round(x * 2) / 2
        elif data == "shared_top_digit":
            x = np.sign(x) * (1 + rng.uniform(0, 2 ** -4, size=x.shape))
            x = x.astype(np.float32)
        elif data == "zeros_and_tiny":
            x = np.where(rng.uniform(size=x.shape) < 0.5, x * 1e-40, 0.0)
            x[0, ::3] = -0.0
            x = x.astype(np.float32)
        xs.append(torch.from_numpy(x).to(DTYPES[dtype][1]))
    for frac in (0.0, 0.1, 0.67, 1.0):
        ks = [max(1, int(np.ceil(frac * c))) for _, c in shapes]
        want = [topk.threshold_plain(x, k) for x, k in zip(xs, ks)]
        for chunk in (16, 256, topk.CHUNK):
            got = _emulate_select(xs, ks, chunk)
            for g, w in zip(got, want):
                assert np.array_equal(_bits(g), _bits(w))


# --- K5 over a list of leaves (``topk_mask_many``) -------------------------

def _mask_shapes():
    """Leaves whose rows start 16 bytes apart and not (D * itemsize % 16
    != 0 in f32, bf16 or both), more than MAX_LEAVES of them."""
    return ([(10, d) for d in MANY_SIZES] * 2
            + [(3, 1), (7, 17), (2, 33), (5, 4097), (4, 6), (1, 70000)])


def _vector_span(x_addr, out_addr, start, stop, itemsize):
    """(body, end): the elements ``[body, end)`` of a chunk ``[start,
    stop)`` that K5 moves 16 bytes at a time, as ``topk_mask_kernel``
    computes them: whole vectors from the first 16-byte boundary,
    ``x_addr`` and ``out_addr`` the addresses of element ``start``; none
    (``stop, stop``) where x and out are not congruent modulo 16 bytes.
    The rest is the scalar head and tail."""
    if (x_addr ^ out_addr) & 15:
        return stop, stop
    vec = 16 // itemsize
    body = min(stop, start + (-x_addr % 16) // itemsize)
    return body, body + (stop - body) // vec * vec


@pytest.mark.parametrize("chunk", [None, 1024])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_mask_plans_cover_every_element_once(itemsize, chunk):
    """Every element of every row is in exactly one block's chunk, which
    never crosses a row; inside a chunk the vector span starts on a 16-byte
    boundary and holds whole vectors, the scalar head and tail less than
    one vector each, where x and out are congruent modulo 16 bytes (rows
    at any D); at a view of storage offset 1 (out freshly allocated) the
    whole chunk is scalar. Lists longer than MAX_LEAVES split."""
    vec = 16 // itemsize
    shapes = _mask_shapes()
    plans = topk.mask_plans(shapes, itemsize, sms=132, chunk=chunk)
    assert [len(p.index) for p in plans] == [
        min(topk.MAX_LEAVES, len(shapes) - i)
        for i in range(0, len(shapes), topk.MAX_LEAVES)]
    assert sorted(i for p in plans for i in p.index) == list(
        range(len(shapes)))
    for offset in (0, 1):   # x's storage offset in elements; out aligned
        for plan in plans:
            assert plan.chunk % vec == 0
            assert chunk is None or plan.chunk == chunk
            seen = {i: np.zeros(shapes[i], np.int32) for i in plan.index}
            vectors = 0
            for block in range(plan.blocks):
                i, row, start, stop = topk.chunk_span(plan, block)
                cols = shapes[i][1]
                assert 0 <= row < shapes[i][0]
                assert 0 <= start < stop <= cols and start % plan.chunk == 0
                at = row * cols + start
                x_addr = 4096 * (i + 1) + (offset + at) * itemsize
                out_addr = 8192 * (i + 1) + at * itemsize
                body, end = _vector_span(x_addr, out_addr, start, stop,
                                         itemsize)
                assert start <= body <= end <= stop
                if offset:
                    assert body == end == stop
                    continue
                assert body - start < vec and stop - end < vec
                assert (end - body) % vec == 0
                if end > body:
                    assert (x_addr + (body - start) * itemsize) % 16 == 0
                vectors += (end - body) // vec
                seen[i][row, start:stop] += 1
            if not offset:
                assert all(np.all(s == 1) for s in seen.values())
                assert vectors > 0
    with pytest.raises(ValueError, match="multiple of"):
        topk.mask_plans(shapes, itemsize, 132, chunk=vec + 1)


def test_mask_plans_fill_the_card():
    """The chunk: the CIFAR tree ([10, D] f32) makes at least 4 blocks an
    SM of 132; a tree of full-width LM leaves keeps MASK_CHUNK; none is
    below one 16-byte vector a thread."""
    cifar = [(10, d) for d in CIFAR_SIZES]
    plan, = topk.mask_plans(cifar, 4, sms=132)
    assert plan.blocks >= 4 * 132
    assert topk.mask_plans(cifar, 4, sms=1000)[0].chunk < topk.MASK_CHUNK
    lm = [(4, 151936 * 2048), (4, 2048 * 6144), (4, 2048)]
    for itemsize in (2, 4):
        plan, = topk.mask_plans(lm, itemsize, sms=132)
        assert plan.chunk == topk.MASK_CHUNK
        plan, = topk.mask_plans([(1, 10)], itemsize, sms=132)
        assert plan.chunk == topk.MASK_THREADS * 16 // itemsize
        assert plan.blocks == 1
    with pytest.raises(ValueError, match="power of 2"):
        build.fill_chunk(lm, 3000, 1024, 132)


def _mask_words(x, t):
    """K5's compare on the 32-bit words of a 16-byte vector, in numpy: an
    f32 value a word, or two bf16 values (low half first), each kept where
    |v| >= t (v widened to f32 by a shift) and else +0."""
    def magnitude(bits32):
        return np.abs(bits32.astype(np.uint32).view(np.float32))

    if x.dtype == torch.float32:
        w = x.numpy().view(np.uint32)
        return np.where(magnitude(w) >= np.float32(t), w, 0).view(np.float32)
    w = x.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    w = (w[0::2] | (w[1::2] << 16)).astype(np.uint32)
    tf = np.float32(float(t))
    lo = np.where(magnitude(w << 16) >= tf, w & 0xFFFF, 0)
    hi = np.where(magnitude(w & 0xFFFF0000) >= tf, w & 0xFFFF0000, 0)
    out = (lo | hi).astype(np.uint32)
    halves = np.stack([out & 0xFFFF, out >> 16], axis=1).reshape(-1)
    return halves.astype(np.uint16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mask_word_emulation_matches_plain(dtype):
    """The kernel's word-wise compare (``mask_word``) in numpy is bitwise
    ``mask_plain`` on a row with -0.0, NaN, +-inf, ties at the threshold,
    denormals, and at t = 0 (-0.0 kept), t = inf, a NaN threshold and
    negative thresholds (-0.5, -inf: every value but NaN kept, the
    threshold compared with its sign)."""
    tdt = DTYPES[dtype][1]
    row = np.random.default_rng(2).normal(size=64).astype(np.float32)
    row[:12] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 0.5, -0.5,
                0.5, 1e-40, -1e-40, 2.0]
    x = torch.from_numpy(row).to(tdt)
    for t in (0.5, 0.0, -0.0, float("inf"), float("nan"), 1e-40, 3.0,
              -0.5, float("-inf")):
        thresh = torch.tensor([t]).to(tdt)
        want = topk.mask_plain(x[None], thresh)[0]
        got = _mask_words(x, thresh[0])
        if tdt == torch.float32:
            assert np.array_equal(got.view(np.uint32),
                                  want.numpy().view(np.uint32)), t
        else:
            assert np.array_equal(got, want.view(torch.int16).numpy().view(
                np.uint16)), t


def test_mask_many_matches_per_leaf_and_rejects_bad_lists():
    """One call over a list of f32 leaves (ties, a zero and a -0.0 row) is
    bitwise the per-leaf calls; unequal lists, a mixed dtype and a
    threshold of the wrong shape or dtype raise."""
    leaves = [t for _, t in _leaf_list("float32", "ties", seed=4)]
    threshs = ops.topk_threshold_many(leaves, [max(1, x.shape[1] // 3)
                                               for x in leaves])
    got = ops.topk_mask_many(leaves, threshs)
    for x, t, g in zip(leaves, threshs, got):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert np.array_equal(_bits(g), _bits(ops.topk_mask(x, t)))
        assert np.array_equal(_bits(g), _bits(topk.mask_plain(x, t)))
    x, t = leaves[0], threshs[0]
    with pytest.raises(ValueError, match="2 leaves and 1 thresholds"):
        ops.topk_mask_many([x, x], [t])
    with pytest.raises(ValueError, match="0 leaves"):
        ops.topk_mask_many([], [])
    with pytest.raises(TypeError, match="leaves of"):
        ops.topk_mask_many([x, x.bfloat16()], [t, t.bfloat16()])
    with pytest.raises(ValueError, match="thresh"):
        ops.topk_mask_many([x, x], [t, t[:2]])
    with pytest.raises(ValueError, match="thresh"):
        ops.topk_mask_many([x], [t[:, None]])
    with pytest.raises(ValueError, match="thresh"):
        ops.topk_mask_many([x], [t.bfloat16()])


def test_topk_per_node_many_is_per_leaf_and_reference(monkeypatch):
    """TopK over a tree of f32 and bf16 leaves: ``per_node_many`` is
    bitwise ``per_node`` leaf by leaf and, through ``compress_tree``, the
    reference's ``compress_tree``; it makes one K4 and one K5 call per
    dtype, the leaves in the order given."""
    rng = np.random.default_rng(8)
    shapes = {"a": (6, 5), "b": (300,), "c": (4, 7, 3), "d": (33,),
              "e": (1,)}
    dtypes = {"a": "float32", "b": "bfloat16", "c": "float32",
              "d": "bfloat16", "e": "float32"}
    raw = {k: np.round(rng.normal(size=s).astype(np.float32) * 4) / 4
           for k, s in shapes.items()}
    tree = {k: _pair(v, dtypes[k])[1] for k, v in raw.items()}
    jtree = {k: _pair(v, dtypes[k])[0] for k, v in raw.items()}
    comp = compression.make_compressor("top_k", frac=0.3)
    jcomp = jcompression.make_compressor("top_k", frac=0.3)
    calls = []
    for name in ("topk_threshold_many", "topk_mask_many"):
        real = getattr(ops, name)

        def counted(xs, other, _real=real, _name=name):
            calls.append((_name, [x.dtype for x in xs]))
            return _real(xs, other)
        monkeypatch.setattr(ops, name, counted)
    stacked = [v.reshape(1, -1) for v in tree.values()]
    got = comp.per_node_many(stacked, [None] * len(stacked))
    f32, bf16 = [torch.float32] * 3, [torch.bfloat16] * 2
    assert calls == [("topk_threshold_many", f32), ("topk_mask_many", f32),
                     ("topk_threshold_many", bf16), ("topk_mask_many", bf16)]
    for x, g in zip(stacked, got):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert np.array_equal(_bits(g), _bits(comp.per_node(x)))
    out = compression.compress_tree(comp, tree)
    want = jcompression.compress_tree(jcomp, jtree, None)
    for k in tree:
        assert out[k].shape == tree[k].shape
        assert np.array_equal(_bits(out[k]), _bits(want[k])), k
