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
from repro.core import substrate as jsubstrate
from repro.core import topology as jtopology
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.registry import PARITY_SHAPES
from repro_torch.core import compression, topology
from repro_torch.core.rng import GeneratorDraws, ReplayDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.kernels import ops, qsgd
from repro_torch.models.cnn import init_cnn

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


# --- K6 over every leaf of a tree (qsgd_quantize_many) ----------------------

CIFAR_SHAPES = {k: tuple(v.shape) for k, v in
                init_cnn(torch.Generator().manual_seed(0), "cifar",
                         "cpu").items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("levels", [4, 16])
def test_qsgd_many_matches_plain_per_leaf_and_reference(dtype, levels):
    """One call over a tree of the parity shapes (each [N, D], row 1 of
    every leaf zero): bitwise the plain version and the one-leaf call per
    leaf, and within the reference kernel's tolerance of the reference's
    Pallas kernel in interpret mode, both sides taking the reference's
    norm."""
    tree = [_inputs(shape, dtype, seed=i + levels)
            for i, shape in enumerate(PARITY_SHAPES)]
    norms = [torch.from_numpy(np.array(
        [float(jnp.linalg.norm(xj[i].reshape(-1).astype(jnp.float32)))
         for i in range(N)], np.float32)) for xj, _, _, _ in tree]
    cs = [_c(xt.shape[1], levels) for _, xt, _, _ in tree]
    got = ops.qsgd_quantize_many([xt for _, xt, _, _ in tree],
                                 [nt for _, _, _, nt in tree], norms, levels,
                                 cs)
    assert len(got) == len(tree)
    for (xj, xt, noise, nt), norm, c, g in zip(tree, norms, cs, got):
        assert g.dtype == xt.dtype and g.shape == xt.shape
        assert not g[1].any()
        for want in (qsgd.plain(xt, nt, norm, levels, qsgd.scale(levels, c)),
                     ops.qsgd_quantize(xt, nt, norm, levels, c)):
            assert np.array_equal(_bits(g), _bits(want))
        for i in range(N):
            want = jops.qsgd_quantize(xj[i], jnp.asarray(noise[i]),
                                      levels=levels, interpret=True)
            np.testing.assert_allclose(_f32(g[i]), _f32(want).reshape(-1),
                                       rtol=TOL[dtype], atol=TOL[dtype])


def _bits(a):
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(
        jnp.asarray(a).astype(jnp.float32)))
    return a.contiguous().view(torch.int32 if a.dtype == torch.float32
                               else torch.int16).numpy()


@pytest.mark.parametrize("chunk", [8, 64, qsgd.CHUNK])
def test_quantize_plans_cover_every_element_once(chunk):
    """Block by block, as the kernel reads the plan: every element of every
    leaf is in exactly one chunk, no chunk crosses a row, trees of more
    than MAX_LEAVES leaves take further launches, and quantizing chunk by
    chunk gives the plain version's bits for the whole leaf. The leaves
    are the parity and CIFAR sizes up to 64 chunks a row, a few sizes
    around a vector, and one of more rows than a blockIdx.y grid holds."""
    cols = [d for d in [int(np.prod(s)) for s in PARITY_SHAPES + tuple(
        CIFAR_SHAPES.values())] if d <= 64 * chunk] + [1, 7, 8, 9]
    shapes = [(r, d) for r, d in zip([1, 2, 3] * 30, cols * 4)]
    shapes.append((65537, 3))
    plans = qsgd.quantize_plans(shapes, chunk)
    assert len(shapes) > qsgd.MAX_LEAVES
    assert [len(p.index) for p in plans] == [
        min(qsgd.MAX_LEAVES, len(shapes) - i)
        for i in range(0, len(shapes), qsgd.MAX_LEAVES)]
    assert [i for p in plans for i in p.index] == list(range(len(shapes)))
    for plan in plans:
        seen = {i: np.zeros(shapes[i], np.int32) for i in plan.index}
        for block in range(plan.blocks):
            i, row, start, stop = qsgd.chunk_span(plan, block)
            assert 0 <= row < shapes[i][0]
            assert 0 <= start < stop <= shapes[i][1] and start % chunk == 0
            assert stop - start <= chunk
            seen[i][row, start:stop] += 1
        assert all(np.all(s == 1) for s in seen.values())
    # the plain version chunk by chunk, each with its row's norm
    rng = np.random.default_rng(chunk)
    small = [(3, 1000), (2, 4800), (1, 10), (4, 33)]
    plan, = qsgd.quantize_plans(small, chunk)
    leaves = [tuple(torch.from_numpy(a) for a in (
        rng.normal(size=shape).astype(np.float32),
        rng.uniform(size=shape).astype(np.float32),
        rng.uniform(1, 2, size=shape[0]).astype(np.float32)))
        for shape in small]
    scs = [qsgd.scale(16, _c(d, 16)) for _, d in small]
    outs = [torch.full(shape, float("nan")) for shape in small]
    for block in range(plan.blocks):
        i, row, start, stop = qsgd.chunk_span(plan, block)
        x, noise, norm = leaves[i]
        outs[i][row:row + 1, start:stop] = qsgd.plain(
            x[row:row + 1, start:stop], noise[row:row + 1, start:stop],
            norm[row:row + 1], 16, scs[i])
    for (x, noise, norm), sc, out in zip(leaves, scs, outs):
        want = qsgd.plain(x, noise, norm, 16, sc)
        assert np.array_equal(_bits(out), _bits(want))
    with pytest.raises(ValueError, match="multiple of 8"):
        qsgd.quantize_plans(shapes, 12)
    with pytest.raises(ValueError, match="launch grid"):
        qsgd.quantize_plans([(2 ** 20, 2 ** 24)], 8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_packed_plan_takes_the_vector_path_only_on_aligned_rows(dtype):
    """The kernel's plan struct, packed from the operands: each slot's
    pointers, sc and chunks, and the 16-byte path only where every row of
    x, noise and out starts 16-byte aligned (f32 D % 4 == 0, bf16 D % 8
    == 0, a 16-byte aligned base), so every vector chunk starts aligned
    and holds whole vectors."""
    tdt = DTYPES[dtype][1]
    per_vec = 16 // torch.empty(0, dtype=tdt).element_size()
    cols = [10, 12, 16, 64, 1000, 4800, 32768, 32769, 21000]
    xs = [torch.zeros(3, d, dtype=tdt) for d in cols]
    # a view whose base is 4 bytes past the buffer's start
    xs.append(torch.zeros(3 * 64 + 2, dtype=tdt)[2:].view(3, 64))
    noises = [torch.zeros(x.shape) for x in xs]
    norms = [torch.ones(3) for _ in xs]
    outs = [torch.empty_like(x) for x in xs]
    scs = [qsgd.scale(16, _c(x.shape[1], 16)) for x in xs]
    size = {t: torch.empty(0, dtype=t).element_size()
            for t in (tdt, torch.float32)}
    for plan in qsgd.quantize_plans([tuple(x.shape) for x in xs], 64):
        c = qsgd.pack_plan(plan, xs, noises, norms, 16.0, scs, outs)
        assert (c.num_leaves, c.chunk, c.s) == (len(plan.index), 64, 16.0)
        for slot, i in enumerate(plan.index):
            leaf = c.leaf[slot]
            assert (leaf.x, leaf.noise, leaf.norm, leaf.out) == tuple(
                t.data_ptr() for t in (xs[i], noises[i], norms[i], outs[i]))
            assert leaf.cols == xs[i].shape[1]
            assert leaf.sc == np.float32(scs[i])
            assert (leaf.chunk_begin, leaf.chunks_per_row) == (
                plan.chunk_begin[slot], plan.chunks_per_row[slot])
            aligned = (xs[i].data_ptr() % 16 == 0
                       and xs[i].shape[1] % per_vec == 0)
            assert leaf.vec == int(aligned)
        for block in range(plan.blocks):
            i, row, start, stop = qsgd.chunk_span(plan, block)
            slot = plan.index.index(i)
            if not c.leaf[slot].vec:
                continue
            assert (stop - start) % per_vec == 0
            off = row * xs[i].shape[1] + start
            for ptr, t in ((c.leaf[slot].x, tdt), (c.leaf[slot].out, tdt),
                           (c.leaf[slot].noise, torch.float32)):
                assert (ptr + off * size[t]) % 16 == 0


def _replayed_qsgd(n, levels, seed, round_idx, step):
    """A stacked CIFAR-shaped tree (f32, node 1 of leaf b1 zero), the
    reference's per-node keys for one gossip step, and those keys' QSGD
    draws as the seam's table: (tree, node keys, table)."""
    rng = np.random.default_rng(seed)
    tree = {k: (rng.normal(size=(n,) + s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in CIFAR_SHAPES.items()}
    tree["b1"][1] = 0.0
    keys = jsubstrate.DenseSubstrate(jtopology.ring(n)).node_keys(
        jax.random.fold_in(jax.random.key(seed), step))
    names = sorted(tree)
    table = {(round_idx, step, leaf): np.stack([np.asarray(jax.random.uniform(
        jax.random.split(keys[i], len(names))[j],
        (int(np.prod(CIFAR_SHAPES[leaf])),))) for i in range(n)])
        for j, leaf in enumerate(names)}
    return tree, keys, table


def _count_calls(monkeypatch, name):
    calls = []
    inner = getattr(ops, name)

    def counted(*args):
        calls.append(len(args[0]))
        return inner(*args)

    monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("levels", [4, 16])
def test_compress_hooks_match_reference_compress_tree(levels, monkeypatch):
    """The substrate's ``compress`` on a stacked CIFAR-shaped tree and
    ``compress_tree`` on one node's tree, with the reference's draws
    replayed, against the reference's ``compress_tree`` with QSGD node by
    node (the compressor tolerance), each in one ``qsgd_quantize_many``
    call for the whole tree (the 10 leaves)."""
    n = 3
    tree, keys, table = _replayed_qsgd(n, levels, seed=levels, round_idx=2,
                                       step=1)
    jcomp = jcompression.make_compressor("qsgd", levels=levels)
    comp = compression.make_compressor("qsgd", levels=levels)
    want = [jcompression.compress_tree(
        jcomp, {k: jnp.asarray(v[i]) for k, v in tree.items()}, keys[i])
        for i in range(n)]
    calls = _count_calls(monkeypatch, "qsgd_quantize_many")
    got = DenseSubstrate(topology.ring(n)).compress(
        comp, {k: torch.from_numpy(v) for k, v in tree.items()},
        ReplayDraws(table, device="cpu"), 2, 1)
    assert calls == [len(tree)]
    one = compression.compress_tree(
        comp, {k: torch.from_numpy(v[0]) for k, v in tree.items()},
        {leaf: torch.from_numpy(table[(2, 1, leaf)][0]) for leaf in tree})
    assert calls == [len(tree)] * 2
    assert list(got) == list(one) == list(tree)
    for k in tree:
        assert got[k].shape == tree[k].shape and one[k].shape == tree[k][0].shape
        for i in range(n):
            np.testing.assert_allclose(_f32(got[k][i]), _f32(want[i][k]),
                                       rtol=TOL["float32"],
                                       atol=TOL["float32"])
        assert np.array_equal(_bits(one[k]), _bits(got[k][0]))
    assert not got["b1"][1].any()


@pytest.mark.parametrize("name,kw", [("top_k", {"frac": 0.67}),
                                     ("rand_k", {"frac": 0.67}),
                                     ("rand_gossip", {"p": 0.6}),
                                     ("identity", {})])
def test_compress_goes_leaf_by_leaf_for_other_compressors(name, kw,
                                                          monkeypatch):
    """Every compressor but QSGD: ``compress`` is ``per_node`` on each
    leaf with its draws from the seam, bitwise, and never reaches K6."""
    n = 3
    rng = np.random.default_rng(4)
    tree = {k: torch.from_numpy(rng.normal(size=(n,) + s).astype(np.float32))
            for k, s in (("a", (5, 5, 3, 8)), ("b", (8,)), ("c", (100, 10)))}
    comp = compression.make_compressor(name, **kw)
    draws = GeneratorDraws(7, n, tree, device="cpu")
    calls = _count_calls(monkeypatch, "qsgd_quantize_many")
    got = DenseSubstrate(topology.ring(n)).compress(comp, tree, draws, 3, 2)
    assert calls == []
    for k, v in tree.items():
        want = comp.per_node(v, comp.draw(draws, 3, 2, k, v[0].numel()))
        assert np.array_equal(_bits(got[k]), _bits(want))


def test_compress_takes_a_tree_of_mixed_dtypes_one_call_per_dtype(
        monkeypatch):
    """A tree of f32 and bf16 leaves: ``compress`` and ``compress_tree``
    make one ``qsgd_quantize_many`` call for each dtype, in the order the
    dtypes first appear, and each leaf is bitwise its own ``per_node``."""
    n = 3
    rng = np.random.default_rng(9)
    tree = {k: torch.from_numpy(rng.normal(size=(n,) + s).astype(np.float32))
            for k, s in (("a", (5, 5, 3, 8)), ("b", (8,)), ("c", (100, 10)),
                         ("d", (33,)))}
    tree["b"], tree["d"] = tree["b"].bfloat16(), tree["d"].bfloat16()
    comp = compression.make_compressor("qsgd", levels=4)
    draws = GeneratorDraws(5, n, tree, device="cpu")
    calls = _count_calls(monkeypatch, "qsgd_quantize_many")
    got = DenseSubstrate(topology.ring(n)).compress(comp, tree, draws, 1, 0)
    assert calls == [2, 2]
    one = compression.compress_tree(
        comp, {k: v[1] for k, v in tree.items()},
        {k: comp.draw(draws, 1, 0, k, v[0].numel())[1]
         for k, v in tree.items()})
    assert calls == [2, 2] * 2
    for k, v in tree.items():
        want = comp.per_node(v, comp.draw(draws, 1, 0, k, v[0].numel()))
        assert got[k].dtype == one[k].dtype == v.dtype
        assert np.array_equal(_bits(got[k]), _bits(want))
        assert np.array_equal(_bits(one[k]), _bits(want[1]))


@pytest.mark.parametrize("case", ["empty", "lengths", "dtypes", "noise_shape",
                                  "noise_dtype", "norm_length", "norm_dtype",
                                  "devices"])
def test_qsgd_many_rejects_bad_trees(case):
    x, noise, norm = torch.zeros(2, 8), torch.zeros(2, 8), torch.ones(2)
    xs, noises, norms, cs = [x, x], [noise, noise], [norm, norm], [1.5, 1.5]
    error, match = ValueError, None
    if case == "empty":
        xs = noises = norms = cs = []
        match = "0 leaves"
    elif case == "lengths":
        cs, match = [1.5], "1 c values"
    elif case == "dtypes":
        xs, error, match = [x, x.bfloat16()], TypeError, "leaves of"
    elif case == "noise_shape":
        noises, match = [noise, torch.zeros(2, 9)], "noise"
    elif case == "noise_dtype":
        noises, error, match = [noise, noise.double()], TypeError, "noise"
    elif case == "norm_length":
        norms, match = [norm, torch.ones(3)], "norm"
    elif case == "norm_dtype":
        norms, match = [norm, norm.double()], "norm"
    else:
        xs, match = [x, torch.zeros(2, 8, device="meta")], "devices"
    with pytest.raises(error, match=match):
        ops.qsgd_quantize_many(xs, noises, norms, 16, cs)
