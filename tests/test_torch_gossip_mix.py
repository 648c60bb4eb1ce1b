"""K1 gossip_mix in the PyTorch port against the JAX reference.

The port's plain version (what ``repro_torch.kernels.ops.gossip_mix`` runs
on CPU tensors) is held against the reference's Pallas kernel in interpret
mode and against the reference ``mix_dense``, and the received-buffer
form's (``ops.gossip_mix_received_many``, the sparse engine's) bitwise
against the reference's oracle ``ref.gossip_mix_ref``; the kernel itself is held
against the plain version on the card by ``chip_smoke.py``. Tolerance:
1e-5 in f32 and 1e-2 in bf16 (the reference's gossip contract; the two
frameworks may order or contract the f32 accumulation differently).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmixing
from repro.core import topology as jtopology
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.registry import PARITY_SHAPES
from repro_torch.core import mixing, topology
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.kernels import gossip_mix as mix_module
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _stacked(n, shape, seed):
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(
        np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_kernel_and_mix_dense(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    topo = topology.ring(4)
    nbr, w = mixing.gossip_table(topo)
    x = _stacked(4, shape, seed=len(shape) * 1000 + int(np.prod(shape)))
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    got = ops.gossip_mix(xt.reshape(4, -1), torch.from_numpy(nbr),
                         torch.from_numpy(w)).reshape(xt.shape)
    for i in range(4):
        want = jops.gossip_mix(xj[i], xj[nbr[i]], jnp.asarray(w[i]),
                               interpret=True)
        np.testing.assert_allclose(_f32(got[i]), _f32(want), rtol=tol,
                                   atol=tol)
    dense = jmixing.mix_dense({"x": xj}, jtopology.ring(4))["x"]
    np.testing.assert_allclose(_f32(got), _f32(dense), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["ring10", "quasi", "full5", "ring2"])
def test_substrate_mix_matches_reference_mix_dense(name):
    """The kernel table reproduces mix_dense's out[i] = sum_j C[j,i] x[j];
    non-circulant C (the paper's quasi-ring) runs mix_dense itself."""
    make = {"ring10": lambda m: m.ring(10),
            "quasi": lambda m: m.paper_quasi_ring(),
            "full5": lambda m: m.fully_connected(5),
            "ring2": lambda m: m.ring(2)}[name]
    topo, jtopo = make(topology), make(jtopology)
    n = topo.num_nodes
    assert topo.is_shift_structured() == jtopo.is_shift_structured()
    tree = {"a": _stacked(n, (3, 5, 7), seed=1), "b": _stacked(n, (64,), 2)}
    got = DenseSubstrate(topo).mix(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    want = jmixing.mix_dense({k: jnp.asarray(v) for k, v in tree.items()},
                             jtopo)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    ours = mixing.mix_dense({k: torch.from_numpy(v) for k, v in tree.items()},
                            topo)
    for k in tree:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_gossip_table_follows_shifts():
    topo = topology.ring(10)
    nbr, w = mixing.gossip_table(topo)
    assert nbr.shape == (10, 2) and w.shape == (10, 3)
    assert nbr.dtype == np.int32 and w.dtype == np.float32
    c = topo.mixing
    for i in range(10):
        assert w[i, 0] == np.float32(c[i, i])
        for k in range(2):
            assert w[i, k + 1] == np.float32(c[nbr[i, k], i])
    with pytest.raises(ValueError, match="not circulant"):
        mixing.gossip_table(topology.paper_quasi_ring())
    # C = I: circulant with no shifts, so the kernel runs with deg = 0
    nbr, w = mixing.gossip_table(topology.disconnected(3))
    assert nbr.shape == (3, 0) and np.all(w == 1.0)


def test_plain_keeps_accumulation_order():
    """The plain version is the kernel's arithmetic: separate f32 mul and
    add in the order self, neighbour 0, neighbour 1 (the kernel avoids fma
    so the two agree bitwise on the card)."""
    x = torch.from_numpy(_stacked(3, (257,), seed=3))
    nbr = torch.tensor([[1, 2], [2, 0], [0, 1]], dtype=torch.int32)
    w = torch.tensor([[0.5, 0.25, 0.25], [0.2, 0.3, 0.5], [1 / 3] * 3],
                     dtype=torch.float32)
    got = mix_module.plain(x, nbr, w)
    xs = x.numpy()
    for i in range(3):
        acc = w[i, 0].numpy() * xs[i]
        for k in range(2):
            acc = acc + w[i, k + 1].numpy() * xs[nbr[i, k]]
        assert np.array_equal(got[i].numpy().view(np.uint32),
                              acc.astype(np.float32).view(np.uint32))


def test_masked_shift_weights_matches_reference():
    shifts = jtopology.ring(6).shifts()
    for masks in ([1, 1], [0, 1], [0, 0]):
        jw = jmixing.masked_shift_weights(
            shifts, 1 / 3, [jnp.asarray(m) for m in masks])
        tw = mixing.masked_shift_weights(
            shifts, 1 / 3, [torch.tensor(m) for m in masks])
        assert np.float32(jw[0]) == tw[0].numpy()
        for a, b in zip(jw[1], tw[1]):
            assert np.float32(a) == b.numpy()


def test_gossip_copies_per_step_matches_reference():
    for make in (lambda m: m.ring(10), lambda m: m.paper_quasi_ring(),
                 lambda m: m.fully_connected(4)):
        for engine in ("sparse", "dense", "auto"):
            assert mixing.gossip_copies_per_step(make(topology), engine) == \
                jmixing.gossip_copies_per_step(make(jtopology), engine)


def test_wrapper_rejects_bad_operands():
    x = torch.zeros(4, 8)
    nbr, w = (torch.from_numpy(a) for a in mixing.gossip_table(
        topology.ring(4)))
    with pytest.raises(TypeError, match="dtype"):
        ops.gossip_mix(x.double(), nbr, w)
    with pytest.raises(ValueError, match="nbr"):
        ops.gossip_mix(x, nbr.long(), w)
    with pytest.raises(ValueError, match="w must"):
        ops.gossip_mix(x, nbr, w[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_mix(torch.zeros(8, 4).t(), nbr, w)
    with pytest.raises(ValueError, match=r"\[rows, cols\]"):
        ops.gossip_mix(torch.zeros(4), nbr, w)


# --- K1 over every leaf of a tree (gossip_mix_many) -------------------------

CIFAR_SIZES = (4800, 64, 102400, 64, 393216, 384, 73728, 192, 1920, 10)
MANY_SIZES = CIFAR_SIZES + (64, 1000, 32768, 32769, 21000)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mix_many_matches_reference_and_per_leaf(dtype):
    """One call over the CIFAR CNN's leaves and the parity sizes equals the
    per-leaf calls and the plain version bitwise, and the reference's
    kernel in interpret mode within the gossip tolerance."""
    jdt, tdt, tol = DTYPES[dtype]
    topo = topology.ring(4)
    nbr, w = mixing.gossip_table(topo)
    nbr_t, w_t = torch.from_numpy(nbr), torch.from_numpy(w)
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(4, d)).astype(np.float32) for d in MANY_SIZES]
    xts = [torch.from_numpy(x).to(tdt) for x in xs]
    got = ops.gossip_mix_many(xts, nbr_t, w_t)
    assert len(got) == len(xs)
    for x, xt, g in zip(xs, xts, got):
        assert g.shape == xt.shape and g.dtype == tdt
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        for want in (ops.gossip_mix(xt, nbr_t, w_t),
                     mix_module.plain(xt, nbr_t, w_t)):
            assert torch.equal(g.view(bits), want.view(bits))
        xj = jnp.asarray(x).astype(jdt)
        want = jops.gossip_mix(xj[0], xj[nbr[0]], jnp.asarray(w[0]),
                               interpret=True)
        np.testing.assert_allclose(_f32(g[0]), _f32(want), rtol=tol, atol=tol)


def test_mix_many_rejects_bad_trees():
    nbr, w = (torch.from_numpy(a) for a in mixing.gossip_table(
        topology.ring(4)))
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="no leaves"):
        ops.gossip_mix_many([], nbr, w)
    with pytest.raises(ValueError, match="share dtype and rows"):
        ops.gossip_mix_many([x, torch.zeros(5, 8)], nbr, w)
    with pytest.raises(ValueError, match="share dtype and rows"):
        ops.gossip_mix_many([x, x.bfloat16()], nbr, w)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_mix_plans_cover_every_column_once(itemsize):
    """Every column of every leaf is in exactly one block's tile; the tile
    is a whole number of 16-byte vectors and its [N, tile] slab fits the
    shared memory, for N up to MAX_ROWS; beyond it the plan raises."""
    cols = list(MANY_SIZES) * 3 + [1, 3, 17]
    vec = 16 // itemsize
    for rows in (2, 10, 64, 1000, 1024, mix_module.MAX_ROWS):
        plans = mix_module.mix_plans(cols, rows, itemsize)
        assert [len(p.index) for p in plans] == [
            min(mix_module.MAX_LEAVES, len(cols) - i)
            for i in range(0, len(cols), mix_module.MAX_LEAVES)]
        for plan in plans:
            assert plan.tile % vec == 0 and plan.tile >= vec
            assert plan.tile <= mix_module.TILE_MAX
            assert rows * plan.tile * itemsize <= mix_module.SLAB_BYTES
            seen = {i: np.zeros(cols[i], np.int32) for i in plan.index}
            for block in range(plan.blocks):
                i, c0, c1 = mix_module.tile_span(plan, block)
                assert 0 <= c0 < c1 <= cols[i] and c0 % plan.tile == 0
                seen[i][c0:c1] += 1
            assert all(np.all(s == 1) for s in seen.values())
    assert mix_module.tile_width(10, 4) == mix_module.TILE_MAX
    with pytest.raises(ValueError, match="exceed"):
        mix_module.mix_plans(cols, mix_module.MAX_ROWS + 1,
                                    itemsize)


def test_substrate_makes_one_call_per_step(monkeypatch):
    """DenseSubstrate.mix hands every leaf to one gossip_mix_many call, and
    the TopK choco_step every leaf's gap to one topk_threshold_many call."""
    from repro_torch.core.compression import make_compressor

    calls = {"gossip_mix_many": 0, "topk_threshold_many": 0}
    for name in calls:
        inner = getattr(ops, name)

        def counted(*args, _inner=inner, _name=name):
            calls[_name] += 1
            return _inner(*args)

        monkeypatch.setattr(ops, name, counted)
    sub = DenseSubstrate(topology.ring(10))
    rng = np.random.default_rng(3)
    tree = {k: torch.from_numpy(rng.normal(size=(10,) + s).astype(np.float32))
            for k, s in (("a", (5, 5, 3, 64)), ("b", (64,)), ("c", (1000,)))}
    mixed = sub.mix(tree)
    assert calls == {"gossip_mix_many": 1, "topk_threshold_many": 0}
    y = {k: 0.5 * v for k, v in tree.items()}
    sub.choco_step(make_compressor("top_k", frac=0.67), tree, y, mixed, 0.6)
    assert calls == {"gossip_mix_many": 1, "topk_threshold_many": 1}


# --- K1's received-buffer form (the sparse engine's step) ------------------

def _received(shape, deg, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    recv = rng.normal(size=(deg,) + shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, deg + 1).astype(np.float32)
    return x, recv, w / w.sum()


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_received_plain_matches_reference(shape, dtype):
    """The received form's plain version, at deg 1, 2 and 7: bitwise the
    reference's oracle ``ref.gossip_mix_ref`` (the same separate f32 mul
    and add, in the same order); at deg 2 (the ring's) against its Pallas
    kernel in interpret mode within 1e-5 in f32 and 1e-2 in bf16 (jitted,
    XLA contracts the accumulation into fma: up to an ulp of the f32 sum);
    and bitwise the dense K1's plain version at the same weights in the
    same order."""
    jdt, tdt, tol = DTYPES[dtype]
    for deg in (1, 2, 7):
        x, recv, w = _received(shape, deg, seed=deg + int(np.prod(shape)))
        xj, rj = (jnp.asarray(a).astype(jdt) for a in (x, recv))
        xt = torch.from_numpy(x).to(tdt).reshape(1, -1)
        rt = torch.from_numpy(recv).to(tdt).reshape(deg, -1)
        wt = torch.from_numpy(w)
        got = ops.gossip_mix_received(xt, rt, wt)
        assert got.shape == xt.shape and got.dtype == tdt
        want = jref.gossip_mix_ref(xj, rj, jnp.asarray(w))
        assert np.array_equal(_f32(got).reshape(shape), _f32(want)), deg
        if deg == 2:    # one compile of the interpret-mode kernel a case
            kernel = jops.gossip_mix(xj, rj, jnp.asarray(w), interpret=True)
            np.testing.assert_allclose(_f32(got).reshape(shape),
                                       _f32(kernel), rtol=tol, atol=tol)
        # the dense K1 over [x; recv] with node 0 reading rows 1..deg
        stacked = torch.cat([xt, rt])
        nbr = torch.arange(1, deg + 1, dtype=torch.int32)[None].repeat(
            deg + 1, 1)
        dense = mix_module.plain(stacked, nbr, wt[None].repeat(deg + 1, 1))
        assert torch.equal(dense[:1].view(torch.int16 if dtype == "bfloat16"
                                          else torch.int32),
                           got.view(torch.int16 if dtype == "bfloat16"
                                    else torch.int32))


def test_received_many_matches_per_leaf_and_rejects_bad_operands():
    """One call over a tree (leaves [D] and [1, D], received rows at any
    row stride) is the per-leaf calls bitwise, deg 0 keeps ``w[0] x``; the
    wrapper refuses what the kernel does not take."""
    xs = [torch.randn(1, 33), torch.randn(64), torch.randn(1, 1000)]
    buf = torch.randn(2, 1200)     # rows of a packed exchange buffer
    recvs = [buf[:, :33], buf[:, 48:112], buf[:, 112:1112]]
    w = torch.tensor([0.5, 0.3, 0.2])
    got = ops.gossip_mix_received_many(xs, recvs, w)
    for x, r, g in zip(xs, recvs, got):
        assert torch.equal(g, ops.gossip_mix_received(x, r, w))
        assert g.shape == x.shape
    assert torch.equal(ops.gossip_mix_received(
        xs[0], torch.empty(0, 33), torch.tensor([1.0])), xs[0])
    with pytest.raises(ValueError, match="received buffers must be"):
        ops.gossip_mix_received(xs[0], buf[:, :34], w)
    with pytest.raises(ValueError, match="contiguous rows"):
        ops.gossip_mix_received(xs[0], torch.randn(33, 2).t(), w)
    with pytest.raises(ValueError, match="w must be"):
        ops.gossip_mix_received(xs[0], recvs[0], w[:2])
    with pytest.raises(ValueError, match=r"\[D\] or \[1, D\]"):
        ops.gossip_mix_received(torch.randn(2, 33), recvs[0], w)
    with pytest.raises(TypeError, match="share one of"):
        ops.gossip_mix_received_many([xs[0], xs[1].bfloat16()],
                                     recvs[:2], w)
    with pytest.raises(ValueError, match="2 leaves and 1"):
        ops.gossip_mix_received_many(xs[:2], recvs[:1], w)


def test_received_plans_cover_every_column_once():
    """Every column of every leaf is in exactly one block's chunk, at most
    MAX_LEAVES leaves a launch, the chunk a multiple of one 16-byte vector
    a thread in f32 and bf16, between that and RECV_CHUNK; on 132 SMs one
    CIFAR node (f32) makes at least 4 blocks an SM, and one node of the
    full-width Qwen3-1.7B tree keeps the chunk at RECV_CHUNK."""
    cols = list(MANY_SIZES) * 3 + [1, 3, 17, mix_module.RECV_CHUNK + 1]
    for itemsize in (4, 2):
        floor = mix_module.RECV_THREADS * 16 // itemsize
        plans = mix_module.received_plans(cols, itemsize, sms=132)
        assert [len(p.index) for p in plans] == [
            min(mix_module.MAX_LEAVES, len(cols) - i)
            for i in range(0, len(cols), mix_module.MAX_LEAVES)]
        for plan in plans:
            assert plan.tile % floor == 0
            assert floor <= plan.tile <= mix_module.RECV_CHUNK
            seen = {i: np.zeros(cols[i], np.int32) for i in plan.index}
            for block in range(plan.blocks):
                i, c0, c1 = mix_module.tile_span(plan, block)
                assert 0 <= c0 < c1 <= cols[i] and c0 % plan.tile == 0
                seen[i][c0:c1] += 1
            assert all(np.all(s == 1) for s in seen.values())
    cifar, = mix_module.received_plans(list(CIFAR_SIZES), 4, sms=132)
    assert cifar.blocks >= 4 * 132
    from repro_torch.configs import REGISTRY
    from repro_torch.models import init_params
    cfg = dataclasses.replace(REGISTRY["qwen3-1.7b"].model, num_layers=2)
    lm = [int(np.prod(v.shape)) for v in init_params(
        cfg, None, "cpu", abstract=True)[0].values()]
    assert all(p.tile == mix_module.RECV_CHUNK
               for p in mix_module.received_plans(lm, 2, sms=132))
