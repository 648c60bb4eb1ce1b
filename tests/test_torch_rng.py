"""The port's RNG seam (``repro_torch.core.rng``): a draw depends on
(seed, round, step, leaf) only, never on the order of calls, and the
replaying seam returns what it was given."""
import numpy as np
import pytest
import torch

from repro_torch.core.rng import GeneratorDraws, ReplayDraws

LEAVES = ("d1", "b1", "c1")
KEYS = [(r, t, leaf) for r in range(3) for t in range(2) for leaf in LEAVES]


def _draws(seed=3, leaves=LEAVES):
    return GeneratorDraws(seed, 4, leaves, device="cpu")


def test_a_draw_depends_only_on_its_indices():
    first = {k: _draws().uniform(*k, (50,)) for k in KEYS}
    same = _draws()
    for k in reversed(KEYS):          # another order, one object
        assert torch.equal(same.uniform(*k, (50,)), first[k])
    for k in KEYS[::3]:               # repeated
        assert torch.equal(same.uniform(*k, (50,)), first[k])
    # the leaf index is the name's place in sorted order
    shuffled = _draws(leaves=sorted(LEAVES, reverse=True))
    assert torch.equal(shuffled.uniform(*KEYS[4], (50,)), first[KEYS[4]])
    # every index moves the draw: round, step, leaf and seed
    flat = torch.stack([v for v in first.values()])
    assert len({tuple(v.flatten()[:4].tolist()) for v in flat}) == len(KEYS)
    assert not torch.equal(_draws(seed=4).uniform(*KEYS[0], (50,)),
                           first[KEYS[0]])


def test_draws_are_float32_uniforms_of_the_asked_shape():
    d = _draws()
    u = d.uniform(0, 0, "c1", (3, 7))
    assert u.shape == (4, 3, 7) and u.dtype == torch.float32
    assert u.device == torch.device("cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert d.uniform(1, 1, "b1", ()).shape == (4,)
    big = d.uniform(2, 0, "d1", (20000,))
    assert abs(float(big.mean()) - 0.5) < 0.01
    with pytest.raises(ValueError):
        d.uniform(0, 0, "no-such-leaf", (3,))


def test_replay_returns_its_table():
    table = {(0, 1, "a"): np.arange(8, dtype=np.float64).reshape(4, 2) / 8}
    r = ReplayDraws(table, device="cpu")
    got = r.uniform(0, 1, "a", (2,))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), table[(0, 1, "a")].astype(np.float32))
    with pytest.raises(KeyError, match="no replayed draw"):
        r.uniform(1, 1, "a", (2,))
    with pytest.raises(ValueError, match="shape"):
        r.uniform(0, 1, "a", (3,))


def test_node_ids_all_nodes_equals_the_default_bitwise():
    d = _draws()
    for key in KEYS[:6]:
        for shape in ((50,), (), (3, 7)):
            want = d.uniform(*key, shape)
            for ids in (np.arange(4), [0, 1, 2, 3], torch.arange(4)):
                got = d.uniform(*key, shape, node_ids=ids)
                assert got.shape == want.shape
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))


def test_a_row_depends_only_on_its_node_id():
    """Row j is node_ids[j]'s row whatever else was asked for: any subset,
    any order, a single node; and another id gives another row."""
    d = GeneratorDraws(5, 1000, LEAVES, device="cpu")
    full = d.uniform(2, 1, "c1", (64,), node_ids=np.arange(20))
    for ids in ([7], [19, 3, 7], [0, 11, 12, 13]):
        got = d.uniform(2, 1, "c1", (64,), node_ids=ids)
        assert got.shape == (len(ids), 64)
        assert torch.equal(got, full[ids])
    far = d.uniform(2, 1, "c1", (64,), node_ids=[999, 3])
    assert torch.equal(far[1], full[3])
    assert len({tuple(r[:4].tolist()) for r in full}) == 20
    assert d.uniform(0, 0, "b1", (5,), node_ids=[]).shape == (0, 5)
    with pytest.raises(ValueError, match="node ids"):
        d.uniform(0, 0, "b1", (5,), node_ids=[1000])


def test_replay_picks_rows_by_node_id():
    table = {(0, 0, "a"): np.arange(12, dtype=np.float32).reshape(4, 3)}
    r = ReplayDraws(table, device="cpu")
    assert r.uniform(0, 0, "a", (3,), node_ids=[2, 0]).tolist() == [
        [6.0, 7.0, 8.0], [0.0, 1.0, 2.0]]
    assert torch.equal(r.uniform(0, 0, "a", (3,), node_ids=np.arange(4)),
                       r.uniform(0, 0, "a", (3,)))


@pytest.mark.parametrize("name,kw", [("qsgd", {"levels": 4}),
                                     ("rand_k", {"frac": 0.5}),
                                     ("rand_gossip", {"p": 0.6})])
def test_a_substrate_holding_some_nodes_draws_theirs(name, kw):
    """``compress`` on a substrate that holds nodes [9, 2] of 12 (leaves
    [2, ...]) uses exactly those nodes' rows of the draws, so it equals
    rows 9 and 2 of the same compression over all 12 nodes."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.substrate import BatchedSubstrate, DenseSubstrate
    from repro_torch.core.topology import ring

    comp = make_compressor(name, **kw)
    rng = np.random.default_rng(0)
    tree = {"c1": torch.from_numpy(rng.normal(size=(12, 6, 5)).astype(
        np.float32)), "b1": torch.from_numpy(rng.normal(size=(12, 9)).astype(
            np.float32))}
    d = GeneratorDraws(1, 12, tree, device="cpu")
    every = DenseSubstrate(ring(12)).compress(comp, tree, d, 3, 1)
    ids = [9, 2]
    some = BatchedSubstrate(ring(2), 12, ids)
    got = some.compress(comp, {k: v[ids] for k, v in tree.items()}, d, 3, 1)
    for k in tree:
        assert torch.equal(got[k], every[k][ids])


def _splitmix64_reference(seed, round_idx, step, leaf_index, ids, numel):
    """SplitMix64 in numpy uint64, written out from its definition: the key
    folded over (seed, round, step) plus the leaf's offset splitmix64(leaf
    index), then the generator's output at counter ``id * 2**32 + e``, its
    top 24 bits over 2**24."""
    gamma, m1, m2 = (np.uint64(0x9E3779B97F4A7C15),
                     np.uint64(0xBF58476D1CE4E5B9),
                     np.uint64(0x94D049BB133111EB))

    def mix(z):
        z = (z ^ (z >> np.uint64(30))) * m1
        z = (z ^ (z >> np.uint64(27))) * m2
        return z ^ (z >> np.uint64(31))

    with np.errstate(over="ignore"):
        key = np.uint64(0)
        for v in (seed, round_idx, step):
            key = mix((key ^ np.uint64(v)) + gamma)
        key = key + mix(np.uint64(leaf_index) + gamma)
        ctr = ((np.asarray(ids, np.uint64)[:, None] << np.uint64(32))
               + np.arange(numel, dtype=np.uint64)[None, :])
        z = mix(key + gamma * ctr)
    return (z >> np.uint64(40)).astype(np.float32) * np.float32(2.0 ** -24)


@pytest.mark.parametrize("ids,shape", [(None, (50,)), ([999, 3, 0], (6, 7)),
                                       ([5], ())])
def test_draws_are_splitmix64_at_their_counters(ids, shape):
    """The seam's bits are SplitMix64's, from integer arithmetic alone, so
    the CPU and the card give the same draws."""
    d = GeneratorDraws(11, 1000, LEAVES, device="cpu")
    got = d.uniform(4, 2, "d1", shape, node_ids=ids)
    rows = np.arange(1000) if ids is None else ids
    want = _splitmix64_reference(11, 4, 2, sorted(LEAVES).index("d1"), rows,
                                 int(np.prod(shape)))
    assert got.shape == (len(rows), *shape)
    assert np.array_equal(got.numpy().reshape(len(rows), -1), want)


def test_a_cohort_per_round_keeps_a_bounded_cache():
    """Each (id set, leaves, sizes) builds its counters once; a cohort that
    changes every round does not grow the cache past its bound, and a
    rebuilt entry draws the same bits."""
    d = GeneratorDraws(0, 100, LEAVES, device="cpu")
    first = d.uniform(0, 0, "b1", (4,), node_ids=[1, 2])
    for r in range(3 * GeneratorDraws._KEEP_BASES):
        d.uniform(r, 0, "b1", (4,), node_ids=[r % 100, (r + 7) % 100])
    assert len(d._bases) <= GeneratorDraws._KEEP_BASES
    assert torch.equal(d.uniform(0, 0, "b1", (4,), node_ids=[1, 2]), first)


def test_a_step_drawn_at_once_is_bitwise_its_leaves_one_by_one():
    """``uniform_many`` over a step's leaves (any order, any subset of
    nodes) is bitwise ``uniform`` leaf by leaf, each block contiguous."""
    d = GeneratorDraws(2, 30, LEAVES, device="cpu")
    shapes = {"d1": (40,), "b1": (), "c1": (3, 5)}
    for ids in (None, [29, 4, 17]):
        for order in (list(shapes), sorted(shapes, reverse=True)):
            got = d.uniform_many(6, 1, order, [shapes[k] for k in order], ids)
            for leaf, u in zip(order, got):
                want = GeneratorDraws(2, 30, LEAVES, device="cpu").uniform(
                    6, 1, leaf, shapes[leaf], ids)
                assert u.is_contiguous() and torch.equal(u, want)
    replay = ReplayDraws({(0, 0, "a"): np.ones((4, 2)),
                          (0, 0, "b"): np.zeros((4, 3))}, device="cpu")
    a, b = replay.uniform_many(0, 0, ["a", "b"], [(2,), (3,)], [1, 3])
    assert a.shape == (2, 2) and b.shape == (2, 3)


@pytest.mark.parametrize("block_max", [1, 37, 1000])
def test_a_large_step_drawn_in_chunks_is_bitwise_the_one_block(
        monkeypatch, block_max):
    """A step of more than ``BLOCK_MAX`` elements (an LM tree) is drawn leaf
    by leaf and chunk by chunk from the same counters: bitwise the one
    cached block, for every node, for an id set, and under a device key
    (``KeyedDraws``), with path-keyed leaves in the reference's order."""
    names = ["embed", "blocks/10/w", "blocks/2/w", "final_norm"]
    shapes = [(7, 5), (13,), (1000,), (3, 11)]
    g = GeneratorDraws(5, 4, names, "cpu")
    assert g.leaves == ("blocks/2/w", "blocks/10/w", "embed", "final_norm")
    want = g.uniform_many(3, 1, names, shapes)
    want_ids = g.uniform_many(3, 1, names, shapes, node_ids=[3, 0])
    cached = list(g._bases)
    monkeypatch.setattr(GeneratorDraws, "BLOCK_MAX", block_max)
    got = g.uniform_many(3, 1, names, shapes)
    got_ids = g.uniform_many(3, 1, names, shapes, node_ids=[3, 0])
    keyed = g.keyed(torch.tensor(g.step_key(3, 1))).uniform_many(
        0, 0, names, shapes)
    for a, b, c, d, e in zip(want, got, keyed, want_ids, got_ids):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(d, e)
    assert list(g._bases) == cached     # the chunked path caches nothing
