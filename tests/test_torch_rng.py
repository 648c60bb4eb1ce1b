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
