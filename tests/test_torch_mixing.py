"""The port's dense mixing primitives against the reference's.

``masked_mixing_matrix`` is bitwise ``topology.mixing`` at all-ones masks
(in f32 and f64) and within 1e-7 of the reference under random masks;
``mix_dense(edge_mask=)`` and ``mix_dense_power`` take the reference's
own inputs and are held to rtol 1e-6 (one f32 contraction over the node
axis, summed in another order); ``mix_dense_power`` also against tau2
iterated ``mix_dense`` steps, rtol 1e-5. ``mixing_bytes_per_step`` is
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmixing
from repro.core import topology as jtopology
from repro_torch.core import mixing, topology

TOPOLOGIES = {"ring8": ("ring", (8,)), "full5": ("fully_connected", (5,)),
              "torus": ("torus", (2, 3)), "star6": ("star", (6,)),
              "quasi": ("paper_quasi_ring", ())}


def both(name):
    fn, args = TOPOLOGIES[name]
    return getattr(topology, fn)(*args), getattr(jtopology, fn)(*args)


def tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(n,)).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_masked_mixing_matrix(name):
    topo, jtopo = both(name)
    e = topo.num_edges
    for dtype in (torch.float32, torch.float64):
        ones = mixing.masked_mixing_matrix(
            topo, torch.ones(e, dtype=torch.int32), dtype)
        want = torch.as_tensor(topo.mixing, dtype=dtype)
        assert ones.dtype == dtype and torch.equal(ones, want)
    rng = np.random.default_rng(1)
    for _ in range(4):
        mask = rng.integers(0, 2, size=e).astype(np.int32)
        got = mixing.masked_mixing_matrix(topo, torch.from_numpy(mask),
                                          torch.float32).numpy()
        ref = np.asarray(jmixing.masked_mixing_matrix(
            jtopo, jnp.asarray(mask), jnp.float32))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
        np.testing.assert_allclose(got.sum(axis=0), 1.0, atol=1e-6)
        np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_mix_dense_with_edge_mask(name):
    topo, jtopo = both(name)
    n, e = topo.num_nodes, topo.num_edges
    x = tree(n)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    plain = mixing.mix_dense(tx, topo)
    at_ones = mixing.mix_dense(tx, topo, torch.ones(e, dtype=torch.int32))
    for k in x:
        assert torch.equal(plain[k], at_ones[k])
    mask = np.random.default_rng(2).integers(0, 2, size=e).astype(np.int32)
    got = mixing.mix_dense(tx, topo, torch.from_numpy(mask))
    want = jmixing.mix_dense({k: jnp.asarray(v) for k, v in x.items()}, jtopo,
                             jnp.asarray(mask))
    for k in x:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("tau2", [0, 1, 4])
def test_mix_dense_power(name, tau2):
    topo, jtopo = both(name)
    x = tree(topo.num_nodes, seed=3)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    got = mixing.mix_dense_power(tx, topo, tau2)
    want = jmixing.mix_dense_power({k: jnp.asarray(v) for k, v in x.items()},
                                   jtopo, tau2)
    it = tx
    for _ in range(tau2):
        it = mixing.mix_dense(it, topo)
    for k in x:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[k].numpy(), it[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_mixing_bytes_per_step():
    for name in TOPOLOGIES:
        topo, jtopo = both(name)
        for sparse in (True, False):
            assert mixing.mixing_bytes_per_step(topo, 1234, sparse) == \
                jmixing.mixing_bytes_per_step(jtopo, 1234, sparse)
