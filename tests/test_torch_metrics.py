"""The port's copy of the numpy consensus analytics equals the reference's
on every topology family (same float64 numpy arithmetic: exact)."""
import numpy as np
import pytest

from repro.core import metrics as jmetrics
from repro.core import topology as jtopology
from repro_torch.core import metrics, topology

TOPOLOGIES = {"ring10": ("ring", (10,)), "full6": ("fully_connected", (6,)),
              "torus": ("torus", (3, 4)), "hypercube": ("hypercube", (3,)),
              "star7": ("star", (7,)), "quasi": ("paper_quasi_ring", ()),
              "disconnected": ("disconnected", (4,))}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_metrics_equal_reference(name):
    fn, args = TOPOLOGIES[name]
    topo, jtopo = getattr(topology, fn)(*args), getattr(jtopology, fn)(*args)
    for node in (0, topo.num_nodes - 1):
        np.testing.assert_array_equal(
            metrics.coefficient_variance_trajectory(topo, node, 12),
            jmetrics.coefficient_variance_trajectory(jtopo, node, 12))
    np.testing.assert_array_equal(
        metrics.consensus_error_trajectory(topo, 12),
        jmetrics.consensus_error_trajectory(jtopo, 12))
    for eps in (1e-1, 1e-2, 1e-6):
        assert metrics.rounds_to_consensus(topo, eps) == \
            jmetrics.rounds_to_consensus(jtopo, eps)


def test_metrics_exports():
    assert set(metrics.__all__) == set(jmetrics.__all__)
