"""The DFL / C-DFL algorithm on stacked per-node tensors: the names of
``repro.core`` that the port has."""
from repro_torch.core.topology import (
    Topology,
    ring,
    quasi_ring,
    paper_quasi_ring,
    fully_connected,
    disconnected,
    torus,
    hypercube,
    star,
    from_adjacency,
    zeta,
    beta,
    spectral_gap,
)
from repro_torch.core.compression import (
    Compressor,
    Identity,
    TopK,
    RandK,
    QSGD,
    RandomizedGossip,
    make_compressor,
    compress_tree,
    tree_wire_bits,
)
from repro_torch.core.dfl import (
    DFLConfig,
    DFLState,
    d_sgd_config,
    c_sgd_config,
    sync_sgd_config,
    replicate,
    average_model,
    consensus_distance,
    init_state,
    make_round_fn,
    round_wire_bits,
    sparse_engine_eligible,
)
from repro_torch.core.executor import (
    HostPrefetcher,
    MetricsBuffer,
    RoundExecutor,
    stack_round_batches,
)
from repro_torch.core.substrate import (BatchedSubstrate, DenseSubstrate,
                                        NodeSubstrate, ShardedSubstrate)
from repro_torch.core.sharded import NodeGroup
from repro_torch.core import mixing, metrics, sharded, substrate

__all__ = [
    "Topology", "ring", "quasi_ring", "paper_quasi_ring", "fully_connected",
    "disconnected", "torus", "hypercube", "star", "from_adjacency", "zeta",
    "beta", "spectral_gap",
    "Compressor", "Identity", "TopK", "RandK", "QSGD", "RandomizedGossip",
    "make_compressor", "compress_tree", "tree_wire_bits",
    "DFLConfig", "DFLState", "d_sgd_config", "c_sgd_config",
    "sync_sgd_config", "replicate", "average_model", "consensus_distance",
    "init_state", "make_round_fn", "round_wire_bits",
    "sparse_engine_eligible",
    "RoundExecutor", "HostPrefetcher", "MetricsBuffer",
    "stack_round_batches",
    "NodeSubstrate", "DenseSubstrate", "BatchedSubstrate",
    "ShardedSubstrate", "NodeGroup",
    "mixing", "metrics", "sharded", "substrate",
]
