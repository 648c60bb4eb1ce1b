"""The port's placement rules (``repro_torch.launch.sharding``) and meshes
(``launch.mesh``) against the reference's ``repro.launch.sharding``.

Both packages' ``spec_for_param`` see the same FakeMesh (the reference's
own ``tests/test_sharding.py`` stand-in) and must give equal specs, entry
by entry (the port's tuple against the reference's ``PartitionSpec``),
for every leaf of all ten configs, full and reduced, in both modes
(``gossip-dp`` and ``gossip-fsdp``, whatever the config's own), on the
one-pod and the two-pod production meshes, with and without the node
dim (its size the mode's node count, ``num_nodes_for``); each side reads
its own package's logical axes. ``node_axes_for``, ``num_nodes_for`` and
``batch_spec`` are held the same way, the ten cases of
``tests/test_sharding.py`` are run on the port, and ``shard_leaf`` /
``place_blocks`` put a leaf back together bit for bit on meshes where
dims divide and where they do not (those stay whole).
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _key_of
from repro.configs import REGISTRY as JREGISTRY
from repro.launch import sharding as JS
from repro.models import init_params as jinit_params
from repro_torch.configs import REGISTRY
from repro_torch.core.sharded import block_spans, place_blocks, spec_axes
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models import init_params

MODES = ("gossip-dp", "gossip-fsdp")


class FakeMesh:
    """Just enough of a Mesh for spec_for_param (the reference test's)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"1pod": {"data": 16, "model": 16},
          "2pod": {"pod": 2, "data": 16, "model": 16}}


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _reference_leaves(cfg):
    """{name: (logical axes, shape)} of the reference's abstract init."""
    params, axes = jinit_params(cfg, jax.random.key(0), abstract=True)
    shapes = {_key_of(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    names = {_key_of(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=_is_axes)[0]}
    return {k: (names[k], shapes[k]) for k in shapes}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_leaf_is_placed_as_the_reference_places_it(arch, size, mode,
                                                         mesh_name):
    fake = FakeMesh(MESHES[mesh_name])
    jcfg = getattr(JREGISTRY[arch], "model" if size == "full" else "reduced")
    cfg = getattr(REGISTRY[arch], "model" if size == "full" else "reduced")
    ref = _reference_leaves(jcfg)
    params, axes = init_params(cfg, None, "meta", abstract=True)
    assert set(params) == set(ref)
    n = S.num_nodes_for(mode, fake, REGISTRY[arch].fsdp_nodes)
    assert n == JS.num_nodes_for(mode, fake, JREGISTRY[arch].fsdp_nodes)
    for name, leaf in params.items():
        jaxes, jshape = ref[name]
        assert axes[name] == jaxes and tuple(leaf.shape) == jshape, name
        for node_dim in (True, False):
            shape = ((n,) if node_dim else ()) + jshape
            got = S.spec_for_param(axes[name], shape, mode, fake, node_dim)
            want = JS.spec_for_param(jaxes, shape, mode, fake, node_dim)
            assert got == tuple(want), (name, node_dim)
    specs = S.params_specs(axes, params, mode, fake, node_dim=False)
    assert specs == {k: tuple(JS.spec_for_param(ref[k][0], ref[k][1], mode,
                                                fake, False))
                     for k in params}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_node_axes_node_counts_and_batch_specs(mode, mesh_name, monkeypatch):
    """The reference's ``batch_sharding`` wraps its spec in a
    ``NamedSharding``, which a FakeMesh cannot carry: the spec is read
    through a stand-in."""
    fake = FakeMesh(MESHES[mesh_name])
    assert S.node_axes_for(mode, fake) == JS.node_axes_for(mode, fake)
    for fsdp_nodes in (1, 2, 4):
        assert (S.num_nodes_for(mode, fake, fsdp_nodes)
                == JS.num_nodes_for(mode, fake, fsdp_nodes))
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    for tau in (True, False):
        want = JS.batch_sharding(fake, mode, has_tau_dim=tau)
        assert S.batch_spec(fake, mode, has_tau_dim=tau) == tuple(want)
    with pytest.raises(ValueError):
        S.node_axes_for("bogus", fake)


def test_production_meshes_are_the_reference_layouts():
    one, two = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert one.shape == MESHES["1pod"] and one.axis_names == ("data", "model")
    assert two.shape == MESHES["2pod"]
    assert two.axis_names == ("pod", "data", "model")
    assert one.rank is None and one.size == 256 and two.size == 512
    # row-major like jax.make_mesh: the last axis fastest
    assert two.coords_of(1) == {"pod": 0, "data": 0, "model": 1}
    assert two.coords_of(16) == {"pod": 0, "data": 1, "model": 0}
    assert two.coords_of(256) == {"pod": 1, "data": 0, "model": 0}
    assert all(two.rank_of(two.coords_of(r)) == r for r in range(512))
    assert two.members(("data",), 17) == [1 + 16 * d for d in range(16)]


# the ten cases of tests/test_sharding.py, on the port

MESH_1POD = FakeMesh(MESHES["1pod"])
MESH_2POD = FakeMesh(MESHES["2pod"])


@pytest.mark.parametrize("case", [
    (("layers", "embed", "mlp"), (16, 36, 4096, 12288), "gossip-dp",
     MESH_1POD, True, ("data", None, None, "model")),
    (("layers", "embed", "mlp"), (4, 36, 4096, 12288), "gossip-fsdp",
     MESH_1POD, True, (None, None, "data", "model")),
    (("layers", "experts", "embed", "mlp"), (4, 32, 16, 4096, 6400),
     "gossip-fsdp", MESH_1POD, True, (None, None, "model", "data", None)),
    (("embed", "heads", None), (7168, 56, 128), "gossip-dp", MESH_1POD,
     False, (None, None, None)),
    (("embed", None, "head_dim"), (7168, 56, 128), "gossip-dp", MESH_1POD,
     False, (None, None, "model")),
    (("embed",), (32, 4096), "gossip-dp", MESH_2POD, True,
     (("pod", "data"), None)),
    (("vocab", "embed"), (151936, 4096), "gossip-dp", MESH_1POD, False,
     ("model", None)),
    (("vocab", "embed"), (151936, 4096), "gossip-fsdp", MESH_1POD, False,
     ("model", "data")),
], ids=["dp_mlp_weight", "fsdp_mlp_weight_2d_sharded",
        "expert_dim_wins_model_axis", "non_divisible_head_dim_replicated",
        "head_dim_mode", "node_dim_spec_multipod", "vocab_dp", "vocab_fsdp"])
def test_reference_spec_cases_on_the_port(case):
    axes, shape, mode, mesh, node_dim, want = case
    assert S.spec_for_param(axes, shape, mode, mesh, node_dim) == want


def test_reference_multipod_node_axes_and_node_counts_on_the_port():
    assert S.node_axes_for("gossip-dp", MESH_2POD) == ("pod", "data")
    assert S.node_axes_for("gossip-fsdp", MESH_2POD) == ("pod",)
    assert S.node_axes_for("gossip-fsdp", MESH_1POD) == ()
    assert S.num_nodes_for("gossip-dp", MESH_1POD, 4) == 16
    assert S.num_nodes_for("gossip-dp", MESH_2POD, 4) == 32
    assert S.num_nodes_for("gossip-fsdp", MESH_1POD, 4) == 4
    assert S.num_nodes_for("gossip-fsdp", MESH_2POD, 4) == 2


@pytest.mark.parametrize("shape,axes", [
    ((4, 2, 24, 40), ("layers", "embed", "mlp")),
    ((4, 2, 25, 40), ("layers", "embed", "mlp")),     # embed stays whole
    ((4, 6, 8, 3, 4), ("layers", "embed", None, "head_dim")),
    ((4, 12), ("embed",)),
])
@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (1, 4), (3, 1)])
def test_shard_and_place_round_trip(shape, axes, grid):
    """Every rank's ``shard_leaf`` block, put back by ``place_blocks`` from
    each rank's view, is the whole leaf bit for bit; a dim that does not
    divide by its axis stays whole; the blocks tile the leaf."""
    mesh = M.Mesh({"data": grid[0], "model": grid[1]})
    spec = S.spec_for_param(axes, shape, "gossip-fsdp", mesh, node_dim=True)
    whole = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    blocks = {r: S.shard_leaf(whole, spec, mesh, mesh.coords_of(r))
              for r in range(mesh.size)}
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            assert all(b.shape[i] == dim for b in blocks.values())
    seen = torch.zeros(shape, dtype=torch.int32)
    for r in range(mesh.size):
        view = seen
        for i, (start, size) in enumerate(block_spans(
                shape, spec, mesh, mesh.coords_of(r))):
            view = view.narrow(i, start, size)
        view += 1
        axes_ = spec_axes(spec, mesh)
        at = M.Mesh(mesh.shape, rank=r)
        got = place_blocks([blocks[m] for m in at.members(axes_)], spec, at,
                           axes_)
        assert torch.equal(got, whole)
    # each element is held by the ranks along the axes the spec leaves out
    copies = mesh.size // mesh.axes_size(spec_axes(spec, mesh))
    assert bool((seen == copies).all())


def test_host_mesh_without_a_group_is_one_rank():
    """Without a process group only the 1 x 1 mesh is made: a larger one
    raises instead of being cut to one rank."""
    for data, model in ((4, 4), (2, 1), (1, 2)):
        with pytest.raises(ValueError, match="initialised process group"):
            M.make_host_mesh(data, model)
    mesh = M.make_host_mesh(1, 1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.coords == {"data": 0, "model": 0}
    assert mesh.group_of(("data", "model")) == (None, 1)


# the reference's ``tests/test_engine_guard.py`` cases on the port's
# ``select_engine``, over groupless meshes: (engine, topology, mesh shape,
# mode) -> the engine picked
ENGINE_CASES = [
    ("auto", "ring4", {"data": 4, "model": 2}, "gossip-dp", "dense"),
    ("auto", "ring8", {"data": 8, "model": 1}, "gossip-dp", "sparse"),
    ("auto", "ring8", {"data": 8}, "gossip-dp", "sparse"),
    ("dense", "ring4", {"data": 4, "model": 2}, "gossip-dp", "dense"),
    ("sparse", "ring4", {"data": 4, "model": 2}, "gossip-dp", "sparse"),
    ("auto", "star8", {"data": 8}, "gossip-dp", "dense"),
    ("auto", "ring8", {"data": 8}, "gossip-fsdp", "dense"),
    ("auto", "ring4", {"data": 2, "model": 2}, "gossip-fsdp", "dense"),
]


@pytest.mark.parametrize("engine,topo,shape,mode,want", ENGINE_CASES)
def test_select_engine_cases_of_the_reference(engine, topo, shape, mode,
                                              want):
    from repro_torch.core import topology
    from repro_torch.core.dfl import DFLConfig
    from repro_torch.launch.steps import select_engine
    make = {"ring": topology.ring, "star": topology.star}[topo[:4]]
    dcfg = DFLConfig(tau1=2, tau2=1, topology=make(int(topo[4:])))
    assert select_engine(engine, dcfg, M.Mesh(shape), mode) == want


def test_dfl_setup_of_deepseek_coder_on_a_mesh():
    """gossip-fsdp on one pod: the config's ``fsdp_nodes`` replicated nodes
    on a ring, whatever the mesh's size."""
    from repro_torch.launch.steps import dfl_setup
    arch = REGISTRY["deepseek-coder-33b"]
    for shape in ({"data": 2, "model": 2}, {"data": 16, "model": 16}):
        mode, n, dcfg = dfl_setup(arch, M.Mesh(shape), tau1=1, tau2=2,
                                  compression=None)
        assert (mode, n) == ("gossip-fsdp", 4) and arch.fsdp_nodes == 4
        assert dcfg.topology.name == "ring-4"
        assert (dcfg.tau1, dcfg.tau2) == (1, 2)
