"""Gossip-dp on a (data, model) mesh (``core.substrate.NodeMeshSubstrate``,
``core.sharded.ShardGroup.shift_exchange``, the gossip-dp branch of
``launch.steps``) against the reference's dense engine, the port's dense
engine and its sparse engine.

The multi-process cases run 8 gloo ranks on the CPU, once for the module
(``dp_session``), on a data 4 x model 2 mesh: reduced Qwen3-1.7B (2
layers, d 256, 4 / 2 heads of 32, vocab 512, f32), a node on each
``data`` coordinate (ring(4)), its leaves split over ``model`` as
``sharding.spec_for_param`` gives them, tau (1, 2), one round, batch 4 a
node (whole on both of the node's ranks), seq 16. Each rank writes its
blocks and readings; the tests put the leaves back together and hold
them:

* the rounds of plain DFL, TopK (frac 0.5) and QSGD (16 levels, the
  reference's own draws replayed through ``ReplayDraws``) against
  ``repro.core.dfl.make_round_fn``'s dense round on the same numpy
  weights and batches, at ``tests/test_torch_mesh.py``'s tolerances:
  plain DFL loss and consensus to rtol 1e-5 and every parameter to 1e-5
  absolute; C-DFL loss and consensus to rtol 1e-4, every parameter and
  estimate to 1e-4 absolute but for at most one flipped TopK selection or
  QSGD level in 1e4 elements of a leaf (eight in a run). Only the order
  of the sums differs from the dense engine (the norms and the consensus
  summed over ``model``, the means over ``data`` ranks);
* the same rounds against the port's dense round, with the same
  tolerances;
* K4's sharded-row form over ``model`` on every leaf's rows (ties, -0.0,
  k = 1, half and whole, f32 and bf16): bitwise the whole rows';
* one plain and one TopK ``build_gossip_step`` on the mesh for each of the
  six gossip-dp configs' reduced forms (their own dtypes), from distinct
  nodes, bitwise the dense port's step on the gathered tree;
* one gossip step over star(4), which is not circulant (every node's
  block gathered over ``data``, the dense product), within 1e-6 of the
  dense port's;
* the shift exchange's ``sends`` of each ``model`` coordinate against
  ``analysis.audits.expected_shift_pairs`` (``audit_collective_matching``,
  each pair once a gossip step), and its bytes;
* a data 8 x model 1 mesh on the same 8 ranks, ring(8): the round's state
  of plain DFL, TopK and QSGD bitwise the sparse engine's
  (``make_round_fn(engine="sparse")`` on the ranks' ``NodeGroup``), its
  loss and consensus to 1e-6 (the sums over ranks run in another order);
* ``build_local_step``, ``build_train_round`` (losses those of the dense
  ``build_train_round`` to rtol 1e-5) and ``roofline_cost_inputs`` on the
  mesh.

In one process: the misuse that raises (the 2-pod production mesh, which
has no process group; ``overlap="pipeline"``, ROADMAP item 18;
``dense_power``; ``node_chunk=``; a node dim not on ``data``), and a 1 x
1 mesh's rounds bitwise the dense port's.
"""
import dataclasses
import functools
import os
import shutil
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch.analysis.audits import (audit_collective_matching,
                                         expected_shift_pairs)
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.core import dfl, topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.rng import GeneratorDraws, ReplayDraws
from repro_torch.core.sharded import (ShardGroup, pack_layout, place_blocks,
                                      spawn, spec_axes)
from repro_torch.core.substrate import DenseSubstrate, NodeMeshSubstrate
from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
from repro_torch.kernels import ops, topk
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import init_params, train_loss
from repro_torch.optim import sgd

ARCH = "qwen3-1.7b"
DP_ARCHES = ("qwen3-1.7b", "qwen3-8b", "gemma3-4b", "granite-moe-1b-a400m",
             "falcon-mamba-7b", "seamless-m4t-medium")
N, TAU1, TAU2, B, S, LR, GAMMA, ROUNDS = 4, 1, 2, 4, 16, 3e-2, 0.1, 1
DATA, MODEL_AXIS = 4, 2
WIDE = 8                     # the data 8 x model 1 mesh on the same ranks
LABELS = {"dfl": None, "cdfl_topk": ("top_k", {"frac": 0.5}),
          "cdfl_qsgd": ("qsgd", {"levels": 16})}
RTOL, ATOL = 1e-5, 1e-5                  # plain DFL
CDFL_RTOL, CDFL_ATOL = 1e-4, 1e-4        # C-DFL
FLIPS_LEAF, FLIPS_RUN = 1e-4, 8
STAR_ATOL = 1e-6
SPARSE_RTOL = 1e-6
SPAWN_TIMEOUT_S = 300.0


def _model():
    return dataclasses.replace(REGISTRY[ARCH].reduced, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference (JAX) modules, imported in the test process only: the
    ranks import this module by name and start in torch's time."""
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY as JREGISTRY
    from repro.core import dfl as jdfl
    from repro.core import make_compressor as jmake_compressor
    from repro.core import ring as jring
    from repro.models import init_params as jinit_params
    from repro.models import train_loss as jtrain_loss
    from repro.optim import sgd as jsgd
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, dfl=jdfl, make_compressor=jmake_compressor,
        ring=jring, init_params=jinit_params, train_loss=jtrain_loss,
        sgd=jsgd, model=dataclasses.replace(JREGISTRY[ARCH].reduced,
                                            dtype=jnp.float32))


def _config(label, n=N):
    spec = LABELS[label]
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    topo = topology.ring(n) if n > 1 else topology.fully_connected(1)
    return dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo,
                         compression=comp, gamma=GAMMA)


def _loss(p, b):
    return train_loss(p, b, _model())


def _reference_draws(comp, rng, shapes):
    """The reference's dense-engine uniforms for every (round, step, leaf):
    node key fold_in(fold_in(comm key, t), i), leaf keys split over the
    reference's leaf order."""
    R = _ref()
    names = sorted(shapes)
    table = {}
    for r in range(ROUNDS):
        comm = R.dfl.round_keys(rng, r)[1]
        for t in range(TAU2):
            step = R.jax.random.fold_in(comm, t)
            keys = [R.jax.random.split(R.jax.random.fold_in(step, i),
                                       len(names)) for i in range(N)]
            for j, name in enumerate(names):
                shape = comp.draw_shape(int(np.prod(shapes[name])))
                table[(r, t, name)] = np.stack([np.asarray(
                    R.jax.random.uniform(keys[i][j], shape))
                    for i in range(N)])
    return table


@functools.lru_cache(maxsize=None)
def _inputs():
    """The reference's initial weights (flat numpy, the port's names), the
    rounds' batches of N and of ``WIDE`` nodes, and QSGD's draws."""
    R = _ref()
    p0 = R.init_params(R.model, R.jax.random.key(0))[0]
    flat = {k: v.numpy() for k, v in params_from_jax(
        R.jax.tree_util.tree_map(np.asarray, p0), "cpu").items()}
    batches = [lm_batches_for_dfl(SyntheticLM(vocab_size=R.model.vocab_size,
                                              num_nodes=n),
                                  TAU1, n, B, S, 0) for n in (N, WIDE)]
    table = _reference_draws(make_compressor("qsgd", levels=16),
                             R.jax.random.key(1),
                             {k: v.shape for k, v in flat.items()})
    return flat, batches[0], batches[1], table


def _draws(label, table):
    return (ReplayDraws(table, "cpu") if label == "cdfl_qsgd" else None)


def _specs(mesh, p0, n=N):
    _, axes = init_params(_model(), None, "meta", abstract=True)
    return {k: sharding.spec_for_param(axes[k], (n,) + v.shape, "gossip-dp",
                                       mesh, node_dim=True)
            for k, v in p0.items()}


def _stacked(p0, n):
    return {k: torch.from_numpy(v).unsqueeze(0).repeat((n,) + (1,) * v.ndim)
            for k, v in p0.items()}


def _node_rounds(mesh, label, p0, batch, draws, n=N):
    """One round of the mesh's gossip-dp substrate on this rank: its blocks
    of (params, hat), the metrics, and its group's exchange counters."""
    cfg = _config(label, n)
    specs = _specs(mesh, p0, n)
    sg = ShardGroup(mesh, "cpu")
    sub = NodeMeshSubstrate(cfg.topology, sg, specs,
                            {k: (n,) + v.shape for k, v in p0.items()})
    params = {k: sharding.shard_leaf(v, specs[k], mesh)
              for k, v in _stacked(p0, n).items()}
    state = dfl.init_state(params, n, sgd(LR), stacked=True,
                           compressed=cfg.is_compressed, draws=draws)
    round_fn = dfl.make_round_fn(cfg, _loss, sgd(LR), substrate=sub)
    bspec = sharding.batch_spec(mesh, "gossip-dp", has_tau_dim=True)
    mine = {k: sharding.shard_leaf(torch.from_numpy(v), bspec, mesh)
            for k, v in batch.items()}
    state, m = round_fn(state, mine)
    return (state.params, state.hat_params,
            {k: float(v) for k, v in m.items()},
            {"sends": dict(sg.sends), "bytes": sg.exchange_bytes,
             "packed": pack_layout(list(params.values()))[1]})


def _dense_rounds(label, p0, batch, table):
    cfg = _config(label)
    state = dfl.init_state({k: torch.from_numpy(v) for k, v in p0.items()},
                           N, sgd(LR), compressed=cfg.is_compressed,
                           draws=_draws(label, table))
    state, m = dfl.make_round_fn(cfg, _loss, sgd(LR))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state.params, state.hat_params, {k: float(v)
                                            for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _dense_port(label):
    p0, batch, _, table = _inputs()
    return _dense_rounds(label, p0, batch, table)


def _threshold_inputs(p0):
    """Rows of every leaf's shape with ties, zeros and -0.0, and their ks
    (1, half, whole)."""
    rng = np.random.default_rng(11)
    out = {}
    for i, (k, v) in enumerate(sorted(p0.items())):
        x = rng.normal(size=(N,) + v.shape).astype(np.float32)
        x.reshape(N, -1)[1, ::3] = 0.5      # ties
        x.reshape(N, -1)[2, ::5] = -0.0
        out[k] = (x, (1, max(1, v.size // 2), v.size)[i % 3])
    return out


def _gen():
    return torch.Generator().manual_seed(2)


def _distinct(params, seed):
    """Whole ``[N, ...]`` x and y = x / 2 of distinct nodes from one model's
    ``[1, ...]``-free weights: each node's copy moved by seeded noise."""
    gen = torch.Generator().manual_seed(seed)
    x = {k: (v.unsqueeze(0).float() + 0.05 * torch.randn(
        (N,) + tuple(v.shape), generator=gen)).to(v.dtype)
        for k, v in params.items()}
    return x, {k: (v.float() * 0.5).to(v.dtype) for k, v in x.items()}


@functools.lru_cache(maxsize=None)
def _arch_weights(arch_id):
    cfg = REGISTRY[arch_id].reduced
    return _distinct(init_params(cfg, _gen(), "cpu")[0], 7)


def _gossip_steps(mesh):
    """One plain and one TopK gossip step of each gossip-dp config's
    reduced form through ``build_gossip_step`` on the mesh, from distinct
    nodes: this rank's blocks of x (plain) and of (x, y) (TopK)."""
    out = {}
    for arch_id in DP_ARCHES:
        arch = REGISTRY[arch_id]
        x, y = _arch_weights(arch_id)
        for comp in (None, make_compressor("top_k", frac=0.5)):
            built = steps.build_gossip_step(
                arch, mesh, compression=comp, reduced=True, device="cpu",
                generator=_gen())
            specs = built.substrate.specs
            cut = lambda t: {k: sharding.shard_leaf(v, specs[k], mesh)  # noqa
                             for k, v in t.items()}
            built.args = (cut(x),) if comp is None else (cut(x), cut(y))
            got = built.run()
            out[(arch_id, comp is not None)] = (
                got if comp is not None else (got, None), specs)
    return out


def _star_step(mesh, p0):
    """One plain gossip step over star(4) on this rank's blocks of distinct
    nodes."""
    specs = _specs(mesh, p0)
    x, _ = _distinct({k: torch.from_numpy(v) for k, v in p0.items()}, 9)
    sub = NodeMeshSubstrate(topology.star(N), ShardGroup(mesh, "cpu"), specs,
                            {k: (N,) + v.shape for k, v in p0.items()})
    return sub.mix({k: sharding.shard_leaf(v, specs[k], mesh)
                    for k, v in x.items()})


def _wide_runs(group, p0, batch):
    """The data 8 x model 1 mesh's rounds and the sparse engine's on the
    ranks' ``NodeGroup``, ring(8), from the same weights, batches and seam:
    (params, hat, metrics) of each, per label."""
    mesh = make_host_mesh(WIDE, 1)
    out = {}
    for label in LABELS:
        mine = _node_rounds(mesh, label, p0, batch,
                            GeneratorDraws(1, WIDE, p0, "cpu"), n=WIDE)[:3]
        cfg = _config(label, WIDE)
        state = dfl.init_state(
            {k: v[group.rank:group.rank + 1]
             for k, v in _stacked(p0, WIDE).items()}, 1, sgd(LR),
            stacked=True, compressed=cfg.is_compressed,
            draws=GeneratorDraws(1, WIDE, p0, "cpu"))
        round_fn = dfl.make_round_fn(cfg, _loss, sgd(LR), engine="sparse",
                                     group=group)
        state, m = round_fn(state, {
            k: torch.from_numpy(v[:, group.rank:group.rank + 1])
            for k, v in batch.items()})
        out[label] = (mine, (state.params, state.hat_params,
                             {k: float(v) for k, v in m.items()}))
    return out


def _dp_rank(group, path, out_dir):
    """One rank of the session; writes ``rank<r>.pt``."""
    p0, batch, wide_batch, table = torch.load(path, weights_only=False)
    mesh = make_host_mesh(DATA, MODEL_AXIS)
    specs = _specs(mesh, p0)
    res = {"coords": mesh.coords, "rank": mesh.rank, "runs": {},
           "threshs": {}}
    for label in LABELS:
        res["runs"][label] = _node_rounds(mesh, label, p0, batch,
                                          _draws(label, table))
    sg = ShardGroup(mesh, "cpu")
    for name, (x, k) in _threshold_inputs(p0).items():
        for dt in (torch.float32, torch.bfloat16):
            part = sharding.shard_leaf(torch.from_numpy(x).to(dt),
                                       specs[name], mesh)
            span = sg.span(spec_axes(specs[name][1:], mesh))
            res["threshs"][(name, str(dt))] = ops.topk_threshold_sharded_many(
                [part.reshape(1, -1)], [k], span)[0]
    res["gossip"] = _gossip_steps(mesh)
    res["star"] = _star_step(mesh, p0)
    arch, cfg = REGISTRY[ARCH], _model()
    kw = dict(cfg=cfg, device="cpu")
    local = steps.build_local_step(arch, "train_4k", mesh, lr=LR, batch=B,
                                   seq=S, generator=_gen(), **kw)
    train = steps.build_train_round(arch, "train_4k", mesh, tau1=1, tau2=1,
                                    lr=LR, rounds=1, batch=B, seq=S,
                                    generator=_gen(), **kw)
    train.warmup()
    _, train_m = train.run()
    res["built"] = {
        "local_loss": float(local.run()[2]),
        "local_rows": {k: v.shape[0] for k, v in local.args[0].items()},
        "train_loss": train_m["loss"].clone(), "train_meta": train.meta,
        "builds": train.executor.compile_count,
        "captures": train.executor.capture_count,
        "roofline": steps.roofline_cost_inputs(arch, "train_4k", mesh,
                                               batch=B, seq=S, **kw),
        "packed": pack_layout(list(train.args[0].params.values()))[1]}
    res["wide"] = _wide_runs(group, p0, wide_batch)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


@pytest.fixture(scope="module")
def dp_session():
    tmp = tempfile.mkdtemp(prefix="dp_session_")
    try:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(_inputs(), path)
        spawn(_dp_rank, DATA * MODEL_AXIS, (path, tmp), device="cpu",
              timeout_s=SPAWN_TIMEOUT_S)
        yield [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False)
               for r in range(DATA * MODEL_AXIS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _whole(ranks, get, specs):
    """Each leaf ``[N, ...]`` put back together from the ranks' blocks
    (``get(rank)``: a rank's dict of ``[1, ...]`` blocks): node i's row from
    the ranks at data i, over the leaf's row axes."""
    mesh = Mesh({"data": DATA, "model": MODEL_AXIS}, rank=0)
    by_coords = {(r["coords"]["data"], r["coords"]["model"]): get(r)
                 for r in ranks}
    out = {}
    for name, spec in specs.items():
        row_spec = (None,) + tuple(spec[1:])
        axes = spec_axes(spec[1:], mesh)
        rows = []
        for i in range(DATA):
            blocks = [by_coords[(i, mesh.coords_of(m)["model"])][name]
                      for m in mesh.members(axes)]
            rows.append(place_blocks(blocks, row_spec, mesh, axes))
        out[name] = torch.cat(rows)
    return out


def _reference_rounds(label):
    R = _ref()
    _, batch, _, _ = _inputs()
    spec = LABELS[label]
    jcomp = R.make_compressor(spec[0], **spec[1]) if spec else None
    jcfg = R.dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=R.ring(N),
                           compression=jcomp, gamma=GAMMA)
    tree = R.init_params(R.model, R.jax.random.key(0))[0]
    jstate = R.dfl.init_state(tree, N, R.sgd(LR), R.jax.random.key(1),
                              compressed=jcomp is not None)
    jround = R.jax.jit(R.dfl.make_round_fn(
        jcfg, lambda p, b, k=None: R.train_loss(p, b, R.model), R.sgd(LR),
        engine="dense"))
    jstate, m = jround(jstate, {k: R.jnp.asarray(v) for k, v in batch.items()})
    flat = lambda t: {k: v.numpy() for k, v in params_from_jax(  # noqa
        R.jax.tree_util.tree_map(np.asarray, t), "cpu").items()}
    hat = flat(jstate.hat_params) if jcomp is not None else None
    return flat(jstate.params), hat, {k: float(v) for k, v in m.items()}


def _hold(got, want, label):
    """Metrics and leaves to the module's tolerances: plain DFL's, or
    C-DFL's with at most one flipped selection or level in 1e4 of a leaf
    and eight in the run."""
    (gp, gh, gm), (wp, wh, wm) = got, want
    rtol, atol = (RTOL, ATOL) if label == "dfl" else (CDFL_RTOL, CDFL_ATOL)
    for key in ("loss", "consensus_sq"):
        assert gm[key] == pytest.approx(wm[key], rel=rtol), key
    flips = 0
    for gtree, wtree in ((gp, wp), (gh, wh)):
        if wtree is None:
            assert gtree is None
            continue
        for name, w in wtree.items():
            g = np.asarray(gtree[name], np.float32)
            off = np.abs(g - np.asarray(w, np.float32)) > atol
            if label == "dfl":
                assert not off.any(), name
            else:
                assert off.sum() <= max(1, off.size * FLIPS_LEAF), name
                flips += int(off.sum())
    assert flips <= FLIPS_RUN


def _run_trees(session, label):
    p0 = _inputs()[0]
    specs = _specs(Mesh({"data": DATA, "model": MODEL_AXIS}), p0)
    params = _whole(session, lambda r: r["runs"][label][0], specs)
    hat = (_whole(session, lambda r: r["runs"][label][1], specs)
           if label != "dfl" else None)
    metrics = [r["runs"][label][2] for r in session]
    assert all(m == metrics[0] for m in metrics)   # one loss on every rank
    return params, hat, metrics[0]


@pytest.mark.parametrize("label", sorted(LABELS))
def test_dp_rounds_match_reference_dense_engine(dp_session, label):
    params, hat, metrics = _run_trees(dp_session, label)
    _hold(({k: v.numpy() for k, v in params.items()},
           None if hat is None else {k: v.numpy() for k, v in hat.items()},
           metrics), _reference_rounds(label), label)


@pytest.mark.parametrize("label", sorted(LABELS))
def test_dp_rounds_match_the_dense_port(dp_session, label):
    _hold(_run_trees(dp_session, label), _dense_port(label), label)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_topk_thresholds_over_model_are_the_whole_rows(dp_session,
                                                               dtype):
    p0 = _inputs()[0]
    for name, (x, k) in _threshold_inputs(p0).items():
        want = topk.threshold_plain(
            torch.from_numpy(x).to(dtype).reshape(N, -1), k)
        for r in dp_session:
            got = r["threshs"][(name, str(dtype))]
            i = r["coords"]["data"]
            assert got.dtype == dtype
            assert torch.equal(_bits(got), _bits(want[i:i + 1])), name


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["plain", "top_k"])
@pytest.mark.parametrize("arch_id", DP_ARCHES)
def test_gossip_step_of_each_dp_config_is_bitwise_the_dense_port(
        dp_session, arch_id, compressed):
    """``build_gossip_step`` on the mesh, each config's reduced form in its
    own dtype: the gathered step is the dense port's step bit for bit."""
    arch = REGISTRY[arch_id]
    x, y = _arch_weights(arch_id)
    comp = make_compressor("top_k", frac=0.5) if compressed else None
    dense = steps.build_gossip_step(arch, N, compression=comp, reduced=True,
                                    device="cpu", generator=_gen())
    dense.args = (x,) if comp is None else (x, y)
    want = dense.run()
    if comp is None:
        want = (want, None)
    specs = dp_session[0]["gossip"][(arch_id, compressed)][1]
    for i in range(2 if compressed else 1):
        got = _whole(dp_session,
                     lambda r: r["gossip"][(arch_id, compressed)][0][i],
                     specs)
        for name, t in want[i].items():
            assert got[name].dtype == t.dtype
            assert torch.equal(got[name], t), (i, name)


def test_non_circulant_gossip_step_matches_the_dense_port(dp_session):
    """star(4): every node's block gathered over ``data`` and mixed by the
    dense product, within 1e-6 of the dense port's step."""
    p0 = _inputs()[0]
    specs = _specs(Mesh({"data": DATA, "model": MODEL_AXIS}), p0)
    x, _ = _distinct({k: torch.from_numpy(v) for k, v in p0.items()}, 9)
    want = DenseSubstrate(topology.star(N)).mix(x)
    got = _whole(dp_session, lambda r: r["star"], specs)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=0,
                                   atol=STAR_ATOL, err_msg=name)


@pytest.mark.parametrize("label", sorted(LABELS))
def test_shift_exchange_sends_match_the_topology_on_each_model_coord(
        dp_session, label):
    """The ranks of each ``model`` coordinate together send the sparse
    engine's pairs: ``expected_shift_pairs(ring(4))``, each pair once a
    gossip step; each rank sent its packed blocks once a shift a step."""
    topo = topology.ring(N)
    for m in range(MODEL_AXIS):
        ranks = [r for r in dp_session if r["coords"]["model"] == m]
        sends = {}
        for r in ranks:
            for pair, count in r["runs"][label][3]["sends"].items():
                sends[pair] = sends.get(pair, 0) + count
        audit = audit_collective_matching(sends, topo, gossip_steps=TAU2)
        assert audit.ok, audit
        assert set(sends) == set().union(*expected_shift_pairs(topo).values())
        for r in ranks:
            ex = r["runs"][label][3]
            assert ex["bytes"] == ex["packed"] * 2 * TAU2


@pytest.mark.parametrize("label", sorted(LABELS))
def test_data_by_one_mesh_is_bitwise_the_sparse_engine(dp_session, label):
    """A data 8 x model 1 mesh holds whole rows: its round is the sparse
    engine's on the same 8 ranks bit for bit; the metrics, summed over the
    ranks in another order, to 1e-6."""
    for r in dp_session:
        (gp, gh, gm), (wp, wh, wm) = r["wide"][label]
        for g, w in ((gp, wp), (gh, wh)):
            if w is None:
                assert g is None
                continue
            for name, t in w.items():
                assert torch.equal(g[name], t), (r["rank"], name)
        for key in ("loss", "consensus_sq"):
            assert gm[key] == pytest.approx(wm[key], rel=SPARSE_RTOL), key


def test_build_functions_run_on_the_dp_mesh(dp_session):
    arch, cfg = REGISTRY[ARCH], _model()
    dense = steps.build_train_round(
        arch, "train_4k", N, tau1=1, tau2=1, lr=LR, rounds=1, cfg=cfg,
        batch=B, seq=S, device="cpu", generator=_gen())
    dense.warmup()
    want = dense.run()[1]["loss"]
    for r in dp_session:
        b = r["built"]
        assert np.isfinite(b["local_loss"])
        assert set(b["local_rows"].values()) == {1}
        assert b["train_meta"]["engine"] == "dense"     # model 2 > 1
        assert b["train_meta"]["mode"] == "gossip-dp"
        assert (b["builds"], b["captures"]) == (1, 0)
        np.testing.assert_allclose(b["train_loss"].numpy(), want.numpy(),
                                   rtol=RTOL)


def test_roofline_cost_inputs_on_the_dp_mesh(dp_session):
    """One node's FLOPs a step (counted as N stacked nodes on ``meta``),
    and what the rank's shift exchange sent in one gossip step: its packed
    blocks once a shift of ring(4)."""
    arch, cfg = REGISTRY[ARCH], _model()
    want = steps.roofline_cost_inputs(arch, "train_4k", N, cfg=cfg, batch=B,
                                      seq=S)
    for r in dp_session:
        got = r["built"]["roofline"]
        assert got["nodes"] == N
        assert got["step_flops"] == want["step_flops"]
        assert got["step_hbm_bytes"] == want["step_hbm_bytes"] / N
        assert got["gossip_collective_bytes"] == 2 * r["built"]["packed"]


# --- one process ------------------------------------------------------------

def test_multi_pod_mesh_raises_naming_item_14():
    """The multi-pod mesh runs (``tests/test_torch_mesh_pod.py``); the
    reference's 2-pod production mesh has no ranks and no process group,
    and the builders refuse it in both modes."""
    mesh = make_production_mesh(multi_pod=True)
    for arch_id in (ARCH, "deepseek-coder-33b"):
        arch = REGISTRY[arch_id]
        with pytest.raises(ValueError, match="no process group"):
            steps.build_gossip_step(arch, mesh, cfg=_model(), device="cpu")
        with pytest.raises(ValueError, match="no process group"):
            steps.build_local_step(arch, "train_4k", mesh, cfg=_model(),
                                   batch=B, seq=S, device="cpu")
        with pytest.raises(ValueError, match="no process group"):
            steps.build_train_round(arch, "train_4k", mesh, cfg=_model(),
                                    batch=B, seq=S, device="cpu")


def _one_by_one():
    mesh = make_host_mesh(1, 1)
    topo = topology.fully_connected(1)
    return topo, NodeMeshSubstrate(topo, ShardGroup(mesh, "cpu"),
                                   {"w": ("data", None)}, {"w": (1, 8)})


def test_pipelined_and_dense_power_dp_rounds_are_refused():
    from repro_torch.core.executor import RoundExecutor
    topo, sub = _one_by_one()
    cfg = dfl.DFLConfig(tau1=1, tau2=1, topology=topo)
    with pytest.raises(ValueError, match="item 18"):
        RoundExecutor(cfg, _loss, sgd(LR), substrate=sub, overlap="pipeline")
    with pytest.raises(ValueError, match="dense_power"):
        dfl.make_round_fn(dataclasses.replace(cfg, mixing_impl="dense_power"),
                          _loss, sgd(LR), substrate=sub)


def test_dp_misuse_raises():
    mesh = make_host_mesh(1, 1)
    with pytest.raises(ValueError, match="node_chunk"):
        steps.build_train_round(REGISTRY[ARCH], "train_4k", mesh,
                                cfg=_model(), device="cpu", node_chunk=1)
    with pytest.raises(ValueError, match="node dim entry"):
        NodeMeshSubstrate(topology.fully_connected(1), ShardGroup(mesh, "cpu"),
                          {"w": (None, None)}, {"w": (1, 8)})
    with pytest.raises(ValueError, match="data axis 1"):
        NodeMeshSubstrate(topology.ring(N), ShardGroup(mesh, "cpu"),
                          {"w": ("data", None)}, {"w": (N, 8)})


@pytest.mark.parametrize("label", sorted(LABELS))
def test_one_by_one_dp_mesh_is_bitwise_the_dense_port(label):
    """No process group: a 1 x 1 gossip-dp mesh holds one node whole, and
    its round is the dense engine's on one node bit for bit."""
    p0, batch, _, _ = _inputs()
    one = {k: v[:, :1] for k, v in batch.items()}
    mesh = make_host_mesh(1, 1)
    draws = GeneratorDraws(1, 1, p0, "cpu")
    got = _node_rounds(mesh, label, p0, one, draws, n=1)
    cfg = _config(label, 1)
    state = dfl.init_state({k: torch.from_numpy(v) for k, v in p0.items()},
                           1, sgd(LR), compressed=cfg.is_compressed,
                           draws=draws)
    want, wm = dfl.make_round_fn(cfg, _loss, sgd(LR))(
        state, {k: torch.from_numpy(v) for k, v in one.items()})
    assert got[2] == {k: float(v) for k, v in wm.items()}
    for g, w in zip(got[:2], (want.params, want.hat_params)):
        if w is None:
            assert g is None
            continue
        for name, t in w.items():
            assert torch.equal(g[name], t), name
