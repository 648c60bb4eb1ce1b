"""The multi-pod mesh (``launch.mesh.make_host_mesh(data, model, pod=)``,
``core.sharded.ShardGroup`` over node axes, ``core.substrate.
NodeMeshSubstrate`` with ``pod`` among them, the pod branch of
``launch.steps``) against the reference's dense engine, the port's dense
engine and the single-pod mesh.

The multi-process cases run 8 gloo ranks on the CPU, once for the module
(``pod_session``), on a pod 2 x data 2 x model 2 mesh, tau (1, 2), one
round, batch 4 a node, seq 16, f32, two cells:

* ``fsdp``: reduced DeepSeek-Coder (2 layers, d 256, 4 / 2 heads of 32),
  gossip-fsdp on pods (hierarchical DFL): 2 nodes, the pods, on ring(2),
  each pod's node split over (``data``, ``model``) as
  ``sharding.spec_for_param`` gives it, its batch split over ``data``;
* ``dp``: reduced Qwen3-1.7B (2 layers, d 256, 4 / 2 heads of 32, vocab
  512), gossip-dp: 4 nodes on ring(4), a node on each (``pod``,
  ``data``) pair, its leaves split over ``model``, its batch whole on its
  two ranks.

Each rank writes its blocks and readings; the tests put the leaves back
together and hold them:

* the rounds of plain DFL, TopK (frac 0.5) and QSGD (16 levels, the
  reference's own draws replayed through ``ReplayDraws``) of both cells
  against ``repro.core.dfl.make_round_fn``'s dense round on the same numpy
  weights and batches, at ``tests/test_torch_mesh.py``'s tolerances:
  plain DFL loss and consensus to rtol 1e-5 and every parameter to 1e-5
  absolute; C-DFL loss and consensus to rtol 1e-4, every parameter and
  estimate to 1e-4 absolute but for at most one flipped TopK selection or
  QSGD level in 1e4 elements of a leaf (eight in a run). Only the order
  of the sums differs from the dense engine (the gradients' mean over
  ``data`` in ``fsdp``, the norms and the consensus summed over the row
  axes, the means over the node axes' ranks);
* the same rounds against the port's dense round, with the same
  tolerances;
* the ``dp`` cell's rounds bitwise the data 4 x model 2 mesh's on the same
  ranks (the row-major layout gives each rank the same node, 2 pod +
  data, and the same ``model`` coordinate), state and metrics;
* K4's sharded-row form over (``data``, ``model``) on the ``fsdp`` cell's
  leaves (ties, -0.0, k = 1, half and whole, f32 and bf16): bitwise the
  whole rows';
* one gossip step over star(4), which is not circulant (every node's
  block gathered over (``pod``, ``data``), the dense product), within
  1e-6 of the dense port's;
* the shift exchange's ``sends`` of each set of other coordinates
  against ``analysis.audits.expected_shift_pairs``, over ``pod`` (ring(2):
  one shift, a send and a receive to the same peer) and over (``pod``,
  ``data``), each pair once a gossip step, and its bytes;
* ``build_local_step``, ``build_train_round`` (losses those of the dense
  ``build_train_round`` to rtol 1e-5) and ``roofline_cost_inputs`` on
  both pod meshes.

In one process: a 1 x 1 x 1 pod mesh's rounds (one node, the pod) bitwise
the dense port's, in both modes; ``make_host_mesh(pod=)``'s layout and its
refusal of a wrong rank count.
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
from repro_torch.core.sharded import (ShardGroup, block_spans, entry_axes,
                                      pack_layout, spawn, spec_axes)
from repro_torch.core.substrate import DenseSubstrate, NodeMeshSubstrate
from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
from repro_torch.kernels import ops, topk
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import init_params, train_loss
from repro_torch.optim import sgd

POD, DATA, MODEL_AXIS = 2, 2, 2
WORLD = POD * DATA * MODEL_AXIS
SHAPE = {"pod": POD, "data": DATA, "model": MODEL_AXIS}
# cell -> (arch, mode, nodes)
CELLS = {"fsdp": ("deepseek-coder-33b", "gossip-fsdp", POD),
         "dp": ("qwen3-1.7b", "gossip-dp", POD * DATA)}
TAU1, TAU2, B, S, LR, GAMMA, ROUNDS = 1, 2, 4, 16, 3e-2, 0.1, 1
LABELS = {"dfl": None, "cdfl_topk": ("top_k", {"frac": 0.5}),
          "cdfl_qsgd": ("qsgd", {"levels": 16})}
RTOL, ATOL = 1e-5, 1e-5                  # plain DFL
CDFL_RTOL, CDFL_ATOL = 1e-4, 1e-4        # C-DFL
FLIPS_LEAF, FLIPS_RUN = 1e-4, 8
STAR_ATOL = 1e-6
SPAWN_TIMEOUT_S = 300.0
RUNS = [(cell, label) for cell in sorted(CELLS) for label in sorted(LABELS)]


def _model(cell):
    return dataclasses.replace(REGISTRY[CELLS[cell][0]].reduced,
                               dtype=torch.float32)


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
        sgd=jsgd, model=lambda cell: dataclasses.replace(
            JREGISTRY[CELLS[cell][0]].reduced, dtype=jnp.float32))


def _config(cell, label, n=None):
    n = CELLS[cell][2] if n is None else n
    spec = LABELS[label]
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    topo = topology.ring(n) if n > 1 else topology.fully_connected(1)
    return dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo,
                         compression=comp, gamma=GAMMA)


def _loss_of(cell):
    cfg = _model(cell)
    return lambda p, b: train_loss(p, b, cfg)


def _reference_draws(comp, rng, shapes, n):
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
                                       len(names)) for i in range(n)]
            for j, name in enumerate(names):
                shape = comp.draw_shape(int(np.prod(shapes[name])))
                table[(r, t, name)] = np.stack([np.asarray(
                    R.jax.random.uniform(keys[i][j], shape))
                    for i in range(n)])
    return table


@functools.lru_cache(maxsize=None)
def _inputs(cell):
    """The reference's initial weights of the cell's model (flat numpy,
    the port's names), the round's batches and QSGD's draws."""
    R = _ref()
    n = CELLS[cell][2]
    jmodel = R.model(cell)
    p0 = R.init_params(jmodel, R.jax.random.key(0))[0]
    flat = {k: v.numpy() for k, v in params_from_jax(
        R.jax.tree_util.tree_map(np.asarray, p0), "cpu").items()}
    batch = lm_batches_for_dfl(SyntheticLM(vocab_size=jmodel.vocab_size,
                                           num_nodes=n), TAU1, n, B, S, 0)
    table = _reference_draws(make_compressor("qsgd", levels=16),
                             R.jax.random.key(1),
                             {k: v.shape for k, v in flat.items()}, n)
    return flat, batch, table


def _draws(label, table):
    return ReplayDraws(table, "cpu") if label == "cdfl_qsgd" else None


def _specs(cell, mesh, p0, n=None):
    _, mode, nodes = CELLS[cell]
    n = nodes if n is None else n
    _, axes = init_params(_model(cell), None, "meta", abstract=True)
    return {k: sharding.spec_for_param(axes[k], (n,) + v.shape, mode, mesh,
                                       node_dim=True)
            for k, v in p0.items()}


def _stacked(p0, n):
    return {k: torch.from_numpy(v).unsqueeze(0).repeat((n,) + (1,) * v.ndim)
            for k, v in p0.items()}


def _node_rounds(cell, mesh, label, p0, batch, draws, n=None):
    """One round of the cell on the mesh's ``NodeMeshSubstrate`` on this
    rank: its blocks of (params, hat), the metrics, and its group's
    exchange counters."""
    _, mode, nodes = CELLS[cell]
    n = nodes if n is None else n
    cfg = _config(cell, label, n)
    specs = _specs(cell, mesh, p0, n)
    sg = ShardGroup(mesh, "cpu",
                    node_axes=sharding.node_axes_for(mode, mesh))
    sub = NodeMeshSubstrate(cfg.topology, sg, specs,
                            {k: (n,) + v.shape for k, v in p0.items()})
    params = {k: sharding.shard_leaf(v, specs[k], mesh)
              for k, v in _stacked(p0, n).items()}
    state = dfl.init_state(params, n, sgd(LR), stacked=True,
                           compressed=cfg.is_compressed, draws=draws)
    round_fn = dfl.make_round_fn(cfg, _loss_of(cell), sgd(LR), substrate=sub)
    bspec = sharding.batch_spec(mesh, mode, has_tau_dim=True)
    mine = {k: sharding.shard_leaf(torch.from_numpy(v), bspec, mesh)
            for k, v in batch.items()}
    state, m = round_fn(state, mine)
    return (state.params, state.hat_params,
            {k: float(v) for k, v in m.items()},
            {"sends": dict(sg.sends), "bytes": sg.exchange_bytes,
             "packed": pack_layout(list(params.values()))[1]})


def _threshold_inputs(p0, n):
    """Rows of every leaf's shape with ties, zeros and -0.0, and their ks
    (1, half, whole)."""
    rng = np.random.default_rng(11)
    out = {}
    for i, (k, v) in enumerate(sorted(p0.items())):
        x = rng.normal(size=(n,) + v.shape).astype(np.float32)
        x.reshape(n, -1)[0, ::3] = 0.5      # ties
        x.reshape(n, -1)[1, ::5] = -0.0
        out[k] = (x, (1, max(1, v.size // 2), v.size)[i % 3])
    return out


def _distinct(params, seed, n):
    """Whole ``[n, ...]`` weights of distinct nodes: each node's copy of
    one model moved by seeded noise."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (v.unsqueeze(0).float() + 0.05 * torch.randn(
        (n,) + tuple(v.shape), generator=gen)).to(v.dtype)
        for k, v in params.items()}


def _star_step(mesh, p0):
    """One plain gossip step of the ``dp`` cell over star(4) on this
    rank's blocks of distinct nodes."""
    n = CELLS["dp"][2]
    specs = _specs("dp", mesh, p0)
    x = _distinct({k: torch.from_numpy(v) for k, v in p0.items()}, 9, n)
    sg = ShardGroup(mesh, "cpu", node_axes=("pod", "data"))
    sub = NodeMeshSubstrate(topology.star(n), sg, specs,
                            {k: (n,) + v.shape for k, v in p0.items()})
    return sub.mix({k: sharding.shard_leaf(v, specs[k], mesh)
                    for k, v in x.items()})


def _gen():
    return torch.Generator().manual_seed(2)


def _built(cell, mesh):
    """``build_local_step``, ``build_train_round`` and
    ``roofline_cost_inputs`` of the cell on the mesh."""
    arch = REGISTRY[CELLS[cell][0]]
    kw = dict(cfg=_model(cell), device="cpu")
    local = steps.build_local_step(arch, "train_4k", mesh, lr=LR, batch=B,
                                   seq=S, generator=_gen(), **kw)
    train = steps.build_train_round(arch, "train_4k", mesh, tau1=1, tau2=1,
                                    lr=LR, rounds=1, batch=B, seq=S,
                                    generator=_gen(), **kw)
    train.warmup()
    _, train_m = train.run()
    return {
        "local_loss": float(local.run()[2]),
        "local_rows": {k: v.shape[0] for k, v in local.args[0].items()},
        "train_loss": train_m["loss"].clone(), "train_meta": train.meta,
        "builds": train.executor.compile_count,
        "captures": train.executor.capture_count,
        "roofline": steps.roofline_cost_inputs(arch, "train_4k", mesh,
                                               batch=B, seq=S, **kw),
        "packed": pack_layout(list(train.args[0].params.values()))[1]}


def _pod_rank(group, path, out_dir):
    """One rank of the session; writes ``rank<r>.pt``."""
    del group
    inputs = torch.load(path, weights_only=False)
    mesh = make_host_mesh(DATA, MODEL_AXIS, pod=POD)
    flat = make_host_mesh(POD * DATA, MODEL_AXIS)
    res = {"coords": mesh.coords, "rank": mesh.rank, "runs": {}, "flat": {},
           "threshs": {}, "built": {}}
    for cell, label in RUNS:
        p0, batch, table = inputs[cell]
        res["runs"][(cell, label)] = _node_rounds(
            cell, mesh, label, p0, batch, _draws(label, table))
        if cell == "dp":
            res["flat"][label] = _node_rounds(
                cell, flat, label, p0, batch, _draws(label, table))[:3]
    p0 = inputs["fsdp"][0]
    specs = _specs("fsdp", mesh, p0)
    sg = ShardGroup(mesh, "cpu", node_axes=("pod",))
    for name, (x, k) in _threshold_inputs(p0, POD).items():
        for dt in (torch.float32, torch.bfloat16):
            part = sharding.shard_leaf(torch.from_numpy(x).to(dt),
                                       specs[name], mesh)
            span = sg.span(spec_axes(specs[name][1:], mesh))
            res["threshs"][(name, str(dt))] = (
                span.axes, ops.topk_threshold_sharded_many(
                    [part.reshape(1, -1)], [k], span)[0])
    res["star"] = _star_step(mesh, inputs["dp"][0])
    for cell in CELLS:
        res["built"][cell] = _built(cell, mesh)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


@pytest.fixture(scope="module")
def pod_session():
    tmp = tempfile.mkdtemp(prefix="pod_session_")
    try:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({cell: _inputs(cell) for cell in CELLS}, path)
        spawn(_pod_rank, WORLD, (path, tmp), device="cpu",
              timeout_s=SPAWN_TIMEOUT_S)
        yield [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _whole(ranks, get, specs, n):
    """Each leaf ``[n, ...]`` put back together from the ranks' blocks
    (``get(rank)``: a rank's dict of ``[1, ...]`` blocks of its node): every
    rank's block written where its spec puts it; a block held on several
    ranks must be the same on each."""
    mesh = Mesh(SHAPE)
    out = {}
    for name, spec in specs.items():
        block = get(ranks[0])[name]
        counts = [mesh.axes_size(entry_axes(e)) for e in spec]
        counts += [1] * (block.dim() - len(counts))
        shape = tuple(d * c for d, c in zip(block.shape, counts))
        whole = block.new_full(shape, float("nan"))
        for r in ranks:
            view = whole
            for i, (start, size) in enumerate(block_spans(shape, spec, mesh,
                                                          r["coords"])):
                view = view.narrow(i, start, size)
            if not torch.isnan(view).all():
                assert torch.equal(view, get(r)[name]), (name, r["rank"])
            view.copy_(get(r)[name])
        assert shape[0] == n and not torch.isnan(whole).any(), name
        out[name] = whole
    return out


def _reference_rounds(cell, label):
    R = _ref()
    _, batch, _ = _inputs(cell)
    n = CELLS[cell][2]
    jmodel = R.model(cell)
    spec = LABELS[label]
    jcomp = R.make_compressor(spec[0], **spec[1]) if spec else None
    jcfg = R.dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=R.ring(n),
                           compression=jcomp, gamma=GAMMA)
    tree = R.init_params(jmodel, R.jax.random.key(0))[0]
    jstate = R.dfl.init_state(tree, n, R.sgd(LR), R.jax.random.key(1),
                              compressed=jcomp is not None)
    jround = R.jax.jit(R.dfl.make_round_fn(
        jcfg, lambda p, b, k=None: R.train_loss(p, b, jmodel), R.sgd(LR),
        engine="dense"))
    jstate, m = jround(jstate, {k: R.jnp.asarray(v) for k, v in batch.items()})
    flat = lambda t: {k: v.numpy() for k, v in params_from_jax(  # noqa
        R.jax.tree_util.tree_map(np.asarray, t), "cpu").items()}
    hat = flat(jstate.hat_params) if jcomp is not None else None
    return flat(jstate.params), hat, {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _dense_port(cell, label):
    p0, batch, table = _inputs(cell)
    cfg = _config(cell, label)
    state = dfl.init_state({k: torch.from_numpy(v) for k, v in p0.items()},
                           CELLS[cell][2], sgd(LR),
                           compressed=cfg.is_compressed,
                           draws=_draws(label, table))
    state, m = dfl.make_round_fn(cfg, _loss_of(cell), sgd(LR))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state.params, state.hat_params, {k: float(v)
                                            for k, v in m.items()}


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


def _run_trees(session, cell, label):
    p0 = _inputs(cell)[0]
    specs = _specs(cell, Mesh(SHAPE), p0)
    n = CELLS[cell][2]
    params = _whole(session, lambda r: r["runs"][(cell, label)][0], specs, n)
    hat = (_whole(session, lambda r: r["runs"][(cell, label)][1], specs, n)
           if label != "dfl" else None)
    metrics = [r["runs"][(cell, label)][2] for r in session]
    assert all(m == metrics[0] for m in metrics)   # one loss on every rank
    return params, hat, metrics[0]


@pytest.mark.parametrize("cell,label", RUNS)
def test_pod_rounds_match_reference_dense_engine(pod_session, cell, label):
    params, hat, metrics = _run_trees(pod_session, cell, label)
    _hold(({k: v.numpy() for k, v in params.items()},
           None if hat is None else {k: v.numpy() for k, v in hat.items()},
           metrics), _reference_rounds(cell, label), label)


@pytest.mark.parametrize("cell,label", RUNS)
def test_pod_rounds_match_the_dense_port(pod_session, cell, label):
    _hold(_run_trees(pod_session, cell, label), _dense_port(cell, label),
          label)


@pytest.mark.parametrize("label", sorted(LABELS))
def test_dp_pod_rounds_are_bitwise_the_data_by_model_mesh(pod_session,
                                                          label):
    """Rank r is node 2 pod + data = r // 2 at model r % 2 on both meshes,
    and the node axes' groups have the same members: every block of the
    state and the metrics bit for bit."""
    for r in pod_session:
        c = r["coords"]
        assert (2 * c["pod"] + c["data"], c["model"]) == (r["rank"] // 2,
                                                          r["rank"] % 2)
        gp, gh, gm = r["runs"][("dp", label)][:3]
        wp, wh, wm = r["flat"][label]
        for g, w in ((gp, wp), (gh, wh)):
            if w is None:
                assert g is None
                continue
            for name, t in w.items():
                assert torch.equal(g[name], t), (r["rank"], name)
        assert gm == wm


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_topk_thresholds_over_data_and_model_are_the_whole_rows(
        pod_session, dtype):
    p0 = _inputs("fsdp")[0]
    spans = set()
    for name, (x, k) in _threshold_inputs(p0, POD).items():
        want = topk.threshold_plain(
            torch.from_numpy(x).to(dtype).reshape(POD, -1), k)
        for r in pod_session:
            axes, got = r["threshs"][(name, str(dtype))]
            spans.add(axes)
            i = r["coords"]["pod"]
            assert got.dtype == dtype
            assert torch.equal(_bits(got), _bits(want[i:i + 1])), name
    assert ("data", "model") in spans


def test_non_circulant_gossip_step_over_pod_and_data(pod_session):
    """star(4): every node's block gathered over (``pod``, ``data``) and
    mixed by the dense product, within 1e-6 of the dense port's step."""
    p0 = _inputs("dp")[0]
    n = CELLS["dp"][2]
    specs = _specs("dp", Mesh(SHAPE), p0)
    x = _distinct({k: torch.from_numpy(v) for k, v in p0.items()}, 9, n)
    want = DenseSubstrate(topology.star(n)).mix(x)
    got = _whole(pod_session, lambda r: r["star"], specs, n)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=0,
                                   atol=STAR_ATOL, err_msg=name)


@pytest.mark.parametrize("cell,label", RUNS)
def test_shift_exchange_sends_match_the_topology_over_the_node_axes(
        pod_session, cell, label):
    """The ranks of each set of coordinates off the node axes together
    send the sparse engine's pairs, in node indices:
    ``expected_shift_pairs`` of ring(2) over ``pod`` (one shift) or of
    ring(4) over (``pod``, ``data``), each pair once a gossip step; each
    rank sent its packed blocks once a shift a step."""
    _, mode, n = CELLS[cell]
    topo = topology.ring(n)
    node_axes = sharding.node_axes_for(mode, Mesh(SHAPE))
    others = {}
    for r in pod_session:
        key = tuple(v for a, v in r["coords"].items() if a not in node_axes)
        others.setdefault(key, []).append(r)
    assert len(others) == WORLD // n
    for ranks in others.values():
        sends = {}
        for r in ranks:
            for pair, count in r["runs"][(cell, label)][3]["sends"].items():
                sends[pair] = sends.get(pair, 0) + count
        audit = audit_collective_matching(sends, topo, gossip_steps=TAU2)
        assert audit.ok, audit
        assert set(sends) == set().union(*expected_shift_pairs(topo).values())
        for r in ranks:
            ex = r["runs"][(cell, label)][3]
            assert ex["bytes"] == ex["packed"] * len(topo.shifts()) * TAU2


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_build_functions_run_on_pod_meshes(pod_session, cell):
    arch_id, mode, n = CELLS[cell]
    dense = steps.build_train_round(
        REGISTRY[arch_id], "train_4k", n, tau1=1, tau2=1, lr=LR, rounds=1,
        cfg=_model(cell), batch=B, seq=S, device="cpu", generator=_gen())
    dense.warmup()
    want = dense.run()[1]["loss"]
    for r in pod_session:
        b = r["built"][cell]
        assert np.isfinite(b["local_loss"])
        assert set(b["local_rows"].values()) == {1}
        assert b["train_meta"]["engine"] == "dense"     # data, model > 1
        assert (b["train_meta"]["mode"], b["train_meta"]["nodes"]) == (mode,
                                                                       n)
        assert (b["builds"], b["captures"]) == (1, 0)
        np.testing.assert_allclose(b["train_loss"].numpy(), want.numpy(),
                                   rtol=RTOL)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_roofline_cost_inputs_on_pod_meshes(pod_session, cell):
    """One node's FLOPs a step (counted as N stacked nodes on ``meta``),
    a rank's share of one node's bytes, and what the rank's shift exchange
    sent in one gossip step: its packed blocks once a shift."""
    arch_id, _, n = CELLS[cell]
    want = steps.roofline_cost_inputs(REGISTRY[arch_id], "train_4k", n,
                                      cfg=_model(cell), batch=B, seq=S)
    shifts = len(topology.ring(n).shifts())
    for r in pod_session:
        got = r["built"][cell]["roofline"]
        assert got["nodes"] == n
        assert got["step_flops"] == want["step_flops"]
        assert got["step_hbm_bytes"] == want["step_hbm_bytes"] / n
        assert got["gossip_collective_bytes"] == (
            shifts * r["built"][cell]["packed"])


# --- one process ------------------------------------------------------------

@pytest.mark.parametrize("cell,label", RUNS)
def test_one_pod_mesh_is_bitwise_the_dense_port(cell, label):
    """No process group: a 1 x 1 x 1 pod mesh holds one node (the pod)
    whole, and its round is the dense engine's on one node bit for bit."""
    p0, batch, _ = _inputs(cell)
    one = {k: v[:, :1] for k, v in batch.items()}
    mesh = make_host_mesh(1, 1, pod=1)
    assert sharding.num_nodes_for(CELLS[cell][1], mesh, 4) == 1
    draws = GeneratorDraws(1, 1, p0, "cpu")
    got = _node_rounds(cell, mesh, label, p0, one, draws, n=1)
    cfg = _config(cell, label, 1)
    state = dfl.init_state({k: torch.from_numpy(v) for k, v in p0.items()},
                           1, sgd(LR), compressed=cfg.is_compressed,
                           draws=draws)
    want, wm = dfl.make_round_fn(cfg, _loss_of(cell), sgd(LR))(
        state, {k: torch.from_numpy(v) for k, v in one.items()})
    assert got[2] == {k: float(v) for k, v in wm.items()}
    for g, w in zip(got[:2], (want.params, want.hat_params)):
        if w is None:
            assert g is None
            continue
        for name, t in w.items():
            assert torch.equal(g[name], t), name


def test_host_pod_mesh_layout_and_wrong_rank_counts():
    """``make_host_mesh(pod=)`` lays ranks out row-major over (pod, data,
    model) and, without a process group, makes only a mesh of one rank."""
    mesh = make_host_mesh(1, 1, pod=1)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    big = Mesh(SHAPE, rank=5)
    assert big.coords == {"pod": 1, "data": 0, "model": 1}
    assert big.members(("pod", "data")) == [1, 3, 5, 7]
    for pod, data, model in ((2, 1, 1), (1, 2, 2), (2, 2, 2)):
        with pytest.raises(ValueError, match="pod x data x model"):
            make_host_mesh(data, model, pod=pod)
    with pytest.raises(ValueError, match="over 1 ranks"):
        make_host_mesh(1, 1, pod=0)
