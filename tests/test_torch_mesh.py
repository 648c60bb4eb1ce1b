"""The gossip-fsdp mesh (``launch.mesh``, ``launch.sharding``,
``core.substrate.MeshSubstrate``, K4's sharded-row form) against the
reference's dense engine and the port's.

The multi-process cases run 4 gloo ranks on the CPU, once for the module
(``mesh_session``), on a data 2 x model 2 mesh: reduced DeepSeek-Coder
(2 layers, d 256, 4 / 2 heads of 32, f32), 4 replicated nodes on ring(4),
tau (1, 2), one round, batch 4 a node (2 a data rank), seq 16 (the
reference's and the dense port's multi-round trajectories are held in
``test_torch_lm_train.py``; the mesh changes no round's carry). Each rank
holds the block of every leaf of every node that
``sharding.spec_for_param`` gives its coordinates, and writes its blocks
and rows; the tests put the leaves back together and hold them:

* the rounds of plain DFL, TopK (frac 0.5) and QSGD (16 levels, the
  reference's own draws replayed through ``ReplayDraws``) against
  ``repro.core.dfl.make_round_fn``'s dense round on the same numpy
  weights and batches. Plain DFL: loss and consensus to rtol 1e-5, every
  parameter to 1e-5 absolute (weights of order 0.1; seen 3.6e-7). C-DFL,
  as ``test_torch_lm_train.py`` holds the dense port's QSGD: loss and
  consensus to rtol 1e-4 (the consensus, a sum of squared deviations of
  order 1e-3 of weights of order 0.1, moves by 1.4e-5 relative), every
  parameter and estimate to 1e-4 absolute (seen 7.2e-5 on TopK's
  estimates, 9.3e-5 for the dense port's), but for TopK selections and
  QSGD levels that flip where two gaps differ in the last ulp: at most
  one element in 1e4 of a leaf, eight in a run (none seen; the dense
  port flips one QSGD level). The mesh differs from the dense engine in
  the order of its sums only: the gradients' mean over the two data
  ranks, the norms and the consensus summed over the ranks;
* the same rounds against the port's dense engine, with the same
  tolerances;
* K4's sharded-row form on every leaf's rows (ties, -0.0, k = 1, half
  and whole): bitwise the whole rows' threshold; the seam's draws of
  every rank's blocks bitwise the whole draw cut to them;
  ``unshard_leaf`` of every rank's block of every leaf is the leaf; one
  CHOCO step of RandK and randomized gossip (the unfused composition)
  bitwise the dense port's;
* ``build_train_round`` / ``build_local_step`` / ``build_gossip_step`` on
  the mesh: finite, with the nodes' blocks, and the train round's losses
  those of the dense ``build_train_round`` to rtol 1e-5.

In one process: a 1 x 1 mesh (no process group) is bitwise the dense
port; so is the dense round with its gossip phase run leaf by leaf
(``chip_smoke.dense_round_by_leaf``, phase 18's reference on the card);
the block draws of ``GeneratorDraws`` and ``ReplayDraws`` are the
whole draws cut; a numpy mirror of K4's sharded passes (per-part
histograms, summed, the digit picked on the sum) selects the whole row's
threshold bitwise; the misuse the mesh refuses.
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

from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.core import dfl, topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.rng import GeneratorDraws, ReplayDraws, cut_block
from repro_torch.core.sharded import (ShardGroup, block_spans, place_blocks,
                                      spawn, spec_axes)
from repro_torch.core.substrate import DenseSubstrate, MeshSubstrate
from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
from repro_torch.kernels import ops, topk
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import init_params, train_loss
from repro_torch.optim import sgd

ARCH = "deepseek-coder-33b"
N, TAU1, TAU2, B, S, LR, GAMMA, ROUNDS = 4, 1, 2, 4, 16, 3e-2, 0.1, 1
DATA, MODEL_AXIS = 2, 2
LABELS = {"dfl": None, "cdfl_topk": ("top_k", {"frac": 0.5}),
          "cdfl_qsgd": ("qsgd", {"levels": 16})}
RTOL, ATOL = 1e-5, 1e-5                  # plain DFL
CDFL_RTOL, CDFL_ATOL = 1e-4, 1e-4        # C-DFL
FLIPS_LEAF, FLIPS_RUN = 1e-4, 8
SPAWN_TIMEOUT_S = 150.0


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


def _config(label):
    spec = LABELS[label]
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    return dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=topology.ring(N),
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
    rounds' batches and QSGD's draws."""
    R = _ref()
    p0 = R.init_params(R.model, R.jax.random.key(0))[0]
    flat = {k: v.numpy() for k, v in params_from_jax(
        R.jax.tree_util.tree_map(np.asarray, p0), "cpu").items()}
    corpus = SyntheticLM(vocab_size=R.model.vocab_size, num_nodes=N)
    batches = [lm_batches_for_dfl(corpus, TAU1, N, B, S, r)
               for r in range(ROUNDS)]
    table = _reference_draws(make_compressor("qsgd", levels=16),
                             R.jax.random.key(1),
                             {k: v.shape for k, v in flat.items()})
    return flat, batches, table


def _draws(label, table):
    return (ReplayDraws(table, "cpu") if label == "cdfl_qsgd" else None)


def _specs(mesh, p0):
    _, axes = init_params(_model(), None, "meta", abstract=True)
    return {k: sharding.spec_for_param(axes[k], (N,) + v.shape,
                                       "gossip-fsdp", mesh, node_dim=True)
            for k, v in p0.items()}


def _mesh_rounds(mesh, group, label, p0, batches, table, chunk=None):
    """``ROUNDS`` rounds of the dense engine on ``MeshSubstrate``: this
    rank's blocks of (params, hat) and the rounds' metrics."""
    cfg = _config(label)
    specs = _specs(mesh, p0)
    shapes = {k: (N,) + v.shape for k, v in p0.items()}
    sub = MeshSubstrate(cfg.topology, group, specs, shapes, chunk=chunk)
    params = {k: sharding.shard_leaf(
        torch.from_numpy(v).unsqueeze(0).repeat((N,) + (1,) * v.ndim),
        specs[k], mesh) for k, v in p0.items()}
    state = dfl.init_state(params, N, sgd(LR), stacked=True,
                           compressed=cfg.is_compressed,
                           draws=_draws(label, table))
    round_fn = dfl.make_round_fn(cfg, _loss, sgd(LR), substrate=sub)
    bspec = sharding.batch_spec(mesh, "gossip-fsdp", has_tau_dim=True)
    ms = []
    for b in batches:
        mine = {k: sharding.shard_leaf(torch.from_numpy(v), bspec, mesh)
                for k, v in b.items()}
        state, m = round_fn(state, mine)
        ms.append({k: float(v) for k, v in m.items()})
    return state.params, state.hat_params, ms


@functools.lru_cache(maxsize=None)
def _dense_port(label):
    """The dense port's rounds on the module's inputs (shared by the tests
    that hold the mesh to them)."""
    return _dense_rounds(label, *_inputs())


def _dense_rounds(label, p0, batches, table):
    cfg = _config(label)
    state = dfl.init_state({k: torch.from_numpy(v) for k, v in p0.items()},
                           N, sgd(LR), compressed=cfg.is_compressed,
                           draws=_draws(label, table))
    round_fn = dfl.make_round_fn(cfg, _loss, sgd(LR))
    ms = []
    for b in batches:
        state, m = round_fn(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return state.params, state.hat_params, ms


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


UNFUSED = (("rand_k", {"frac": 0.5}), ("rand_gossip", {"p": 0.8}))


def _step_state(p0):
    """x and y of every node for one CHOCO step, whole ``[N, ...]``."""
    gen = torch.Generator().manual_seed(9)
    x = {k: torch.from_numpy(v) + 0.01 * torch.randn((N,) + v.shape,
                                                      generator=gen)
         for k, v in p0.items()}
    return x, {k: v * 0.5 for k, v in x.items()}


def _unfused_steps(mesh, sg, specs, p0):
    """One CHOCO step of RandK and randomized gossip (the unfused
    composition, ``compress`` with the global d and block draws) on this
    rank's blocks: (x_new, y_new) blocks for each."""
    x, y = _step_state(p0)
    shapes = {k: tuple(v.shape) for k, v in x.items()}
    sub = MeshSubstrate(topology.ring(N), sg, specs, shapes)
    draws = GeneratorDraws(3, N, p0, "cpu")
    xb = {k: sharding.shard_leaf(v, specs[k], mesh) for k, v in x.items()}
    yb = {k: sharding.shard_leaf(v, specs[k], mesh) for k, v in y.items()}
    return {name: sub.choco_step(make_compressor(name, **kw), xb, yb,
                                 sub.mix(yb), GAMMA, draws, 0, 0)
            for name, kw in UNFUSED}


def _gen():
    return torch.Generator().manual_seed(2)


def _mesh_rank(group, path, out_dir):
    """One rank of the session: the rounds, the sharded thresholds, the
    block draws and the ``build_*`` steps on the mesh; writes
    ``rank<r>.pt``."""
    del group
    p0, batches, table = torch.load(path, weights_only=False)
    mesh = make_host_mesh(DATA, MODEL_AXIS)
    sg = ShardGroup(mesh, "cpu")
    specs = _specs(mesh, p0)
    res = {"coords": mesh.coords, "rank": mesh.rank, "runs": {},
           "threshs": {}, "draws": {}}
    for label in LABELS:
        res["runs"][label] = _mesh_rounds(mesh, sg, label, p0, batches,
                                          table, chunk=3)
    for name, (x, k) in _threshold_inputs(p0).items():
        for dt in (torch.float32, torch.bfloat16):
            part = sharding.shard_leaf(torch.from_numpy(x).to(dt),
                                       specs[name], mesh)
            span = sg.span(spec_axes(specs[name], mesh))
            res["threshs"][(name, str(dt))] = ops.topk_threshold_sharded_many(
                [part.reshape(N, -1)], [k], span)[0]
    res["unfused"] = _unfused_steps(mesh, sg, specs, p0)
    res["unshard"] = {k: torch.equal(sharding.unshard_leaf(
        sharding.shard_leaf(torch.from_numpy(v), specs[k][1:], mesh),
        specs[k][1:], mesh), torch.from_numpy(v)) for k, v in p0.items()}
    draws = GeneratorDraws(5, N, p0, "cpu")
    blocks = {k: (v.shape, block_spans(v.shape, specs[k][1:], mesh))
              for k, v in p0.items()}
    names = sorted(p0)
    res["draws"] = dict(zip(names, draws.uniform_many(
        1, 0, names, [(p0[k].size,) for k in names],
        blocks=[blocks[k] for k in names])))
    arch, cfg = REGISTRY[ARCH], _model()
    kw = dict(cfg=cfg, device="cpu")
    local = steps.build_local_step(arch, "train_4k", mesh, lr=LR, batch=B,
                                   seq=S, generator=_gen(), **kw)
    gossip = steps.build_gossip_step(
        arch, mesh, compression=make_compressor("top_k", frac=0.5),
        generator=_gen(), **kw)
    train = steps.build_train_round(arch, "train_4k", mesh, tau1=1, tau2=1,
                                    lr=LR, rounds=1, batch=B, seq=S,
                                    generator=_gen(), node_chunk=1, **kw)
    train.warmup()
    _, train_m = train.run()
    res["built"] = {
        "local_loss": float(local.run()[2]),
        "gossip": {k: v.clone() for k, v in gossip.run()[0].items()},
        "train_loss": train_m["loss"].clone(), "train_meta": train.meta,
        "builds": train.executor.compile_count,
        "captures": train.executor.capture_count}
    try:
        make_host_mesh(DATA, 1)
        res["smaller_mesh"] = None
    except ValueError as e:
        res["smaller_mesh"] = str(e)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


@pytest.fixture(scope="module")
def mesh_session():
    tmp = tempfile.mkdtemp(prefix="mesh_session_")
    try:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(_inputs(), path)
        spawn(_mesh_rank, DATA * MODEL_AXIS, (path, tmp), device="cpu",
              timeout_s=SPAWN_TIMEOUT_S)
        yield [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False)
               for r in range(DATA * MODEL_AXIS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _whole(ranks, get, specs):
    """Each leaf put back together from the ranks' blocks (``get(rank)``:
    a rank's dict of blocks)."""
    mesh = Mesh({"data": DATA, "model": MODEL_AXIS}, rank=0)
    by_rank = {r["rank"]: get(r) for r in ranks}
    out = {}
    for name, spec in specs.items():
        axes = spec_axes(spec, mesh)
        out[name] = place_blocks([by_rank[m][name]
                                  for m in mesh.members(axes)],
                                 spec, mesh, axes)
    return out


def _reference_rounds(label):
    R = _ref()
    p0, batches, table = _inputs()
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
    ms = []
    for b in batches:
        jstate, m = jround(jstate, {k: R.jnp.asarray(v)
                                    for k, v in b.items()})
        ms.append({k: float(v) for k, v in m.items()})
    flat = lambda t: {k: v.numpy() for k, v in params_from_jax(  # noqa
        R.jax.tree_util.tree_map(np.asarray, t), "cpu").items()}
    hat = flat(jstate.hat_params) if jcomp is not None else None
    return flat(jstate.params), hat, ms


def _hold(got, want, label):
    """Metrics and leaves to the module's tolerances: plain DFL's, or
    C-DFL's with at most one flipped selection or level in 1e4 of a leaf
    and eight in the run."""
    (gp, gh, gm), (wp, wh, wm) = got, want
    rtol, atol = (RTOL, ATOL) if label == "dfl" else (CDFL_RTOL, CDFL_ATOL)
    for a, b in zip(gm, wm):
        for key in ("loss", "consensus_sq"):
            assert a[key] == pytest.approx(b[key], rel=rtol), key
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


@pytest.mark.parametrize("label", sorted(LABELS))
def test_mesh_rounds_match_reference_dense_engine(mesh_session, label):
    p0 = _inputs()[0]
    specs = _specs(Mesh({"data": DATA, "model": MODEL_AXIS}), p0)
    run = [r["runs"][label] for r in mesh_session]
    params = _whole(mesh_session, lambda r: r["runs"][label][0], specs)
    hat = (_whole(mesh_session, lambda r: r["runs"][label][1], specs)
           if label != "dfl" else None)
    assert all(m == run[0][2] for *_, m in run)   # one loss on every rank
    _hold(({k: v.numpy() for k, v in params.items()},
           None if hat is None else {k: v.numpy() for k, v in hat.items()},
           run[0][2]), _reference_rounds(label), label)


@pytest.mark.parametrize("label", sorted(LABELS))
def test_mesh_rounds_match_the_dense_port(mesh_session, label):
    p0, batches, table = _inputs()
    specs = _specs(Mesh({"data": DATA, "model": MODEL_AXIS}), p0)
    params = _whole(mesh_session, lambda r: r["runs"][label][0], specs)
    hat = (_whole(mesh_session, lambda r: r["runs"][label][1], specs)
           if label != "dfl" else None)
    _hold((params, hat, mesh_session[0]["runs"][label][2]),
          _dense_port(label), label)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def test_sharded_topk_thresholds_are_the_whole_rows(mesh_session):
    p0 = _inputs()[0]
    for name, (x, k) in _threshold_inputs(p0).items():
        for dt in (torch.float32, torch.bfloat16):
            want = topk.threshold_plain(
                torch.from_numpy(x).to(dt).reshape(N, -1), k)
            for r in mesh_session:
                got = r["threshs"][(name, str(dt))]
                assert got.dtype == dt
                assert torch.equal(_bits(got), _bits(want)), name


def test_unfused_compressors_step_bitwise_the_dense_port(mesh_session):
    """RandK (K4's sharded form on its block scores) and randomized gossip:
    one CHOCO step on the blocks is the dense port's step bit for bit."""
    p0 = _inputs()[0]
    mesh = Mesh({"data": DATA, "model": MODEL_AXIS})
    specs = _specs(mesh, p0)
    x, y = _step_state(p0)
    dense = DenseSubstrate(topology.ring(N))
    draws = GeneratorDraws(3, N, p0, "cpu")
    for name, kw in UNFUSED:
        want = dense.choco_step(make_compressor(name, **kw), x, y,
                                dense.mix(y), GAMMA, draws, 0, 0)
        for i in range(2):
            got = _whole(mesh_session, lambda r: r["unfused"][name][i], specs)
            for k, t in want[i].items():
                assert torch.equal(got[k], t), (name, i, k)


def test_unshard_leaf_puts_every_leaf_back(mesh_session):
    for r in mesh_session:
        assert r["unshard"] and all(r["unshard"].values()), r["unshard"]


def test_block_draws_are_the_whole_draws_cut(mesh_session):
    p0 = _inputs()[0]
    mesh = Mesh({"data": DATA, "model": MODEL_AXIS})
    specs = _specs(mesh, p0)
    draws = GeneratorDraws(5, N, p0, "cpu")
    names = sorted(p0)
    whole = dict(zip(names, draws.uniform_many(
        1, 0, names, [(p0[k].size,) for k in names])))
    for r in mesh_session:
        for name in names:
            block = (p0[name].shape, block_spans(p0[name].shape,
                                                 specs[name][1:], mesh,
                                                 r["coords"]))
            assert torch.equal(r["draws"][name],
                               cut_block(whole[name], block)), name


def test_build_functions_run_on_the_mesh(mesh_session):
    arch, cfg = REGISTRY[ARCH], _model()
    dense = steps.build_train_round(
        arch, "train_4k", N, tau1=1, tau2=1, lr=LR, rounds=1, cfg=cfg,
        batch=B, seq=S, device="cpu", generator=_gen())
    dense.warmup()
    want = dense.run()[1]["loss"]
    for r in mesh_session:
        b = r["built"]
        assert np.isfinite(b["local_loss"])
        assert all(torch.isfinite(v).all() for v in b["gossip"].values())
        assert b["train_meta"]["engine"] == "dense"
        assert b["train_meta"]["mode"] == "gossip-fsdp"
        assert (b["builds"], b["captures"]) == (1, 0)
        np.testing.assert_allclose(b["train_loss"].numpy(), want.numpy(),
                                   rtol=RTOL)


def test_a_mesh_that_leaves_ranks_out_raises(mesh_session):
    """A 2 x 1 mesh over 4 ranks raises on every rank instead of being cut
    to the ranks it names."""
    for r in mesh_session:
        assert r["smaller_mesh"] is not None
        assert "2 x 1 mesh over 4 ranks" in r["smaller_mesh"]


# --- one process ------------------------------------------------------------

@pytest.mark.parametrize("label", sorted(LABELS))
def test_one_by_one_mesh_is_bitwise_the_dense_port(label):
    """No process group: every collective of a 1 x 1 mesh is the identity,
    and the rounds are the dense engine's bit for bit."""
    p0, batches, table = _inputs()
    mesh = make_host_mesh(1, 1)
    got = _mesh_rounds(mesh, ShardGroup(mesh, "cpu"), label, p0, batches,
                       table)
    want = _dense_port(label)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        if w is None:
            assert g is None
            continue
        for name, t in w.items():
            assert torch.equal(g[name], t), name


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` (repo root) as a module: its phase 18 holds the
    mesh to the dense round run leaf by leaf."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", sorted(LABELS))
def test_dense_round_with_its_gossip_leaf_by_leaf_is_bitwise_the_round(
        label):
    """``chip_smoke.dense_round_by_leaf``, the card's reference for the
    mesh (one leaf's C-DFL temporaries at a time), is the dense engine's
    round bit for bit: parameters, loss and consensus."""
    p0, batches, table = _inputs()
    cfg = _config(label)
    state = dfl.init_state({k: torch.from_numpy(v) for k, v in p0.items()},
                           N, sgd(LR), compressed=cfg.is_compressed,
                           draws=_draws(label, table))
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    # the dense round of the module's inputs, one round from the same state
    want, _, (wm,) = _dense_port(label)
    got, gm = _chip_smoke().dense_round_by_leaf(cfg, _loss, sgd(LR), state,
                                                batch)
    for key in ("loss", "consensus_sq"):
        assert gm[key].dtype == torch.float32
        assert float(gm[key]) == wm[key], key
    assert list(got) != [] and set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def test_replay_draws_cut_blocks():
    table = {(0, 1, "w"): np.random.default_rng(3).random((N, 60),
                                                          np.float32)}
    draws = ReplayDraws(table, "cpu")
    block = ((3, 4, 5), ((1, 2), (0, 4), (2, 3)))
    got = draws.uniform_many(0, 1, ["w"], [(60,)], node_ids=[2, 1],
                             blocks=[block])[0]
    want = table[(0, 1, "w")].reshape(N, 3, 4, 5)[[2, 1], 1:3, :, 2:5]
    np.testing.assert_array_equal(got.numpy(), want.reshape(2, -1))


def _mirror_select(parts, k, dtype):
    """K4's sharded passes in numpy: each part's keys that match the prefix
    counted per digit, the counts summed over the parts, the digit that
    holds rank k picked on the sum (``topk.cu``'s count and pick)."""
    keys = [np.asarray(p.view(torch.int32 if dtype == torch.float32
                              else torch.int16).numpy(),
                       np.int64) & (0x7FFFFFFF if dtype == torch.float32
                                    else 0x7FFF) for p in parts]
    prefix, rank, top = 0, k, sum(topk.DIGITS[dtype])
    for shift, bits in topk.digit_passes(dtype):
        fixed = ((1 << top) - 1) & ~((1 << (shift + bits)) - 1)
        hist = sum(np.bincount((kk[(kk & fixed) == prefix] >> shift)
                               & ((1 << bits) - 1), minlength=1 << bits)
                   for kk in keys)
        above = np.cumsum(hist[::-1])[::-1] - hist   # keys in higher bins
        digit = int(np.nonzero((above < rank) & (rank <= above + hist))[0][0])
        prefix |= digit << shift
        rank -= int(above[digit])
    return prefix


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mirror_of_the_sharded_select_is_the_whole_threshold(dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 600)).astype(np.float32)).to(
        dtype)
    x[1, ::4] = 0.25
    x[2, :300] = -0.0
    for k in (1, 7, 300, 301, 600):
        want = topk.threshold_plain(x, k)
        for r in range(3):
            parts = list(x[r].chunk(4))
            assert _mirror_select(parts, k, dtype) == int(_bits(want[r])), \
                (k, r)


def test_mesh_misuse_raises():
    mesh = make_host_mesh(1, 1)
    topo = topology.ring(N)
    with pytest.raises(ValueError, match="node dim sharded"):
        MeshSubstrate(topo, ShardGroup(mesh, "cpu"), {"w": ("data", None)},
                      {"w": (N, 8)})
    with pytest.raises(ValueError, match="stacks 3 nodes"):
        MeshSubstrate(topo, ShardGroup(mesh, "cpu"), {"w": (None, None)},
                      {"w": (3, 8)})
    with pytest.raises(ValueError, match="no process group"):
        Mesh({"data": 2, "model": 1}).group_of(("data",))
    # the 2-pod production mesh has no ranks: the builders refuse it (a
    # multi-pod mesh of ranks runs, tests/test_torch_mesh_pod.py)
    with pytest.raises(ValueError, match="no process group"):
        steps.build_gossip_step(REGISTRY[ARCH],
                                make_production_mesh(multi_pod=True),
                                cfg=_model(), device="cpu")
    with pytest.raises(ValueError, match="not a mesh"):
        steps.build_train_round(REGISTRY[ARCH], "train_4k", N, cfg=_model(),
                                device="cpu", node_chunk=1)


def test_pipelined_mesh_rounds_are_refused():
    """``overlap="pipeline"`` is not ported to the mesh: the executor
    refuses a substrate with it."""
    from repro_torch.core.executor import RoundExecutor
    topo = topology.ring(N)
    sub = MeshSubstrate(topo, ShardGroup(make_host_mesh(1, 1), "cpu"),
                        {"w": (None, None)}, {"w": (N, 8)})
    with pytest.raises(ValueError, match="not ported"):
        RoundExecutor(dfl.DFLConfig(tau1=1, tau2=1, topology=topo), _loss,
                      sgd(LR), substrate=sub, overlap="pipeline")
