"""The port's sparse engine (one node per process) against the dense port
and the reference's dense engine.

The per-shift tables and masked weights are the reference's
``ShardedSubstrate`` / ``masked_shift_weights`` (numpy, no mesh needed).
The multi-process cases run 4 gloo ranks on the CPU (``core.sharded.
spawn``), once for the whole module (``sparse_session``): each rank runs
its node, on ring(4), tau1 = tau2 = 2, batch 4, of the MNIST CNN from the
same converted weights and numpy batches as ``test_torch_round.py`` and
of a two-layer perceptron, and writes its rows; the tests stack them and
hold them:

* one gossip step from the same state against the dense port: bitwise
  (plain, masked, TopK; the exchange sums the copies in the dense kernel's
  order with the dense table's weights), QSGD's ``y_new`` within K2's
  8-ulp contract (its row norm at ``[1, D]`` may differ from the
  ``[N, D]`` call in the last bit);
* the perceptron's rounds against the dense port's, bitwise for plain
  DFL and TopK, QSGD within rtol 1e-5; the CNN's within rtol 1e-5 (the
  dense engine's grouped convolutions round the per-node gradients
  differently from one node's);
* the CNN's rounds against the reference's dense engine with
  test_torch_round.py's tolerances (the reference holds its dense and
  sparse engines to the same contract; its own sparse tests need a jax
  that this suite does not pin);
* the metrics to rtol 1e-6 (1e-5 for the CNN): the mean over nodes is a
  sum over the ranks, in another order than the dense mean.

The executor cases (a re-plan across two trajectories, participation
masks, ``overlap="pipeline"``, the static fallback) run the perceptron in
the same session against the dense port's same dispatches, bitwise. The CLI case runs
``launch.train`` with ``--engine sparse`` on 2 ranks against the dense
CLI. Each spawn has its own time limit, so a deadlock fails one test.
"""
import functools
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core import dfl, mixing, topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.executor import RoundExecutor
from repro_torch.core.rng import ReplayDraws
from repro_torch.core.sharded import NodeGroup, local_rows, spawn
from repro_torch.core.substrate import DenseSubstrate, ShardedSubstrate
from repro_torch.data.images import SyntheticImages, image_batches_for_dfl
from repro_torch.kernels import ops
from repro_torch.models.cnn import cnn_loss
from repro_torch.optim import sgd

N, TAU1, TAU2, BATCH, LR, GAMMA, ROUNDS = 4, 2, 2, 4, 0.05, 0.6, 3
LABELS = {"dfl": None, "cdfl_topk": ("top_k", {"frac": 0.67}),
          "cdfl_qsgd": ("qsgd", {"levels": 16})}
SPAWN_TIMEOUT_S = 150.0
TOPOS = {"ring8": lambda m: m.ring(8),
         "full8": lambda m: m.fully_connected(8),
         "ring4": lambda m: m.ring(4)}


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference (JAX) modules. The ranks import this module by name,
    so JAX is imported here, in the test process only, and a rank starts
    in torch's time."""
    import jax
    import jax.numpy as jnp

    from repro.core import dfl as jdfl
    from repro.core import mixing as jmixing
    from repro.core import topology as jtopology
    from repro.core.compression import make_compressor as jmake_compressor
    from repro.core.substrate import ShardedSubstrate
    from repro.models import cnn as jcnn
    from repro.optim import sgd as jsgd
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, dfl=jdfl, mixing=jmixing, topology=jtopology,
        make_compressor=jmake_compressor, ShardedSubstrate=ShardedSubstrate,
        cnn=jcnn, sgd=jsgd)


def _fake_group(rank, world):
    return types.SimpleNamespace(rank=rank, world=world, device="cpu")


def _loss(p, b):
    return cnn_loss(p, b, "mnist")


# --- tables and weights (one process) --------------------------------------

@pytest.mark.parametrize("name", sorted(TOPOS))
def test_shift_edge_idx_and_masked_weights_match_reference(name):
    """``shift_edge_idx`` is the reference's array; per node, the masked
    shift weights are the reference's ``masked_shift_weights`` bitwise, and
    in the dense kernel's order they are ``masked_gossip_weights``' row of
    the node bitwise (the dense engine's per-round table)."""
    R = _ref()
    topo, jtopo = TOPOS[name](topology), TOPOS[name](R.topology)
    n = topo.num_nodes
    want = R.ShardedSubstrate(jtopo, ("data",)).shift_edge_idx
    rng = np.random.default_rng(n + topo.num_edges)
    masks = [np.ones(topo.num_edges, np.int32),
             rng.integers(0, 2, topo.num_edges).astype(np.int32),
             np.zeros(topo.num_edges, np.int32)]
    for r in range(n):
        sub = ShardedSubstrate(topo, _fake_group(r, n))
        np.testing.assert_array_equal(sub.shift_edge_idx, want)
        for mask in masks:
            ms = sub.shift_masks(mask)
            w_self, eff = mixing.masked_shift_weights(
                sub.shifts, sub.self_weight, [torch.tensor(m) for m in ms])
            jw_self, jeff = R.mixing.masked_shift_weights(
                jtopo.shifts(), float(jtopo.self_weights[0]),
                [R.jnp.float32(m) for m in ms])
            got = np.asarray([w_self.item()] + [e.item() for e in eff],
                             np.float32)
            ref = np.asarray([jw_self] + list(jeff), np.float32)
            assert got.tobytes() == ref.tobytes()
            # the dense order: term k is the exchange over shift -s_k
            dense_row = mixing.masked_gossip_weights(topo, mask)[r]
            order = [by for by in sub._term_shift]
            w = mixing.shift_weights(sub._terms, sub.self_weight,
                                     [ms[k] for k in order])
            assert w.tobytes() == dense_row.tobytes()


def test_misuse_raises_with_the_reference_reasons():
    """No group, a group of another size, a non-circulant C, a topology
    schedule and ``dense_power`` are refused with
    ``ValueError`` by every entry point of the sparse engine; ``auto``
    falls back to the dense engine where the sparse one is not eligible."""
    cfg = dfl.DFLConfig(tau1=2, tau2=1, topology=topology.ring(N))
    opt = sgd(0.1)
    cases = [
        (cfg, None, "process group"),
        (cfg, _fake_group(0, 3), "3 ranks but"),
        (dfl.DFLConfig(tau1=2, tau2=1, topology=topology.paper_quasi_ring()),
         _fake_group(0, 10), "not circulant"),
        (dfl.DFLConfig(tau1=2, tau2=1, topology=topology.ring(N),
                       topology_schedule=(topology.ring(N),)),
         _fake_group(0, N), "topology schedule"),
        (dfl.DFLConfig(tau1=2, tau2=1, topology=topology.ring(N),
                       mixing_impl="dense_power"),
         _fake_group(0, N), "dense_power")]
    for c, group, reason in cases:
        with pytest.raises(ValueError, match=reason):
            dfl.make_round_fn(c, _loss, opt, engine="sparse", group=group)
        with pytest.raises(ValueError, match=reason):
            RoundExecutor(c, _loss, opt, engine="sparse", group=group,
                          dynamic=c.mixing_impl == "dense")
        if c.mixing_impl == "dense":
            with pytest.raises(ValueError, match=reason):
                dfl.make_pipeline_fns(c, _loss, opt, engine="sparse",
                                      group=group)
        assert not dfl.sparse_engine_eligible(c, group)
    with pytest.raises(ValueError, match="unknown engine"):
        dfl.make_round_fn(cfg, _loss, opt, engine="bogus")
    assert dfl.sparse_engine_eligible(cfg, _fake_group(1, N))
    assert not dfl.sparse_engine_eligible(
        dfl.DFLConfig(tau1=1, tau2=1, topology=topology.disconnected(1)),
        _fake_group(0, 1))
    # auto picks dense without an eligible group, as before
    assert RoundExecutor(cfg, _loss, opt, engine="auto").engine == "dense"


# --- one 4-rank session ----------------------------------------------------

def _reference_draws(comp, rng, shapes):
    """The reference's dense-engine uniforms for every (round, step, leaf),
    stacked over nodes (test_torch_round.py's derivation)."""
    jax = _ref().jax
    names = sorted(shapes)
    table = {}
    for r in range(ROUNDS):
        comm = _ref().dfl.round_keys(rng, r)[1]
        for t in range(TAU2):
            step = jax.random.fold_in(comm, t)
            leaf_keys = [jax.random.split(jax.random.fold_in(step, i),
                                          len(names)) for i in range(N)]
            for j, name in enumerate(names):
                shape = comp.draw_shape(int(np.prod(shapes[name])))
                table[(r, t, name)] = np.stack([np.asarray(
                    jax.random.uniform(leaf_keys[i][j], shape))
                    for i in range(N)])
    return table


def _mlp_loss(p, b):
    """A two-layer perceptron on the flattened images: its per-node
    gradients are bitwise the same whether vmap runs over 1 node or N (the
    CNN's grouped convolutions are not), so whole rounds can be held
    bitwise across the engines."""
    x, y = b
    h = torch.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    return torch.nn.functional.cross_entropy(logits, y.long())


def _inputs():
    """The CNN's and the MLP's weights, the 3 rounds' batches and the QSGD
    draws (the reference's for the CNN, numpy's for the MLP)."""
    R = _ref()
    data = SyntheticImages(flavor="mnist", train_size=200, test_size=8, seed=7)
    parts = data.partition(N, seed=0)
    cnn = {k: np.asarray(v) for k, v in
           R.cnn.init_cnn(R.jax.random.key(0), "mnist").items()}
    rng = np.random.default_rng(3)
    mlp = {"w1": rng.normal(0, 0.05, (784, 32)).astype(np.float32),
           "b1": np.zeros(32, np.float32),
           "w2": rng.normal(0, 0.2, (32, 10)).astype(np.float32),
           "b2": np.zeros(10, np.float32)}
    batches = [image_batches_for_dfl(data, parts, TAU1, BATCH, r)
               for r in range(ROUNDS)]
    qsgd = make_compressor("qsgd", levels=16)
    tables = {"cnn": _reference_draws(qsgd, R.jax.random.key(1),
                                      {k: v.shape for k, v in cnn.items()}),
              "mlp": {(r, t, k): rng.random((N, v.size), np.float32)
                      for r in range(ROUNDS) for t in range(TAU2)
                      for k, v in mlp.items()}}
    return {"cnn": cnn, "mlp": mlp}, batches, tables


MODELS = {"cnn": _loss, "mlp": _mlp_loss}


def _config(label, topo=None):
    spec = LABELS[label]
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    return dfl.DFLConfig(tau1=TAU1, tau2=TAU2,
                         topology=topo or topology.ring(N),
                         compression=comp, gamma=GAMMA)


def _state(p0, rows, cfg, table):
    draws = (ReplayDraws(table, device="cpu")
             if cfg.is_compressed and cfg.compression.name == "qsgd"
             else None)
    params = params_from_jax(p0, "cpu")
    return dfl.init_state(
        {k: v.unsqueeze(0).repeat((rows,) + (1,) * v.dim())
         for k, v in params.items()},
        rows, sgd(LR), stacked=True, compressed=cfg.is_compressed,
        draws=draws)


def _torch_batches(b, group=None):
    xs, ys = (torch.from_numpy(a) for a in b)
    return local_rows((xs, ys), group, 1) if group is not None else (xs, ys)


def _rounds(model, label, p0, batches, table, group=None):
    """3 rounds of ``make_round_fn`` on the sparse engine (``group``) or the
    dense one: (params, hat, per-round metrics)."""
    cfg = _config(label)
    kw = {} if group is None else {"engine": "sparse", "group": group}
    state = _state(p0, N if group is None else 1, cfg, table)
    round_fn = dfl.make_round_fn(cfg, MODELS[model], sgd(LR), **kw)
    ms = []
    for b in batches:
        state, m = round_fn(state, _torch_batches(b, group))
        ms.append({k: float(v) for k, v in m.items()})
    return state.params, state.hat_params, ms


def _executor_runs(p0, batches, table, group=None):
    """The executor's dispatches of the MLP, on the sparse engine
    (``group``) or the dense one: a re-plan (a second trajectory), masked
    rows, the pipeline and the static fallback; returns ``{case: (params,
    hat, metrics, (builds, captures))}``."""
    rows = np.asarray([[2, 2], [1, 0], [2, 1]], np.int32)
    replan = np.asarray([[1, 2], [2, 2], [2, 0]], np.int32)
    topo = topology.ring(N)
    node = np.ones((3, N), np.int32)
    node[1, 2] = 0
    edge = np.ones((3, topo.num_edges), np.int32)
    edge[0, 1] = edge[2, 3] = 0
    masked = np.concatenate([rows, node, edge], axis=1)
    stacked = tuple(torch.stack([torch.from_numpy(b[i]) for b in batches])
                    for i in (0, 1))
    if group is not None:
        stacked = local_rows(stacked, group, 2)
    out = {}
    kw = {} if group is None else {"engine": "sparse", "group": group}
    for case, label, extra, trajs in (
            ("replan", "dfl", {}, (rows, replan)),
            ("masked", "cdfl_topk", {"participation": True}, (masked,)),
            ("pipeline", "dfl", {"overlap": "pipeline"}, (rows,)),
            ("static", "cdfl_topk", {"dynamic": False}, (rows,))):
        cfg = _config(label)
        ex = RoundExecutor(cfg, _mlp_loss, sgd(LR), **kw, **extra)
        state = _state(p0, N if group is None else 1, cfg, table)
        ms = []
        for traj in trajs:
            state, m = ex.dispatch_trajectory(state, stacked, traj)
            ms.append({k: v.clone() for k, v in m.items()})
        out[case] = (state.params, state.hat_params, ms,
                     (ex.compile_count, ex.capture_count))
    return out


def _step_inputs():
    gen = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn(N, 3, 5, 7, generator=gen),
            "b": torch.randn(N, 64, generator=gen).to(torch.bfloat16)}
    draws = ReplayDraws({(0, 0, "a"): np.random.default_rng(6).random(
        (N, 105), np.float32)}, device="cpu")
    return tree, {k: v * 0.5 for k, v in tree.items()}, draws


def _steps(sub_for, tree, hat, draws, mine=lambda t: t):
    """One plain step over ring(4) and fully_connected(4), unmasked and
    with edge 1 masked, and one TopK and one QSGD CHOCO step over ring(4),
    from the same state, on the substrate ``sub_for(topology)``."""
    out = {}
    for name, topo in (("ring4", topology.ring(N)),
                       ("full4", topology.fully_connected(N))):
        sub = sub_for(topo)
        mask = np.ones(topo.num_edges, np.int32)
        mask[1] = 0
        out[name] = (sub.mix(mine(tree)), sub.mix(mine(tree), edge_mask=mask))
    sub = sub_for(topology.ring(N))
    x, y = mine({"a": tree["a"]}), mine({"a": hat["a"]})
    for label in ("cdfl_topk", "cdfl_qsgd"):
        out[label] = sub.choco_step(_config(label).compression, x, y,
                                    sub.mix(y), GAMMA, draws, 0, 0)
    return out


def _sparse_ranks(group, out_dir, p0, batches, tables):
    """One rank: both models' plain, TopK and QSGD rounds, one gossip step
    of each kind from the same state, and the executor's dispatches."""
    ops.reset_launches()
    res = {model: {label: _rounds(model, label, p0[model], batches,
                                  tables[model], group)
                   for label in LABELS} for model in MODELS}
    res["steps"] = _steps(lambda topo: ShardedSubstrate(topo, group),
                          *_step_inputs(),
                          mine=lambda t: local_rows(t, group))
    res["executor"] = _executor_runs(p0["mlp"], batches, tables["mlp"], group)
    res["launches"] = dict(ops.LAUNCHES)
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))


def _stack(ranks, get):
    """The [N, ...] stack of every rank's [1, ...] rows of ``get(rank)``."""
    per = [get(r) for r in ranks]
    if per[0] is None:
        return None
    if isinstance(per[0], dict):
        return {k: torch.cat([p[k] for p in per]) for k in per[0]}
    return torch.cat(per)


@pytest.fixture(scope="module")
def sparse_session(tmp_path_factory):
    out = tmp_path_factory.mktemp("sparse")
    p0, batches, tables = _inputs()
    spawn(_sparse_ranks, N, (str(out), p0, batches, tables), device="cpu",
          timeout_s=SPAWN_TIMEOUT_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    return p0, batches, tables, ranks


def _same(a, b):
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _close(a, b, rtol, atol):
    for k in a:
        np.testing.assert_allclose(a[k].float().numpy(),
                                   b[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _metrics_close(ranks, get, want, rtol=1e-6):
    """Every rank's per-round metrics (the same on every rank) against
    ``want``: the mean over nodes is a sum over the ranks."""
    for r in ranks:
        for got, w in zip(get(r), want):
            for k in w:
                assert got[k] == pytest.approx(w[k], rel=rtol), k


@pytest.mark.parametrize("label", sorted(LABELS))
def test_sparse_rounds_match_dense_port(sparse_session, label):
    """The MLP's 3 rounds: bitwise the dense port for plain DFL and TopK,
    QSGD within rtol 1e-5 (K2's per-node norm, ``one_gossip_step``); the
    CNN's within rtol 1e-5: the grouped convolutions of the dense engine's
    per-node gradients round differently from one node's."""
    p0, batches, tables, ranks = sparse_session
    for model in MODELS:
        params, hat, ms = _rounds(model, label, p0[model], batches,
                                  tables[model])
        got = _stack(ranks, lambda r: r[model][label][0])
        got_hat = _stack(ranks, lambda r: r[model][label][1])
        _metrics_close(ranks, lambda r: r[model][label][2], ms,
                       1e-6 if model == "mlp" else 1e-5)
        if model == "mlp" and label != "cdfl_qsgd":
            _same(got, params)
            if hat is not None:
                _same(got_hat, hat)
        else:
            _close(got, params, 1e-5, 1e-6)
            if hat is not None:
                _close(got_hat, hat, 1e-5, 1e-6)


@pytest.mark.parametrize("label", sorted(LABELS))
def test_sparse_rounds_match_reference_dense_engine(sparse_session, label):
    """The CNN's 3 rounds against the reference's dense engine, with
    test_torch_round.py's tolerances (the reference holds its dense and
    sparse engines to the same contract), QSGD with the reference's own
    draws."""
    p0, batches, tables, ranks = sparse_session
    R, spec = _ref(), LABELS[label]
    jnp = R.jnp
    jcfg = R.dfl.DFLConfig(
        tau1=TAU1, tau2=TAU2, topology=R.topology.ring(N),
        compression=(R.make_compressor(spec[0], **spec[1]) if spec
                     else None), gamma=GAMMA)
    jstate = R.dfl.init_state(
        {k: jnp.asarray(v) for k, v in p0["cnn"].items()}, N, R.sgd(LR),
        R.jax.random.key(1), compressed=jcfg.is_compressed)
    jround = R.jax.jit(R.dfl.make_round_fn(
        jcfg, lambda p, b, k=None: R.cnn.cnn_loss(p, b, "mnist"),
        R.sgd(LR)))
    rtol, atol = (1e-4, 1e-4) if spec else (1e-5, 1e-6)
    jms = []
    for b in batches:
        jstate, jm = jround(jstate, tuple(jnp.asarray(a) for a in b))
        jms.append({k: float(v) for k, v in jm.items()})
    _metrics_close(ranks, lambda r: r["cnn"][label][2], jms, rtol)
    params = _stack(ranks, lambda r: r["cnn"][label][0])
    for k in params:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jstate.params[k]), rtol=rtol,
                                   atol=atol)


def test_one_gossip_step_matches_dense_port(sparse_session):
    """One plain step (ring and fully connected, with and without an edge
    mask, an f32 and a bf16 leaf) is bitwise ``DenseSubstrate.mix``; one
    CHOCO step from the same state is bitwise for TopK, and for QSGD
    ``x_new`` bitwise and ``y_new`` within K2's 8-ulp contract."""
    *_, ranks = sparse_session
    tree, hat, draws = _step_inputs()
    hat_a = hat["a"]
    want = _steps(DenseSubstrate, tree, hat, draws)
    for name in ("ring4", "full4"):
        for i in range(2):
            _same(_stack(ranks, lambda r: r["steps"][name][i]),
                  want[name][i])
    for label in ("cdfl_topk", "cdfl_qsgd"):
        got_x = _stack(ranks, lambda r: r["steps"][label][0])
        got_y = _stack(ranks, lambda r: r["steps"][label][1])
        _same(got_x, want[label][0])
        if label == "cdfl_topk":
            _same(got_y, want[label][1])
        else:
            # K2's contract: 8 ulps at the larger of |y|, |q|, |y_new|
            g, w = got_y["a"].numpy(), want[label][1]["a"].numpy()
            y = hat_a.numpy()
            scale = np.max([np.abs(y), np.abs(w - y), np.abs(w), np.abs(g)],
                           axis=0)
            assert np.max(np.abs(g - w) / np.spacing(scale)) <= 8.0


def test_executor_dispatches_match_dense_port(sparse_session):
    """A re-plan (two trajectories, one build), masked rows, the pipeline
    and the static fallback on the sparse engine, each against the dense
    port's same dispatch of the MLP: parameters bitwise, metrics to rtol
    1e-6, one build in the dynamic modes and one per (tau1, tau2) in the
    static fallback, no capture; on the CPU no kernel launch is counted."""
    p0, batches, tables, ranks = sparse_session
    dense = _executor_runs(p0["mlp"], batches, tables["mlp"])
    for case, (params, hat, ms, _) in dense.items():
        _same(_stack(ranks, lambda r: r["executor"][case][0]), params)
        if hat is not None:
            _same(_stack(ranks, lambda r: r["executor"][case][1]), hat)
        builds = {"static": 3}.get(case, 1)
        for r in ranks:
            assert r["executor"][case][3] == (builds, 0)
            for got, want in zip(r["executor"][case][2], ms):
                for k in want:
                    np.testing.assert_allclose(got[k].numpy(),
                                               want[k].numpy(), rtol=1e-6)
    assert all(r["launches"] == dict.fromkeys(ops.LAUNCHES, 0)
               for r in ranks)


# --- the CLI on 2 ranks ----------------------------------------------------

CLI_ARGV = ["--arch", "qwen3-1.7b", "--nodes", "2", "--rounds", "2",
            "--device", "cpu", "--batch", "1", "--seq", "16", "--tau1", "2",
            "--tau2", "2", "--superstep", "1", "--compression", "top_k"]


def _cli_ranks(group, out_dir, argv):
    from repro_torch.launch import train

    args = train.parse_args(argv)
    got = train.run(args, group=group, log=lambda _m: None)
    torch.save({"rows": [{k: v for k, v in row.items()
                          if k in ("loss", "consensus_sq")}
                         for row in got["rows"]],
                "engine": got["engine"],
                "params": got["state"].params},
               os.path.join(out_dir, f"cli{group.rank}.pt"))


def test_cli_engine_sparse_matches_dense_cli(tmp_path):
    """``--engine sparse`` on the reduced Qwen3, 2 ranks of 1 node, 2
    rounds of C-DFL TopK, against the dense CLI: losses and consensus
    within test_torch_lm_train.py's tolerances against the reference's
    dense engine (rtol 1e-5 and 1e-4), the parameters within 1e-5."""
    from repro_torch.launch import train

    spawn(_cli_ranks, 2, (str(tmp_path), CLI_ARGV), device="cpu",
          timeout_s=SPAWN_TIMEOUT_S)
    got = [torch.load(tmp_path / f"cli{r}.pt", weights_only=False)
           for r in range(2)]
    want = train.run(train.parse_args(CLI_ARGV + ["--engine", "dense"]),
                     log=lambda _m: None)
    assert want["engine"] == "dense"
    assert all(g["engine"] == "sparse" for g in got)
    for g in got:
        for a, b in zip(g["rows"], want["rows"]):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["consensus_sq"] == pytest.approx(b["consensus_sq"],
                                                      rel=1e-4)
    params = _stack(got, lambda g: g["params"])
    for k in params:
        np.testing.assert_allclose(params[k].float().numpy(),
                                   want["state"].params[k].float().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_cli_engine_sparse_needs_eligible_group():
    """Outside a node group (or with a non-circulant topology) ``--engine
    sparse`` raises the reference's reason; ``auto`` runs dense. In a node
    group the dense engine is refused: every rank would run all N nodes."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="sparse engine needs #ranks"):
        train.run(train.parse_args(CLI_ARGV + ["--engine", "sparse"]),
                  log=lambda _m: None)
    with pytest.raises(ValueError, match="topology=paper-quasi-ring"):
        train.run(train.parse_args(
            CLI_ARGV + ["--engine", "sparse", "--topology", "quasi"]),
            group=_fake_group(0, 2), log=lambda _m: None)
    with pytest.raises(ValueError, match="own clock"):
        train.run(train.parse_args(
            CLI_ARGV + ["--engine", "sparse", "--plan-budget", "5"]),
            group=NodeGroup(0, 2, "cpu", "gloo"), log=lambda _m: None)
    # in a node group, auto with the planner takes the dense engine, which
    # a multi-rank launch refuses, as it refuses --engine dense
    for extra in (["--plan-budget", "5"], ["--engine", "dense"]):
        with pytest.raises(ValueError, match="launch it as one process"):
            train.run(train.parse_args(CLI_ARGV + extra),
                      group=NodeGroup(0, 2, "cpu", "gloo"),
                      log=lambda _m: None)
