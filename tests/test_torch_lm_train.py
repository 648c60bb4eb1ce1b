"""The LM round and the train CLI on the port (``repro_torch.launch.
train``, ``repro_torch.core`` over ``repro_torch.models``), against the
reference.

What is held here, each with its tolerance:

* Two DFL rounds of reduced Qwen3 (4 nodes on ring(4), tau (2, 2), batch
  2, seq 16) through the port's dense engine against the reference's
  ``make_round_fn(engine="dense")``, the reference's weights carried
  across and the same numpy batches: in f32, plain DFL to rtol 1e-5 on
  the loss and consensus and 1e-5 (absolute, on weights of order 0.1) on
  every parameter, C-DFL QSGD with the reference's own draws replayed
  (``ReplayDraws``) to 1e-4, but for QSGD level flips (a level moves by
  one where a gap's scaled magnitude plus its noise lies within an ulp of
  an integer and the two gaps differ in the last ulp): at most one
  element in 1e5 of a leaf, four in the run (one is seen); in bf16, plain
  DFL to 1e-2.
* The executor's replayed dispatch of the same rounds is bitwise the
  eager rounds (the CPU path of its step graphs).
* ``train.main`` on the CPU: two runs give bitwise-equal checkpoints and
  losses (dense; and batched with faults and sampled cohorts); a restart
  from ``--ckpt-dir`` continues bitwise, as the reference's CLI restores
  the parameters (plain DFL); a full-state checkpoint (parameters,
  optimizer, CHOCO estimates, round index) through the port's
  ``checkpoint`` resumes a C-DFL QSGD run bitwise (the reference's
  ``test_checkpoint_restart_with_choco_hat``).
* ``NodeSubstrate.consensus_sq`` adds the leaves in the reference's leaf
  order whatever the dict's order (``blocks/2`` before ``blocks/10``):
  bitwise the same for a dict built in another order, and within 1e-6 of
  the reference's on the nested tree.
* The flags that wait for other items raise with their item's text.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _key_of
from repro.configs import REGISTRY as JREGISTRY
from repro.core import DFLConfig as JDFLConfig
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake_compressor
from repro.core import make_round_fn as jmake_round_fn
from repro.core import ring as jring
from repro.core.dfl import round_keys as jround_keys
from repro.data.lm import SyntheticLM as JSyntheticLM
from repro.data.lm import lm_batches_for_dfl as jlm_batches
from repro.models import init_params as jinit_params
from repro.models import train_loss as jtrain_loss
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                              make_compressor, make_round_fn, ring,
                              stack_round_batches)
from repro_torch.core.rng import ReplayDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.core.tree import leaf_order
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
from repro_torch.models import init_params, train_loss
from repro_torch.optim import sgd

ARCH = "qwen3-1.7b"
N, TAU1, TAU2, B, S, LR, GAMMA, ROUNDS = 4, 2, 2, 2, 16, 3e-2, 0.1, 2


def _reference_draws(comp, rng, params):
    """The uniforms the reference's dense engine draws for every (round,
    gossip step, leaf): node key = fold_in(fold_in(comm key, t), i), leaf
    keys = split(node key, n_leaves) in the reference's leaf order."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [_key_of(p) for p, _ in flat]
    sizes = [int(np.prod(leaf.shape)) for _, leaf in flat]
    table = {}
    for r in range(ROUNDS):
        comm = jround_keys(rng, r)[1]
        for t in range(TAU2):
            step = jax.random.fold_in(comm, t)
            keys = [jax.random.split(jax.random.fold_in(step, i), len(names))
                    for i in range(N)]
            for j, (name, d) in enumerate(zip(names, sizes)):
                table[(r, t, name)] = np.stack([np.asarray(
                    jax.random.uniform(keys[i][j], comp.draw_shape(d)))
                    for i in range(N)])
    return table


def _run_both(compression, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = dataclasses.replace(JREGISTRY[ARCH].reduced, dtype=jdt)
    model = dataclasses.replace(REGISTRY[ARCH].reduced, dtype=tdt)
    p0, _ = jinit_params(jmodel, jax.random.key(0))
    rng = jax.random.key(1)
    jcomp = jmake_compressor(compression) if compression else None
    comp = make_compressor(compression) if compression else None
    jcfg = JDFLConfig(tau1=TAU1, tau2=TAU2, topology=jring(N),
                      compression=jcomp, gamma=GAMMA)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=ring(N),
                    compression=comp, gamma=GAMMA)
    jstate = jinit_state(p0, N, jsgd(LR), rng, compressed=comp is not None)
    draws = (ReplayDraws(_reference_draws(comp, rng, p0), "cpu")
             if compression == "qsgd" else None)
    state = init_state(
        params_from_jax(jax.tree_util.tree_map(np.asarray, p0), "cpu"), N,
        sgd(LR), compressed=comp is not None, draws=draws)
    jround = jax.jit(jmake_round_fn(
        jcfg, lambda p, b, k=None: jtrain_loss(p, b, jmodel), jsgd(LR),
        engine="dense"))
    round_fn = make_round_fn(cfg, lambda p, b: train_loss(p, b, model),
                             sgd(LR))
    corpus = JSyntheticLM(vocab_size=jmodel.vocab_size, num_nodes=N)
    rows = []
    for r in range(ROUNDS):
        batch = {k: np.array(v) for k, v in
                 jlm_batches(corpus, TAU1, N, B, S, r).items()}
        jstate, jm = jround(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = round_fn(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        rows.append((float(jm["loss"]), float(m["loss"]),
                     float(jm["consensus_sq"]), float(m["consensus_sq"])))
    return rows, jstate, state


@pytest.mark.parametrize("compression,dtype", [
    ("", "f32"), ("qsgd", "f32"), ("", "bf16")],
    ids=["dfl_f32", "cdfl_qsgd_f32", "dfl_bf16"])
def test_rounds_match_reference_dense_engine(compression, dtype):
    rtol = {"f32": 1e-4 if compression else 1e-5, "bf16": 1e-2}[dtype]
    ops.reset_launches()
    rows, jstate, state = _run_both(compression, dtype)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    for jl, tl, jc, tc in rows:
        assert np.isfinite(tl) and np.isfinite(tc)
        assert tl == pytest.approx(jl, rel=rtol)
        assert tc == pytest.approx(jc, rel=rtol)
    trees = [(jstate.params, state.params)]
    if compression:
        trees.append((jstate.hat_params, state.hat_params))
    flips = 0
    for jtree, tree in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            got = tree[_key_of(path)].float().numpy()
            want = np.asarray(leaf).astype(np.float32)
            off = np.abs(got - want) > rtol
            if compression:     # QSGD level flips: one in 1e5 at most
                flips += int(off.sum())
                assert off.sum() <= max(1, off.size // 100_000), \
                    _key_of(path)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=rtol,
                                           err_msg=_key_of(path))
    assert flips <= 4


@pytest.mark.parametrize("compression", ["", "qsgd", "top_k"])
def test_executor_dispatch_bitwise_eager_rounds(compression):
    """A K = 2 dispatch of the executor (its step graphs, run eagerly on
    the CPU) against two ``make_round_fn`` rounds from the same state."""
    model = REGISTRY[ARCH].reduced
    comp = make_compressor(compression) if compression else None
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=ring(N),
                    compression=comp, gamma=GAMMA)
    p0, _ = init_params(model, torch.Generator().manual_seed(0),
                              "cpu")

    def loss_fn(p, b):
        return train_loss(p, b, model)

    def fresh():
        return init_state(p0, N, sgd(LR), compressed=comp is not None,
                          seed=4)

    corpus = SyntheticLM(vocab_size=model.vocab_size, num_nodes=N)
    rounds = [lm_batches_for_dfl(corpus, TAU1, N, B, S, r)
              for r in range(2)]
    round_fn = make_round_fn(cfg, loss_fn, sgd(LR), dynamic_taus=True)
    eager, losses = fresh(), []
    for b in rounds:
        eager, m = round_fn(eager, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, TAU1, TAU2)
        losses.append(m["loss"])
    ex = RoundExecutor(cfg, loss_fn, sgd(LR))
    batches = stack_round_batches(rounds, TAU1, "cpu")
    ex.warmup(fresh(), batches)
    state, metrics = ex.dispatch(fresh(), batches, TAU1, TAU2)
    assert ex.compile_count == 1
    assert torch.equal(metrics["loss"], torch.stack(losses))
    for name, t in state.params.items():
        assert torch.equal(t, eager.params[name]), name


def _argv(tmp, *extra):
    return ["--arch", ARCH, "--nodes", "4", "--tau1", "2", "--tau2", "2",
            "--batch", "1", "--seq", "16", "--superstep", "2",
            "--log-every", "10", "--device", "cpu", "--ckpt-dir", str(tmp),
            *extra]


def _final(tmp, template):
    params, step = restore_checkpoint(str(tmp), template)
    return params, step


def _same(a, b):
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("compression", ["", "qsgd"])
def test_train_twice_bitwise_checkpoints(tmp_path, compression):
    extra = ["--compression", compression, "--gamma", "0.1"] \
        if compression else []
    a = train.main(_argv(tmp_path / "a", "--rounds", "2", *extra))
    b = train.main(_argv(tmp_path / "b", "--rounds", "2", *extra))
    assert [r["loss"] for r in a["rows"]] == [r["loss"] for r in b["rows"]]
    assert all(np.isfinite(r["loss"]) for r in a["rows"])
    assert a["builds_after_warmup"] == 0 and a["captures_after_warmup"] == 0
    template = a["state"].params
    pa, sa = _final(tmp_path / "a", template)
    pb, sb = _final(tmp_path / "b", template)
    assert sa == sb == 2
    assert _same(pa, pb)
    assert _same(pa, a["state"].params)


def test_restart_from_checkpoint_continues_bitwise(tmp_path):
    """Four rounds in one run against two, then two more restored from the
    checkpoint (the reference's CLI restores the parameters; plain DFL
    draws nothing and SGD keeps no slots, so the runs agree bitwise)."""
    whole = train.main(_argv(tmp_path / "whole", "--rounds", "4"))
    train.main(_argv(tmp_path / "split", "--rounds", "2"))
    resumed = train.main(_argv(tmp_path / "split", "--rounds", "2"))
    assert resumed["start_round"] == 2
    assert [r["round"] for r in resumed["rows"]] == [2, 3]
    assert [r["loss"] for r in resumed["rows"]] == \
        [r["loss"] for r in whole["rows"][2:]]
    template = whole["state"].params
    pw, sw = _final(tmp_path / "whole", template)
    ps, ss = _final(tmp_path / "split", template)
    assert sw == ss == 4 and _same(pw, ps)


def test_batched_faults_train_twice_identical(tmp_path):
    """The batched engine over a sampled cohort with injected faults: the
    lazy corpus, the prefetch thread, the cohort draws and the masks are
    pinned, so two runs give the same rows; the build and the captures all
    happen in the warmup."""
    argv = ["--arch", ARCH, "--nodes", "4", "--rounds", "4", "--batch", "1",
            "--seq", "16", "--virtual-nodes", "16", "--cohort", "4",
            "--cohort-seed", "3", "--tau1", "1", "--tau2", "1",
            "--superstep", "2", "--device", "cpu", "--log-every", "2",
            "--faults",
            '{"faults": [{"kind": "sporadic", "p_node": 0.8, '
            '"p_edge": 0.9, "r_start": 0, "r_stop": 100}], "seed": 7}']
    a, b = train.main(argv), train.main(argv)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "round_s"}  # noqa: E731
                          for r in rows]
    assert strip(a["rows"]) == strip(b["rows"]) and len(a["rows"]) == 4
    assert a["engine"] == "batched" and a["builds_after_warmup"] == 0
    assert all(0 < r["active_nodes"] <= 4 for r in a["rows"])


def test_full_state_checkpoint_resumes_cdfl_bitwise(tmp_path):
    """C-DFL QSGD: rounds 2..3 from a checkpoint of the whole state
    (params, optimizer, CHOCO estimates, round index) equal the
    uninterrupted run bitwise, estimates included."""
    model = REGISTRY[ARCH].reduced
    comp = make_compressor("qsgd", levels=4)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=ring(N), compression=comp,
                    gamma=0.5)
    p0, _ = init_params(model, torch.Generator().manual_seed(0),
                              "cpu")

    def loss_fn(p, b):
        return train_loss(p, b, model)

    def fresh():
        return init_state(p0, N, sgd(LR), compressed=True, seed=9)

    corpus = SyntheticLM(vocab_size=model.vocab_size, num_nodes=N)
    batches = stack_round_batches(
        [lm_batches_for_dfl(corpus, TAU1, N, B, S, r)
         for r in range(4)], TAU1, "cpu")
    half = lambda sl: {k: v[sl] for k, v in batches.items()}  # noqa: E731
    ex = RoundExecutor(cfg, loss_fn, sgd(LR), donate=False)
    ref, _ = ex.dispatch(fresh(), batches, TAU1, TAU2)
    mid, _ = ex.dispatch(fresh(), half(slice(0, 2)), TAU1, TAU2)
    tree = {"params": mid.params, "opt_state": mid.opt_state,
            "hat_params": mid.hat_params,
            "round_idx": torch.tensor(mid.round_idx)}
    save_checkpoint(str(tmp_path), 2, tree, {})
    start = fresh()
    template = {"params": start.params, "opt_state": start.opt_state,
                "hat_params": start.hat_params,
                "round_idx": torch.tensor(0)}
    got, step = restore_checkpoint(str(tmp_path), template)
    assert step == 2 and int(got["round_idx"]) == 2
    resumed = start._replace(params=got["params"],
                             opt_state=got["opt_state"],
                             hat_params=got["hat_params"],
                             round_idx=int(got["round_idx"]))
    end, _ = RoundExecutor(cfg, loss_fn, sgd(LR), donate=False).dispatch(
        resumed, half(slice(2, 4)), TAU1, TAU2)
    assert _same(end.params, ref.params)
    assert _same(end.hat_params, ref.hat_params)
    assert torch.equal(end.opt_state["step"], ref.opt_state["step"])


@pytest.mark.parametrize("flag,item", [
    (["--telemetry-out", "x"], 9), (["--history-out", "x"], 9),
    (["--profile-dir", "x"], 9), (["--engine", "sparse"], 6)])
def test_flags_waiting_for_other_items_raise(tmp_path, flag, item):
    """``--engine sparse`` outside a node group of --nodes ranks raises the
    reference's reason (tests/test_torch_sharded.py runs it under one).
    Item 9's three flags are ported: each writes its file, and the file
    validates (the event stream under the reference's ``repro.obs``
    too)."""
    argv = ["--arch", ARCH, "--rounds", "2", "--device", "cpu", "--batch",
            "1", "--seq", "16", "--tau1", "1", "--tau2", "1",
            "--superstep", "1"]
    if item == 6:
        with pytest.raises(ValueError, match="sparse engine needs #ranks"):
            train.main(argv + flag)
        return
    from repro.obs import validate_stream as jvalidate_stream
    from repro_torch.obs import (HISTORY_SCHEMA_VERSION, history_view,
                                 read_events, validate_stream)

    path = tmp_path / "out"
    out = train.main(argv + [flag[0], str(path)])
    if flag[0] == "--telemetry-out":
        events = read_events(str(path))
        assert events == out["events"]
        assert validate_stream(events) == [] == jvalidate_stream(events)
        types = {e["type"] for e in events}
        assert {"run", "compile", "superstep", "round", "counters",
                "flush", "prefetch"} <= types
        assert sum(e["type"] == "round" for e in events) == 2
    elif flag[0] == "--history-out":
        with open(path) as f:
            h = json.load(f)
        assert h == history_view(out["events"])
        assert h["schema_version"] == HISTORY_SCHEMA_VERSION
        assert h["round"] == [1, 2] and h["schedule"] == [[1, 1], [1, 1]]
        assert h["compile_count"] == h["compile_count_warmup"] == 1
    else:
        with open(path / "trace.json") as f:
            trace = json.load(f)
        assert trace["traceEvents"]


def test_use_kernels_and_static_dispatch_run(tmp_path):
    """--use-kernels changes nothing on the port; --dispatch static builds
    and captures one round per (tau1, tau2): one build and one graph set
    here."""
    base = ["--arch", ARCH, "--nodes", "4", "--rounds", "2", "--batch", "1",
            "--seq", "16", "--tau1", "1", "--tau2", "1", "--superstep", "1",
            "--device", "cpu", "--compression", "top_k"]
    a = train.main(base)
    b = train.main(base + ["--use-kernels"])
    c = train.main(base + ["--dispatch", "static"])
    assert [r["loss"] for r in a["rows"]] == [r["loss"] for r in b["rows"]]
    np.testing.assert_allclose([r["loss"] for r in c["rows"]],
                               [r["loss"] for r in a["rows"]], rtol=1e-5)
    assert c["compile_count"] == 1 and c["capture_count"] == 1


def test_consensus_sums_in_reference_leaf_order():
    from repro.core.substrate import DenseSubstrate as JDenseSubstrate

    rng = np.random.default_rng(2)
    nested = {"blocks": [{"w": rng.standard_normal((N, 3, 5)) * 10.0 ** i,
                          "b": rng.standard_normal((N, 7)) * 0.1}
                         for i in range(-3, 9)],
              "embed": rng.standard_normal((N, 11)) * 1e3,
              "a_log": rng.standard_normal((N, 2))}
    nested = jax.tree_util.tree_map(lambda a: a.astype(np.float32), nested)
    flat = params_from_jax(nested, "cpu")
    names = [_key_of(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(nested)[0]]
    assert list(flat) == names == leaf_order(reversed(names))
    assert names.index("blocks/2/w") < names.index("blocks/10/w")
    sub = DenseSubstrate(ring(N))
    want = sub.consensus_sq(flat)
    shuffled = {k: flat[k] for k in reversed(list(flat))}
    assert torch.equal(sub.consensus_sq(shuffled), want)
    dev = None
    for name in names:     # the reference's order, written out
        x = flat[name].float()
        d = ((x - x.mean(dim=0)) ** 2).reshape(N, -1).sum(dim=1)
        dev = d if dev is None else dev + d
    assert torch.equal(dev.mean(dim=0), want)
    jwant = JDenseSubstrate(jring(N)).consensus_sq(
        jax.tree_util.tree_map(jnp.asarray, nested))
    assert float(want) == pytest.approx(float(jwant), rel=1e-6)
