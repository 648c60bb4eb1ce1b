"""The port's LM zoo (``repro_torch.models``, ``repro_torch.configs``)
against the reference (``repro.models``, ``repro.configs``).

What is held here, each with its tolerance:

* The parameter trees: the port's ``init_params`` makes the reference's
  leaves (keys = the reference's joined tree paths, in its leaf order),
  shapes and dtypes, for the ten reduced configs, and ``param_count``
  equals the reference's for the ten full ones.
* ``train_loss`` and its gradients for all ten reduced architectures, the
  reference's weights carried across by ``convert.params_from_jax`` and
  the same numpy batches: in f32 the loss to rtol 1e-6 and every leaf's
  gradient to 2e-5 of that leaf's largest gradient (matmul reductions are
  ordered differently, never bitwise); in bf16 (the configs' own dtype)
  the loss to rtol 1e-3 and each gradient to 5e-2 of its largest (bf16's
  8-bit mantissa rounds every product and activation).
* The primitives (``rms_norm``, ``rope``, ``softcap`` to 1e-6, ``swiglu``
  to 1e-5) and the chunked attention (windows, soft cap, several chunks,
  cross-attention) against the reference's to 1e-5; the mamba mixer's
  log-step scan against the reference's associative scan to 1e-5; the MoE
  dispatch, capacity drops included, to 1e-4.
* The training-path cases of ``tests/test_models.py``: the sliding window
  restricts attention, causality, the chunked mamba equals the unchunked,
  the MoE without drops equals a dense mixture, capacity drops tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _key_of
from repro.configs import REGISTRY as JREGISTRY
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.models import init_params as jinit_params
from repro.models import train_loss as jtrain_loss
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaf_order
from repro_torch.models import (LayerSpec, ModelConfig, common, forward,
                                init_params, train_loss)
from repro_torch.models import attention, mamba, moe

ARCHS = sorted(REGISTRY)
KW = dict(attn_q_chunk=8, attn_kv_chunk=8, loss_seq_chunk=8, ssm_chunk=4)


def _cfgs(arch, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(JREGISTRY[arch].reduced, dtype=jdt),
            dataclasses.replace(REGISTRY[arch].reduced, dtype=tdt))


def _batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32)}
    if cfg.has_memory_input:
        batch["memory"] = rng.standard_normal(
            (b, cfg.memory_tokens or 16, cfg.memory_dim or cfg.d_model)
        ).astype(np.float32)
    return batch


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_reference_tree(arch):
    jp, jaxes = jinit_params(JREGISTRY[arch].reduced, jax.random.key(0))
    p, axes = init_params(REGISTRY[arch].reduced,
                          torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert list(p) == [_key_of(path) for path, _ in flat]
    assert list(p) == leaf_order(p)
    for (path, leaf), (name, t) in zip(flat, p.items()):
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), name
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    jax_axes = jax.tree_util.tree_leaves(jaxes, is_leaf=is_axes)
    assert list(axes.values()) == jax_axes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference_full_config(arch):
    assert REGISTRY[arch].model.param_count() == \
        JREGISTRY[arch].model.param_count()
    assert REGISTRY[arch].model.active_param_count() == \
        JREGISTRY[arch].model.active_param_count()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    jp, _ = jinit_params(jcfg, jax.random.key(0))
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    batch = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda q: jtrain_loss(
        q, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = train_loss(leaves, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg)
    loss.backward()
    loss_rtol, grad_tol = (1e-6, 2e-5) if dtype == "f32" else (1e-3, 5e-2)
    assert np.isfinite(float(loss))
    assert float(loss) == pytest.approx(float(jloss), rel=loss_rtol)
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = _key_of(path)
        want = _f32(jg)
        got = (np.zeros_like(want) if leaves[name].grad is None
               else leaves[name].grad.float().numpy())
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= grad_tol * scale, name


def test_primitives_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        common.rope(torch.from_numpy(x), torch.from_numpy(pos)[None],
                    1e4).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos)[None],
                                1e4)), rtol=1e-6, atol=1e-6)
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((8, 12), (8, 12), (12, 8))]
    np.testing.assert_allclose(
        common.swiglu(torch.from_numpy(h),
                      *map(torch.from_numpy, ws)).numpy(),
        np.asarray(jcommon.swiglu(jnp.asarray(h), *map(jnp.asarray, ws))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        common.softcap(torch.from_numpy(h), 2.5).numpy(),
        np.asarray(jcommon.softcap(jnp.asarray(h), 2.5)), rtol=1e-6)
    assert common.pad_vocab(151936) == jcommon.pad_vocab(151936) == 151936
    assert common.pad_vocab(49155) == jcommon.pad_vocab(49155)


@pytest.mark.parametrize("case", [
    dict(s=16, t=16, qc=4, kc=8, window=0, cap=0.0, causal=True),
    dict(s=16, t=16, qc=8, kc=4, window=5, cap=0.0, causal=True),
    dict(s=12, t=12, qc=12, kc=12, window=0, cap=3.0, causal=True),
    dict(s=16, t=16, qc=16, kc=16, window=6, cap=0.0, causal=True),
    dict(s=8, t=6, qc=4, kc=3, window=0, cap=0.0, causal=False),
], ids=["chunks", "window", "single_cap", "single_window", "cross"])
def test_chunked_attention_matches_reference(case):
    rng = np.random.default_rng(5)
    b, h, kvh, hd = 2, 4, 2, 8
    q = rng.standard_normal((b, case["s"], h, hd)).astype(np.float32)
    k = rng.standard_normal((b, case["t"], kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, case["t"], kvh, hd)).astype(np.float32)
    qp = np.arange(case["s"], dtype=np.int32)
    kp = np.arange(case["t"], dtype=np.int32)
    if not case["causal"]:
        qp, kp = np.zeros_like(qp), np.zeros_like(kp)
    kw = dict(causal=case["causal"], window=case["window"], cap=case["cap"],
              q_chunk=case["qc"], kv_chunk=case["kc"])
    got = attention.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(qp),
        kv_positions=torch.from_numpy(kp), **kw)
    want = jattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qp),
        kv_positions=jnp.asarray(kp), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _ssm_cfg(chunk, mod=ModelConfig, dtype=torch.float32):
    return mod(name="s", arch_type="ssm", num_layers=1, d_model=32,
               num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
               vocab_size=64, ssm_state=4, dtype=dtype,
               **{**KW, "ssm_chunk": chunk})


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_mamba_mixer_matches_reference_scan(chunk):
    """The log-step scan against the reference's associative scan, the
    same f32 weights and inputs, 1e-5 (ssm_chunk 5 falls to 4 on 16)."""
    jcfg = _ssm_cfg(chunk, jcommon.ModelConfig, jnp.float32)
    f = jcommon.ParamFactory(jax.random.key(0), jnp.float32)
    jp, _ = jcommon.split_annotations(jmamba.mamba_params(f, jcfg))
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32)
    want = jmamba.mamba_mixer(jp, jnp.asarray(x), jcfg)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = mamba.mamba_mixer(p, torch.from_numpy(x), _ssm_cfg(chunk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _dense_cfg(**over):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=128, dtype=torch.float32, **KW)
    base.update(over)
    return ModelConfig(**base)


def _tokens(seed, s=16):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 128, (1, s)).astype(np.int64))


def test_sliding_window_restricts_attention():
    """A token beyond the window cannot influence the output (receptive
    field 2 layers x (4 - 1) = 6: position 15 unaffected by position 0)."""
    cfg = _dense_cfg(pattern=(LayerSpec(window=4),))
    params, _ = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(1)
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % 128
    h1, _ = forward(params, toks, cfg)
    h2, _ = forward(params, toks2, cfg)
    np.testing.assert_allclose(h1[0, 15].numpy(), h2[0, 15].numpy(),
                               atol=1e-5)
    assert float((h1[0, 2] - h2[0, 2]).abs().max()) > 1e-6


def test_causality():
    """Future tokens never influence past positions."""
    cfg = _dense_cfg()
    params, _ = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(1)
    toks2 = toks.clone()
    toks2[0, 10] = (toks[0, 10] + 1) % 128
    h1, _ = forward(params, toks, cfg)
    h2, _ = forward(params, toks2, cfg)
    np.testing.assert_allclose(h1[0, :10].numpy(), h2[0, :10].numpy(),
                               atol=1e-5)
    assert float((h1[0, 10:] - h2[0, 10:]).abs().max()) > 1e-6


def test_mamba_chunked_equals_unchunked():
    """Chunks of 4 chained by the carry equal one chunk of 16 (1e-4)."""
    cfg = _ssm_cfg(4)
    f = common.ParamFactory(torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
    p, _ = common.split_annotations(mamba.mamba_params(f, cfg))
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    y1 = mamba.mamba_mixer(p, x, cfg)
    y2 = mamba.mamba_mixer(p, x, _ssm_cfg(16))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)


def _moe_cfg(cf):
    return ModelConfig(name="m", arch_type="moe", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
                       vocab_size=128, num_experts=4, experts_per_token=2,
                       capacity_factor=cf, dtype=torch.float32, **KW)


def _moe_params():
    params, _ = init_params(_moe_cfg(8.0), torch.Generator().manual_seed(0),
                            "cpu")
    return {k: v[0] for k, v in common.sub_tree(params,
                                                "blocks/0/ffn").items()}


def test_moe_matches_dense_reference_no_drops():
    """With room for every token the dispatch equals the dense mixture of
    the top-2 experts by their renormalized gates (1e-4)."""
    pm = _moe_params()
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(5))
    out, aux = moe.moe_ffn(pm, x, _moe_cfg(8.0))
    probs = torch.softmax(x @ pm["router"], -1)
    gv, gi = torch.topk(probs, 2, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for e in range(4):
        h = torch.nn.functional.silu(x @ pm["w_gate"][e]) * (
            x @ pm["w_up"][e])
        w = ((gi == e) * gv).sum(-1)
        ref = ref + w[..., None] * (h @ pm["w_down"][e])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) > 0


def test_moe_capacity_drops_tokens():
    """With capacity_factor << 1 some tokens are dropped."""
    pm = _moe_params()
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(5))
    full, _ = moe.moe_ffn(pm, x, _moe_cfg(8.0))
    tight, _ = moe.moe_ffn(pm, x, _moe_cfg(0.25))
    n_full = int(torch.any(full != 0, -1).sum())
    n_tight = int(torch.any(tight != 0, -1).sum())
    assert n_tight < n_full


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_matches_reference(cf):
    """The port's dispatch against the reference's, capacity drops
    included, the same f32 weights and inputs (1e-4, the reference's own
    MoE tolerance: outputs reach 70 from sums over 64 features)."""
    from repro.models.moe import moe_ffn as jmoe_ffn

    pm = _moe_params()
    x = np.random.default_rng(6).standard_normal((2, 64, 64)).astype(
        np.float32)
    jcfg = dataclasses.replace(
        jcommon.ModelConfig(name="m", arch_type="moe", num_layers=2,
                            d_model=64, num_heads=4, num_kv_heads=2,
                            head_dim=16, d_ff=32, vocab_size=128,
                            num_experts=4, experts_per_token=2,
                            dtype=jnp.float32, **KW), capacity_factor=cf)
    want, jaux = jmoe_ffn({k: jnp.asarray(v.numpy()) for k, v in pm.items()},
                          jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(pm, torch.from_numpy(x), _moe_cfg(cf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
