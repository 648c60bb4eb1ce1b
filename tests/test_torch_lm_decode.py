"""The port's serving path of the LM zoo (``prefill``, ``decode_step``, the
KV cache, the sliding-window ring buffer and the SSM state) against the
reference's.

What is held here, each with its tolerance:

* ``tests/test_models.py``'s decode cases on the port, the reference's
  weights carried across by ``convert.params_from_jax``: prefill's logits
  and one decode step's equal ``forward``'s at the same positions to the
  reference's 2e-4 (qk-norm, a window of 8 that the prompt outruns, mamba,
  MoE without drops); the mamba mixer's scan equals the recurrent decode
  step token by token (rtol 1e-4, atol 1e-5).
* ``tests/test_arch_smoke.py``'s reduced decode round trip for the ten
  architectures: logits ``[B, pad_vocab(V)]``, finite, position 19.
* For each reduced architecture (and the reduced Gemma3 with a window of
  8, so the ring buffer wraps in prefill and again in decode), in f32 and
  bf16: prefill and 3 decode steps, the same numpy tokens fed to both
  packages, against the reference's. Each step's logits and every state
  leaf (``k``, ``v``, ``conv``, ``ssm``, ``memory``) within 1e-5 (f32) or
  5e-2 (bf16) of the leaf's largest magnitude; ``pos`` and ``position``
  exactly. The reference's prefill state, carried across by
  ``convert.decode_state_from_jax``, is bitwise its numpy leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models import LayerSpec as JLayerSpec
from repro.models import ModelConfig as JModelConfig
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import mamba as jmamba
from repro.models import prefill as jprefill
from repro.models.common import ParamFactory as JParamFactory
from repro.models.common import split_annotations as jsplit
from repro_torch.configs import REGISTRY
from repro_torch.convert import decode_state_from_jax, params_from_jax
from repro_torch.models import (LayerSpec, ModelConfig, decode_step, forward,
                                init_params, mamba, pad_vocab, prefill)
from repro_torch.models.transformer import _unembed

ARCHS = sorted(REGISTRY)
KW = dict(attn_q_chunk=8, attn_kv_chunk=8, loss_seq_chunk=8, ssm_chunk=4)


def _pair(**kw):
    """The same small config in both packages, f32."""
    jkw = dict(kw)
    if "pattern" in kw:
        jkw["pattern"] = tuple(JLayerSpec(**dataclasses.asdict(s))
                               for s in kw["pattern"])
    return (JModelConfig(dtype=jnp.float32, **jkw, **KW),
            ModelConfig(dtype=torch.float32, **kw, **KW))


def _dense(**over):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=128)
    base.update(over)
    return _pair(**base)


def _ref_params(jcfg):
    jp, _ = jinit_params(jcfg, jax.random.key(0))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("cfgs", [
    _dense(qk_norm=True),
    _dense(pattern=(LayerSpec(window=8), LayerSpec())),
    _pair(name="ssm", arch_type="ssm", num_layers=2, d_model=64,
          num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=128,
          ssm_state=8, pattern=(LayerSpec(mixer="mamba", ffn="none"),)),
    _pair(name="moe-nodrop", arch_type="moe", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
          num_experts=4, experts_per_token=2, capacity_factor=8.0),
], ids=["qknorm", "window", "mamba", "moe"])
def test_decode_matches_forward(cfgs):
    """prefill(s) + decode(s+1) logits == full forward logits."""
    jcfg, cfg = cfgs
    _, p = _ref_params(jcfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 128, (2, 12)).astype(np.int32))
    h, _ = forward(p, toks, cfg)
    full = _unembed(p, h, cfg)
    lg_pre, st = prefill(p, {"tokens": toks[:, :11]}, cfg, max_len=16)
    np.testing.assert_allclose(lg_pre.numpy(), full[:, 10].numpy(),
                               rtol=2e-4, atol=2e-4)
    lg_dec, _ = decode_step(p, st, toks[:, 11:12], cfg)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, 11].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_mamba_scan_matches_sequential_decode():
    """The full-sequence mixer equals stepping the recurrence token by
    token (the decode path), the reference's weights on both."""
    jcfg, cfg = _pair(name="s", arch_type="ssm", num_layers=1, d_model=32,
                      num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
                      vocab_size=64, ssm_state=4)
    jp, _ = jsplit(jmamba.mamba_params(JParamFactory(jax.random.key(0),
                                                     jnp.float32), jcfg))
    p = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, 32)).astype(np.float32))
    y_full, end = mamba.mamba_mixer(p, x, cfg, return_state=True)
    state = mamba.init_mamba_state(cfg, 1, "cpu")
    outs = []
    for t in range(8):
        y, state = mamba.mamba_decode(p, x[:, t:t + 1], cfg, state)
        outs.append(y)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    for n in ("ssm", "conv"):
        np.testing.assert_allclose(end[n].numpy(), state[n].numpy(),
                                   rtol=1e-4, atol=1e-5)


def _batch(cfg, rng, b, s):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.has_memory_input:
        batch["memory"] = rng.standard_normal(
            (b, cfg.memory_tokens or 16, cfg.memory_dim or cfg.d_model)
        ).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_decode_roundtrip(arch):
    cfg = REGISTRY[arch].reduced
    params, _ = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0), 2, 16))
    logits, state = prefill(params, batch, cfg, max_len=24)
    assert logits.shape == (2, pad_vocab(cfg.vocab_size))
    assert bool(torch.isfinite(logits.float()).all())
    tok = (torch.argmax(logits, -1)[:, None] % cfg.vocab_size).to(
        torch.int32)
    for _ in range(3):
        logits, state = decode_step(params, state, tok, cfg)
        assert bool(torch.isfinite(logits.float()).all()), arch
        tok = (torch.argmax(logits, -1)[:, None] % cfg.vocab_size).to(
            torch.int32)
    assert int(state.position) == 19


def _wrap_cfg(cfg, window):
    """The reduced Gemma3 with its local layer's window cut to
    ``window``."""
    local, glob = cfg.pattern
    return dataclasses.replace(cfg, pattern=(
        dataclasses.replace(local, window=window), glob))


def _cfgs(case, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    arch, _, window = case.partition("@window")
    jcfg = dataclasses.replace(JREGISTRY[arch].reduced, dtype=jdt)
    cfg = dataclasses.replace(REGISTRY[arch].reduced, dtype=tdt)
    if window:
        jcfg, cfg = _wrap_cfg(jcfg, int(window)), _wrap_cfg(cfg, int(window))
    return jcfg, cfg


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol, what):
    want = _f32(want)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _check_state(state, jstate, tol, what):
    assert int(state.position) == int(jstate.position), what
    for i, (c, jc) in enumerate(zip(state.caches, jstate.caches)):
        assert set(c) == set(jc), what
        for n, t in c.items():
            if n == "pos":
                np.testing.assert_array_equal(t.numpy(), np.asarray(jc[n]))
            else:
                _close(t, jc[n], tol, f"{what} caches/{i}/{n}")
    if jstate.memory is None:
        assert state.memory is None
    else:
        _close(state.memory, jstate.memory, tol, f"{what} memory")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ARCHS + ["gemma3-4b@window8"])
def test_prefill_and_decode_match_reference(case, dtype):
    jcfg, cfg = _cfgs(case, dtype)
    jp, p = _ref_params(jcfg)
    rng = np.random.default_rng(0)
    batch = _batch(jcfg, rng, 2, 16)
    steps = rng.integers(0, jcfg.vocab_size, (3, 2, 1)).astype(np.int32)
    tol = 1e-5 if dtype == "f32" else 5e-2

    jlogits, jstate = jprefill(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg,
                               max_len=24)
    logits, state = prefill(p, _torch_batch(batch), cfg, max_len=24)
    _close(logits, jlogits, tol, f"{case} prefill logits")
    _check_state(state, jstate, tol, f"{case} prefill")
    carried = decode_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), cfg, "cpu")
    for i, (c, jc) in enumerate(zip(carried.caches, jstate.caches)):
        for n, t in c.items():
            want = np.asarray(jc[n])
            assert t.dtype == state.caches[i][n].dtype, (case, n)
            assert np.array_equal(t.view(torch.int16).numpy()
                                  if t.dtype == torch.bfloat16 else
                                  t.numpy(),
                                  want.view(np.int16)
                                  if want.dtype.name == "bfloat16" else want)
    assert int(carried.position) == 16

    for k, tok in enumerate(steps):
        jlogits, jstate = jdecode_step(jp, jstate, jnp.asarray(tok), jcfg)
        logits, state = decode_step(p, state, torch.from_numpy(tok), cfg)
        _close(logits, jlogits, tol, f"{case} step {k} logits")
        _check_state(state, jstate, tol, f"{case} step {k}")
    assert int(state.position) == 19
