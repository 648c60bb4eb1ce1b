"""The port's serving engine (``repro_torch.serving``), serve CLI and
example against the reference's.

* ``tests/test_serving.py``'s four cases on the port's engine (the reduced
  Qwen3 in its own bf16): mixed lengths, greedy is deterministic, EOS
  stops early, an oversized request is rejected.
* Greedy completions equal the reference engine's for the reduced Qwen3
  in f32 on the same requests and weights. Every step of every request,
  the reference's top-two logit margin exceeds ``F32_LIMIT``, and the
  port's logits are within it of the reference's, so no token agrees by
  a tie.
* Temperature sampling: the same seed gives the same tokens, every token
  in range; another seed other tokens.
* A second flight reloads the decode step's static state: its tokens equal
  a fresh engine's on the same requests. On the CPU nothing is captured
  (``capture_count`` 0) and a signature keeps one decode step; a capture
  that fails raises.
* ``launch/serve.py`` and ``examples/serve_decode.py`` with ``--device
  cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.core import graphs
from repro_torch.examples import serve_decode
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine

ARCH = "qwen3-1.7b"
# |port - reference| on the reduced Qwen3's f32 logits is about 1e-6
# (matmul reduction order); the margin between the reference's two
# largest logits must clear this limit at every greedy step.
F32_LIMIT = 1e-4
REQUESTS = [(1, 5, 8), (2, 12, 4), (3, 30, 6), (4, 7, 8), (5, 3, 10)]


def _params(cfg, seed=0):
    params, _ = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return params


def _engine(**kw):
    cfg = REGISTRY[ARCH].reduced
    return ServingEngine(cfg, _params(cfg), **{
        "max_batch": 4, "bucket": 16, "max_len": 96, "device": "cpu", **kw})


@pytest.fixture(scope="module")
def engine():
    return _engine()


def test_serves_mixed_lengths(engine):
    for uid, n, gen in [(1, 5, 8), (2, 12, 4), (3, 30, 6), (4, 7, 8)]:
        engine.submit(Request(uid=uid, tokens=list(range(1, n + 1)),
                              max_new_tokens=gen))
    done = engine.run_until_drained()
    assert set(done) == {1, 2, 3, 4}
    assert len(done[1].tokens) == 8
    assert len(done[2].tokens) == 4
    assert len(done[3].tokens) == 6
    for c in done.values():
        assert all(0 <= t < 512 for t in c.tokens)


def test_greedy_is_deterministic(engine):
    engine.submit(Request(uid=10, tokens=[1, 2, 3, 4], max_new_tokens=6))
    a = engine.run_until_drained()[10].tokens
    engine.submit(Request(uid=11, tokens=[1, 2, 3, 4], max_new_tokens=6))
    b = engine.run_until_drained()[11].tokens
    assert a == b


def test_eos_stops_early():
    eng = _engine(max_batch=2)
    # find greedy first token, then use it as the "EOS" to force early stop
    eng.submit(Request(uid=1, tokens=[5, 6, 7], max_new_tokens=8))
    first = eng.run_until_drained()[1].tokens[0]
    eng.submit(Request(uid=2, tokens=[5, 6, 7], max_new_tokens=8,
                       eos_id=first))
    out = eng.run_until_drained()[2]
    assert len(out.tokens) == 1 and out.tokens[0] == first


def test_rejects_oversized_request(engine):
    with pytest.raises(AssertionError):
        engine.submit(Request(uid=99, tokens=[1] * 95, max_new_tokens=10))


def _recording(fn, rows):
    def wrapped(logits):
        rows.append(np.asarray(logits, np.float32).copy()
                    if not isinstance(logits, torch.Tensor)
                    else logits.float().numpy().copy())
        return fn(logits)
    return wrapped


def test_greedy_completions_equal_reference_engine():
    jcfg = dataclasses.replace(JREGISTRY[ARCH].reduced, dtype=jnp.float32)
    cfg = dataclasses.replace(REGISTRY[ARCH].reduced, dtype=torch.float32)
    jp, _ = jinit_params(jcfg, jax.random.key(0))
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    kw = dict(max_batch=4, bucket=16, max_len=96)
    jeng = JServingEngine(jcfg, jp, **kw)
    eng = ServingEngine(cfg, p, device="cpu", **kw)
    jrows, rows = [], []
    jeng._sample = _recording(jeng._sample, jrows)
    eng.greedy = _recording(eng.greedy, rows)
    for uid, n, gen in REQUESTS:
        toks = [(7 * uid + 3 * i) % jcfg.vocab_size for i in range(n)]
        jeng.submit(JRequest(uid=uid, tokens=toks, max_new_tokens=gen))
        eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=gen))
    jdone, done = jeng.run_until_drained(), eng.run_until_drained()
    assert len(rows) == len(jrows) > len(REQUESTS)
    for got, want in zip(rows, jrows):
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) < F32_LIMIT
        top2 = np.sort(want[:, :jcfg.vocab_size], axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > F32_LIMIT
    assert set(done) == set(jdone)
    for uid in jdone:
        assert done[uid].tokens == jdone[uid].tokens, uid
        assert done[uid].prompt_len == jdone[uid].prompt_len


def _sampled(seed):
    eng = _engine(temperature=1.0, seed=seed)
    for uid, n, gen in REQUESTS:
        eng.submit(Request(uid=uid, tokens=list(range(2, n + 2)),
                           max_new_tokens=gen))
    return {u: c.tokens for u, c in eng.run_until_drained().items()}


def test_temperature_sampling_is_seeded():
    a, b, c = _sampled(3), _sampled(3), _sampled(4)
    assert a == b
    assert a != c
    assert all(len(a[uid]) == gen for uid, _, gen in REQUESTS)
    assert all(0 <= t < REGISTRY[ARCH].reduced.vocab_size
               for toks in a.values() for t in toks)


def test_second_flight_reloads_the_static_state():
    eng = _engine(max_batch=2)
    eng.submit(Request(uid=1, tokens=[9, 8, 7, 6], max_new_tokens=7))
    eng.submit(Request(uid=2, tokens=[1, 2], max_new_tokens=5))
    eng.run_until_drained()
    eng.submit(Request(uid=3, tokens=[4, 4, 2], max_new_tokens=6))
    eng.submit(Request(uid=4, tokens=[3, 1, 4, 1, 5], max_new_tokens=6))
    second = eng.run_until_drained()
    fresh = _engine(max_batch=2)
    fresh.submit(Request(uid=3, tokens=[4, 4, 2], max_new_tokens=6))
    fresh.submit(Request(uid=4, tokens=[3, 1, 4, 1, 5], max_new_tokens=6))
    alone = fresh.run_until_drained()
    assert [second[u].tokens for u in (3, 4)] == \
        [alone[u].tokens for u in (3, 4)]
    assert eng.capture_count == 0 and len(eng._decoders) == 1
    assert eng.decode_steps == 6 + 5


def test_failed_capture_raises(monkeypatch):
    def broken(fn, device, pool=None):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "capture", broken)
    eng = _engine()
    eng.submit(Request(uid=1, tokens=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.run_until_drained()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-1.5-large-398b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    rec = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "12",
                      "--gen", "5", "--device", "cpu"])
    assert tuple(rec["tokens"].shape) == (2, 5)
    assert bool(torch.isfinite(rec["logits"].float()).all())
    assert rec["capture_count"] == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out
    again = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "12",
                        "--gen", "5", "--device", "cpu"])
    assert torch.equal(rec["tokens"], again["tokens"])


def test_serve_decode_example_runs_on_cpu(capsys):
    rec = serve_decode.main(["--batch", "2", "--prompt-len", "10", "--gen",
                             "4", "--device", "cpu"])
    assert tuple(rec["tokens"].shape) == (2, 4)
    assert capsys.readouterr().out.strip().endswith("OK")
