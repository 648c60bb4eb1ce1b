"""Batched serving engine over the model zoo's prefill / decode steps.

Ported from ``repro.serving.engine``, with its semantics:

  * requests are grouped into buckets by prompt length padded up to
    ``bucket``, the largest group served first, at most ``max_batch`` a
    flight; a prompt is left-padded by repeating its first token;
  * each flight is one batched prefill, then greedy (or temperature)
    decode with per-request ``max_new_tokens`` and EOS, ending early when
    every request of the flight is finished;
  * greedy picks ``argmax`` (the first index on ties, as ``jnp.argmax``
    does), then ``% vocab_size``.

The reference jits its decode step once per signature; the port captures
it as a CUDA graph once per ``(batch, max_len)`` signature (``_Decoder``),
over a static ``DecodeState``, token and logits buffer. Prefill runs
eagerly, once a flight, and its state is copied into the graph's static
state. A greedy step samples inside the graph, writing the next token
into the token buffer, so each step is one replay and one device-to-host
read of the B tokens, for EOS (the reference reads the same tokens each
step). The graph is warmed before its capture, a capture that fails
raises, and nothing falls back to eager decode on the card; on a CPU
engine the same step runs eagerly and ``capture_count`` stays 0.

Temperature sampling draws from a ``torch.Generator`` on the engine's
device seeded from ``seed``, outside the graph: the same seed gives the
same tokens, but not the bits of the reference's
``jax.random.categorical``.

Continuous batching (per-slot positions) is out of scope, as in the
reference: ``DecodeState.position`` is flight-global.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device, to_device
from repro_torch.models import DecodeState, decode_step, prefill
from repro_torch.models.common import ModelConfig

__all__ = ["Request", "Completion", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    tokens: List[int]
    max_new_tokens: int = 32
    eos_id: int = -1                 # -1 = never stop early

    def __post_init__(self):
        assert len(self.tokens) >= 1


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prompt_len: int
    latency_s: float


class _Decoder:
    """The decode step of one ``(batch, max_len)`` signature over static
    buffers: ``state`` (written in place by each step), ``tok`` [B, 1]
    int32 (the step's input; after a greedy step, the next token) and
    ``logits``. On CUDA the step is one captured graph; on the CPU it runs
    eagerly into the same buffers."""

    def __init__(self, engine: "ServingEngine", state: DecodeState,
                 tok: torch.Tensor):
        self.state = DecodeState(*tree_map(torch.clone, state))
        self.tok = tok.clone()
        self.logits = None
        params, cfg = engine.params, engine.cfg
        greedy = engine.temperature <= 0.0

        def step():
            self.logits, _ = decode_step(params, self.state, self.tok, cfg)
            if greedy:
                self.tok.copy_(engine.greedy(self.logits))

        graphs.warm(step, engine.device)
        self._replay = graphs.capture(step, engine.device)

    def load(self, state: DecodeState, tok: torch.Tensor) -> None:
        """Copy a prefill's state and first token into the buffers."""
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            dst.copy_(src)
        self.tok.copy_(tok)

    def step(self) -> None:
        self._replay.replay()


class ServingEngine:
    """``device`` (default ``"cuda"``) holds ``params`` and runs every
    step; without a card it raises unless asked for ``"cpu"``."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 bucket: int = 32, max_len: int = 512,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.max_len = max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self._queue: List[Request] = []
        self._done: Dict[int, Completion] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decoders: Dict[Tuple[int, int], _Decoder] = {}
        self.capture_count = 0       # decode graphs captured
        self.decode_steps = 0        # decode steps run, all flights

    # -- client API --------------------------------------------------------

    def submit(self, req: Request) -> None:
        assert len(req.tokens) + req.max_new_tokens <= self.max_len, (
            "request exceeds engine max_len")
        self._queue.append(req)

    def run_until_drained(self) -> Dict[int, Completion]:
        while self._queue:
            self._serve_one_flight()
        return dict(self._done)

    # -- sampling and the decode graphs ------------------------------------

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, 1] int32: the first index of each row's largest logit, mod
        the vocabulary."""
        tok = torch.argmax(logits, dim=-1)
        return (tok[:, None] % self.cfg.vocab_size).to(torch.int32)

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, 1] int32: greedy at temperature 0, else one draw from
        ``softmax(logits / temperature)`` by the exponential race
        (``argmax p / E``, E ~ Exp(1) from the engine's generator: the
        one-sample path of ``torch.multinomial``, without its check of the
        probabilities, which reads back to the host)."""
        if self.temperature <= 0.0:
            return self.greedy(logits)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        race = torch.empty_like(probs).exponential_(generator=self._gen)
        tok = torch.argmax(probs / race, dim=-1)
        return (tok[:, None] % self.cfg.vocab_size).to(torch.int32)

    def decoder(self, logits: torch.Tensor, state: DecodeState) -> _Decoder:
        """The decode step of ``state``'s signature, loaded with ``state``
        (a prefill's, left untouched) and the token sampled from
        ``logits``; the first call of a signature captures its graph."""
        key = (int(logits.shape[0]), self.max_len)
        tok = self.sample(logits)
        dec = self._decoders.get(key)
        if dec is None:
            dec = _Decoder(self, state, tok)
            self._decoders[key] = dec
            if self.device.type == "cuda":
                self.capture_count += 1
        dec.load(state, tok)
        return dec

    # -- internals ----------------------------------------------------------

    def _bucket_len(self, n: int) -> int:
        return int(np.ceil(n / self.bucket) * self.bucket)

    def _take_flight(self) -> List[Request]:
        """Pop up to max_batch requests sharing a padded prompt length."""
        by_len = defaultdict(list)
        for r in self._queue:
            by_len[self._bucket_len(len(r.tokens))].append(r)
        # serve the largest group first (throughput).
        plen = max(by_len, key=lambda k: len(by_len[k]))
        flight = by_len[plen][: self.max_batch]
        for r in flight:
            self._queue.remove(r)
        return flight

    def flight_batch(self, flight: List[Request]) -> Dict[str, torch.Tensor]:
        """A flight's prefill batch on the device: the prompts left-padded
        to the bucketed length of the longest by repeating each one's
        first token (and zero memory where the config reads one)."""
        b = len(flight)
        plen = self._bucket_len(max(len(r.tokens) for r in flight))
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(flight):
            toks[i, plen - len(r.tokens):] = r.tokens   # left pad = repeat
            toks[i, : plen - len(r.tokens)] = r.tokens[0]
        batch = {"tokens": to_device(torch.from_numpy(toks), self.device)}
        if self.cfg.has_memory_input:
            m = self.cfg.memory_tokens or 16
            batch["memory"] = torch.zeros(
                (b, m, self.cfg.memory_dim or self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        return batch

    def _serve_one_flight(self) -> None:
        t0 = time.time()
        flight = self._take_flight()
        b = len(flight)
        batch = self.flight_batch(flight)
        with torch.no_grad():
            logits, state = prefill(self.params, batch, self.cfg,
                                    self.max_len)
            dec = self.decoder(logits, state)
            del logits, state
            out: List[List[int]] = [[] for _ in range(b)]
            finished = np.zeros(b, bool)
            budget = max(r.max_new_tokens for r in flight)
            for step in range(budget):
                t_np = dec.tok.cpu().numpy()[:, 0]
                for i, r in enumerate(flight):
                    if finished[i] or step >= r.max_new_tokens:
                        finished[i] = True
                        continue
                    out[i].append(int(t_np[i]))
                    if r.eos_id >= 0 and int(t_np[i]) == r.eos_id:
                        finished[i] = True
                if finished.all() or step == budget - 1:
                    break
                dec.step()
                self.decode_steps += 1
                if self.temperature > 0.0:
                    dec.tok.copy_(self.sample(dec.logits))
        dt = time.time() - t0
        for i, r in enumerate(flight):
            self._done[r.uid] = Completion(
                uid=r.uid, tokens=out[i], prompt_len=len(r.tokens),
                latency_s=dt)
