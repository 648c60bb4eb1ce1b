"""The port's RNG seam: where every random draw of a C-DFL round comes from.

The reference derives its randomness by folding JAX threefry keys
(``repro.core.dfl.round_keys`` and ``_communicate_choco``)::

    comm key  = fold_in(fold_in(rng, round_idx), 1)
    step key  = fold_in(comm key, t)            t = gossip step in the round
    node key  = fold_in(step key, i)            i = node
    leaf keys = split(node key, n_leaves)       leaves in tree order

and each compressor draws ``uniform(leaf key, shape)``. A torch generator
cannot reproduce threefry's bits, so the port asks one object instead::

    draws.uniform(round_idx, step, leaf, shape, node_ids=None)
        -> float32 [len(node_ids), *shape]

on the leaf's device, one row per node id (``None``: every node,
``arange(N)``). Row j depends on (seed, round_idx, step, leaf,
``node_ids[j]``) only, as the reference's node key folds the node's id
(on the batched engine the global virtual-node id), so a substrate asks
for exactly the nodes it holds. ``GeneratorDraws`` is the default: a
counter-based generator, SplitMix64 evaluated at one counter per (node
id, element) under a key folded from (seed, round_idx, step) plus an
offset per leaf index, in int64 torch ops on the whole ``[len(node_ids), *shape]`` block at
once (``uniform_many``: every leaf of a gossip step in one block);
integer arithmetic gives the same bits on the CPU and the card, and a draw
never depends on the order of calls or on which other nodes or leaves
were asked for. ``ReplayDraws`` returns arrays it was given under the same
indices, rows picked by id: the tests feed it the reference's own draws.

A substrate whose leaves are blocks of the node's row (the gossip-fsdp
mesh, ``core.substrate.MeshSubstrate``) asks for a block of a leaf's
draws (``uniform_many(..., blocks=)``): the values at the block's global
element indices, built from the whole leaf's strides, bitwise the whole
draw cut to the block. ``GeneratorDraws`` evaluates its counters there
and nowhere else; every other seam (``ReplayDraws`` among them) draws the
whole leaf and cuts it.

``KeyedDraws`` (``GeneratorDraws.keyed``) draws the same bits under a key
read from a device tensor instead of folded from host ints: a captured
CUDA graph cannot see a host scalar change, so the executor writes each
replay's key (``GeneratorDraws.step_key``) into that tensor first (one
key, or one per gossip step of a round). Under ``ids`` it also reads the
node ids from a device tensor (the batched engine's cohort, which changes
between replays), bitwise ``GeneratorDraws`` at those ids.
"""
from __future__ import annotations

import operator
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaf_order
from repro_torch.device import resolve_device, to_device

__all__ = ["Draws", "GeneratorDraws", "KeyedDraws", "ReplayDraws",
           "block_index", "cut_block"]

Key = Tuple[int, int, str]
# a block of a leaf: (the leaf's per-node shape, (start, size) a dim)
Block = Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...]]
_M64 = (1 << 64) - 1
_SPLITMIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)
_GAMMA = _SPLITMIX[0]


class Draws:
    """The seam's interface."""

    def uniform(self, round_idx: int, step: int, leaf: str,
                shape: Sequence[int],
                node_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Uniform [0, 1) float32 of shape ``[len(node_ids), *shape]`` for
        gossip step ``step`` of round ``round_idx``, the leaf named
        ``leaf`` and the nodes ``node_ids`` (host ints; None for every
        node, ``[N, *shape]``)."""
        raise NotImplementedError

    def uniform_many(self, round_idx: int, step: int, leaves: Sequence[str],
                     shapes: Sequence[Sequence[int]],
                     node_ids: Optional[Sequence[int]] = None,
                     blocks: Optional[Sequence[Optional[Block]]] = None
                     ) -> List[torch.Tensor]:
        """``uniform`` for each leaf of ``leaves`` with its shape, bitwise
        those calls; a seam may draw them all at once. ``blocks[i]``, where
        given, is a block of leaf i (``Block``: its per-node shape, whose
        element count is ``shapes[i]``'s, and a span a dim): that leaf
        comes back as ``[len(node_ids), block elements]``, the draws at the
        block's elements in its row-major order, bitwise the whole draw cut
        to them. This default draws the whole leaf and cuts it."""
        out = []
        for i, (leaf, shape) in enumerate(zip(leaves, shapes)):
            u = self.uniform(round_idx, step, leaf, shape, node_ids)
            block = None if blocks is None else blocks[i]
            out.append(u if block is None else cut_block(u, block))
        return out


def cut_block(u: torch.Tensor, block: Block) -> torch.Tensor:
    """``[rows, *]`` draws of whole leaves cut to ``block``, flat a row."""
    whole, spans = block
    out = u.reshape((u.shape[0],) + tuple(whole))
    for i, (start, size) in enumerate(spans):
        out = out.narrow(i + 1, start, size)
    return out.reshape(u.shape[0], -1).contiguous()


def block_index(block: Block, begin: int, end: int,
                device) -> torch.Tensor:
    """The whole leaf's flat element indices (int64) of the block's
    elements ``begin .. end - 1``, in the block's row-major order: each
    position unravelled over the block's sizes and put together from the
    whole shape's strides."""
    whole, spans = block
    pos = torch.arange(begin, end, dtype=torch.int64, device=device)
    out = torch.zeros_like(pos)
    stride = 1
    for dim, (start, size) in zip(reversed(whole), reversed(spans)):
        out.add_(pos.remainder(size).add_(start).mul_(stride))
        pos = pos.div(size, rounding_mode="floor")
        stride *= dim
    return out


def _ids(node_ids, num_nodes: int) -> List[int]:
    """``node_ids`` as host ints, ``range(num_nodes)`` for None."""
    if node_ids is None:
        return list(range(num_nodes))
    return [operator.index(i) for i in np.asarray(node_ids).reshape(-1)]


class GeneratorDraws(Draws):
    """Counter-based draws on ``device``: SplitMix64. Element e of node i's
    row of the leaf whose name has place l in the reference's leaf order
    (``tree.leaf_order``; sorted for flat names) is the top 24
    bits of ``mix(k + o_l + GAMMA * (i * 2**32 + e))`` (mod 2**64) times
    2**-24, where k is splitmix64 folded over (seed, round_idx, step), o_l
    = splitmix64(l) and ``mix`` SplitMix64's finalizer (its last xor-shift
    touches only the low 33 bits and is left out). ``num_nodes`` is the node
    count of ``node_ids=None`` (the population on the batched engine);
    every id must lie in ``[0, num_nodes)``.

    ``uniform_many`` draws every leaf of a gossip step in 13 elementwise
    int64 ops over one block, whatever the node and leaf counts; the
    counters' fixed part ``o_l + GAMMA * (i * 2**32 + e)`` is built once
    per (id set, leaves, sizes), the id set's part uploaded then. A step of
    more than ``BLOCK_MAX`` elements (an LM tree: 1.65 G for four nodes of
    Qwen3-1.7B at two layers) is drawn leaf by leaf and chunk by chunk,
    its counters built on the fly and never cached, with the same bits."""

    _KEEP_BASES = 2
    # elements of a step's draw above which the counters are built chunk by
    # chunk (``_draw_chunked``) instead of cached as one block
    BLOCK_MAX = 1 << 26

    def __init__(self, seed: int, num_nodes: int, leaves: Iterable[str],
                 device="cuda"):
        self.seed = int(seed)
        self.num_nodes = int(num_nodes)
        if self.num_nodes > 1 << 31:
            raise ValueError(f"at most 2**31 nodes, got {self.num_nodes}")
        self.leaves = tuple(leaf_order(leaves))
        self.device = resolve_device(device)
        self._bases: Dict[tuple, torch.Tensor] = {}

    def _rows(self, ids: Optional[bytes],
              keep: Optional[Dict[tuple, torch.Tensor]] = None
              ) -> torch.Tensor:
        """``GAMMA * (i * 2**32)`` for each node i of the id set ``ids``
        (int64 bytes; None: every node) on the device, as int64; kept in
        ``keep`` when given, else uploaded anew."""
        key = ("rows", ids)
        cache = {} if keep is None else keep
        if key not in cache:
            nodes = np.arange(self.num_nodes, dtype=np.int64) if ids is None \
                else np.frombuffer(ids, np.int64)
            if nodes.size and not (0 <= nodes.min() <= nodes.max()
                                   < self.num_nodes):
                raise ValueError(f"node ids must lie in [0, {self.num_nodes})"
                                 f", got [{nodes.min()}, {nodes.max()}]")
            with np.errstate(over="ignore"):       # GAMMA * i * 2**32
                rows = (nodes.astype(np.uint64) << np.uint64(32)) \
                    * np.uint64(_GAMMA)
            cache[key] = to_device(torch.from_numpy(rows.view(np.int64)),
                                   self.device)
        return cache[key]

    def _elems(self, leaf: str, begin: int, end: int) -> torch.Tensor:
        """``o_l + GAMMA * e`` for the elements ``begin .. end - 1`` of the
        leaf ``leaf``, int64 (wrapping)."""
        if end > 1 << 32:
            raise ValueError(f"at most 2**32 draws a row, got {end}")
        elem = torch.arange(begin, end, dtype=torch.int64, device=self.device)
        return elem.mul_(_signed(_GAMMA)).add_(_signed(
            _splitmix(0, self.leaves.index(leaf))))

    def _elems_at(self, leaf: str, index: torch.Tensor) -> torch.Tensor:
        """``o_l + GAMMA * e`` for the element indices ``index`` of the
        leaf ``leaf``, int64 (wrapping), in place."""
        return index.mul_(_signed(_GAMMA)).add_(_signed(
            _splitmix(0, self.leaves.index(leaf))))

    def _base(self, ids: Optional[bytes], leaves: Tuple[str, ...],
              numels: Tuple[int, ...],
              keep: Optional[Dict[tuple, torch.Tensor]] = None
              ) -> torch.Tensor:
        """The counters' fixed part for the id set ``ids`` (int64 bytes;
        None: every node), leaf by leaf, each leaf a row-major ``[len(ids),
        numel]`` block, flat. Cached in ``keep`` when given (never evicted),
        else the last ``_KEEP_BASES`` are kept."""
        key = (ids, leaves, numels)
        cache = self._bases if keep is None else keep
        if key not in cache:
            rows = self._rows(ids, keep)
            blocks = [(rows[:, None] + self._elems(leaf, 0, n)[None, :])
                      .reshape(-1) for leaf, n in zip(leaves, numels)]
            while keep is None and len(cache) >= self._KEEP_BASES:
                cache.pop(next(iter(cache)))
            cache[key] = torch.cat(blocks) if blocks else torch.empty(
                0, dtype=torch.int64, device=self.device)
        return cache[key]

    def step_key(self, round_idx: int, step: int) -> int:
        """The key of gossip step ``step`` of round ``round_idx``: splitmix64
        folded over (seed, round_idx, step), as the int64 value with its
        bits (what every counter of the step is offset by)."""
        k = 0
        for v in (self.seed, int(round_idx), int(step)):
            k = _splitmix(k, v)
        return _signed(k)

    def keyed(self, key: torch.Tensor,
              ids: Optional[torch.Tensor] = None) -> "KeyedDraws":
        """These draws under the key held in ``key``, for the node ids held
        in ``ids`` when given (see ``KeyedDraws``)."""
        return KeyedDraws(self, key, ids)

    def uniform(self, round_idx, step, leaf, shape, node_ids=None):
        return self.uniform_many(round_idx, step, [leaf], [shape],
                                 node_ids)[0]

    def uniform_many(self, round_idx, step, leaves, shapes, node_ids=None,
                     blocks=None):
        key = self.step_key(round_idx, step)
        if blocks is None or all(b is None for b in blocks):
            return self.draw_at(key, leaves, shapes, node_ids)
        return [self.draw_at(key, [leaf], [shape], node_ids)[0]
                if block is None else
                self.draw_block(key, leaf, shape, block, node_ids)
                for leaf, shape, block in zip(leaves, shapes, blocks)]

    def draw_block(self, key, leaf: str, shape: Sequence[int], block: Block,
                   node_ids=None) -> torch.Tensor:
        """The draws of ``leaf`` (``shape``: its whole flat draw) at the
        elements of ``block``, ``[rows, block elements]``: the counters at
        the block's global indices (``block_index``), at most
        ``BLOCK_MAX`` counters at a time, bitwise ``draw_at``'s whole draw
        cut to the block."""
        numel = int(np.prod(block[0], dtype=np.int64))
        if tuple(shape) != (numel,):
            raise ValueError(f"a block of {leaf!r} needs its flat draw shape "
                             f"({numel},), got {tuple(shape)}")
        n = int(np.prod([size for _, size in block[1]], dtype=np.int64))
        ids = None if node_ids is None else np.asarray(
            _ids(node_ids, self.num_nodes), np.int64).tobytes()
        node_part = self._rows(ids)
        rows = node_part.numel()
        width = max(1, self.BLOCK_MAX // max(rows, 1))
        out = torch.empty((rows, n), dtype=torch.float32, device=self.device)
        for c0 in range(0, n, width):
            c1 = min(n, c0 + width)
            elems = self._elems_at(leaf, block_index(block, c0, c1,
                                                     self.device))
            out[:, c0:c1] = _finish(node_part[:, None] + elems[None, :]
                                    + key)
        return out

    def draw_at(self, key, leaves, shapes, node_ids=None,
                keep: Optional[Dict[tuple, torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """``uniform_many``'s blocks under ``key``, a Python int or an int64
        tensor of one element on the seam's device (the same bits either
        way: one wrapping int64 add); ``keep`` caches the counter bases.
        A step of more than ``BLOCK_MAX`` elements is drawn chunk by chunk
        from the same counters (``_draw_chunked``), bitwise the one
        block."""
        shapes = [tuple(s) for s in shapes]
        numels = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
        ids = None if node_ids is None else np.asarray(
            _ids(node_ids, self.num_nodes), np.int64).tobytes()
        rows = self.num_nodes if ids is None else len(ids) // 8
        if rows * sum(numels) > self.BLOCK_MAX:
            return self._draw_chunked(key, leaves, shapes, numels, ids, rows,
                                      keep)
        u = _finish(self._base(ids, tuple(leaves), numels, keep) + key)
        return [block.view(rows, *shape) for block, shape in
                zip(u.split([rows * n for n in numels]), shapes)]

    def draw_ids(self, key, leaves, shapes, ids: torch.Tensor,
                 keep: Optional[Dict[tuple, torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
        """``draw_at``'s blocks for the node ids held in ``ids``, an int64
        tensor on the seam's device, read when the draw runs (a graph reads
        it by address). The counters' node part ``GAMMA * (i * 2**32)`` is
        computed there in wrapping int64 ops, the same bits as the host's
        uint64 product; the element part of each leaf is cached in
        ``keep``."""
        shapes = [tuple(s) for s in shapes]
        numels = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
        rows = ids.numel()
        node_part = ids.bitwise_left_shift(32).mul_(_signed(_GAMMA))
        if rows * sum(numels) > self.BLOCK_MAX:
            return self._draw_chunked(key, leaves, shapes, numels, None,
                                      rows, keep, node_part)
        cache = {} if keep is None else keep
        blocks = []
        for leaf, n in zip(leaves, numels):
            if ("elems", leaf, n) not in cache:
                cache[("elems", leaf, n)] = self._elems(leaf, 0, n)
            blocks.append((node_part[:, None]
                           + cache[("elems", leaf, n)][None, :]).reshape(-1))
        base = torch.cat(blocks) if blocks else torch.empty(
            0, dtype=torch.int64, device=self.device)
        u = _finish(base + key)
        return [block.view(rows, *shape) for block, shape in
                zip(u.split([rows * n for n in numels]), shapes)]

    def _draw_chunked(self, key, leaves, shapes, numels, ids, rows, keep,
                      node_part: Optional[torch.Tensor] = None
                      ) -> List[torch.Tensor]:
        """Each leaf drawn into its own f32 output a column chunk at a time,
        the chunk's counters built on the fly: the int64 temporaries stay
        near ``BLOCK_MAX`` elements whatever the tree's size, where the one
        block would hold the whole step's counters (8 bytes an element,
        cached) and its temporaries. ``node_part``: the ids' part of the
        counters, computed already (``draw_ids``)."""
        if node_part is None:
            node_part = self._rows(ids, keep)
        width = max(1, self.BLOCK_MAX // max(rows, 1))
        outs = []
        for leaf, n, shape in zip(leaves, numels, shapes):
            out = torch.empty((rows, n), dtype=torch.float32,
                              device=self.device)
            for c0 in range(0, n, width):
                c1 = min(n, c0 + width)
                z = node_part[:, None] + self._elems(leaf, c0, c1)[None, :]
                out[:, c0:c1] = _finish(z.add_(key))
            outs.append(out.view(rows, *shape))
        return outs


def _finish(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer (its last xor-shift left out) on the int64
    counters ``z``, in place, then the top 24 bits as f32 in [0, 1)."""
    for shift, mult in ((30, _SPLITMIX[1]), (27, _SPLITMIX[2])):
        z.bitwise_xor_(z.bitwise_right_shift(shift).bitwise_and_(
            (1 << 64 - shift) - 1))          # a logical shift
        z.mul_(_signed(mult))
    return z.bitwise_right_shift_(40).bitwise_and_((1 << 24) - 1).to(
        torch.float32).mul_(2.0 ** -24)


class KeyedDraws(Draws):
    """``draws`` (a ``GeneratorDraws``) under the key held in ``key``, an
    int64 tensor on the seam's device, whatever round it is asked for:
    bitwise ``draws.uniform_many(r, t, ...)`` once ``key`` holds
    ``draws.step_key(r, t)``. ``key`` is one element, read whatever the
    step, or a ``[T]`` vector whose entry t is gossip step t's key (a
    captured round of several steps). ``ids``: an int64 ``[C]`` tensor of
    node ids on the device, the rows drawn when the caller asks for
    ``node_ids=None`` (``GeneratorDraws.draw_ids``). A captured graph reads
    ``key``, ``ids`` and the counter bases by address, so every base used
    is kept for the life of this object."""

    def __init__(self, draws: GeneratorDraws, key: torch.Tensor,
                 ids: Optional[torch.Tensor] = None):
        if key.dtype != torch.int64 or key.dim() > 1 or (
                key.dim() == 0 and key.numel() != 1):
            raise ValueError(f"the key must be one int64 element or a [T] "
                             f"int64 vector, got {tuple(key.shape)} "
                             f"{key.dtype}")
        if ids is not None and (ids.dtype != torch.int64 or ids.dim() != 1):
            raise ValueError(f"node ids must be an int64 vector, got "
                             f"{tuple(ids.shape)} {ids.dtype}")
        self.draws, self.key, self.ids = draws, key, ids
        self._per_step = key.dim() == 1 and key.numel() != 1
        self._bases: Dict[tuple, torch.Tensor] = {}

    def uniform(self, round_idx, step, leaf, shape, node_ids=None):
        return self.uniform_many(round_idx, step, [leaf], [shape],
                                 node_ids)[0]

    def uniform_many(self, round_idx, step, leaves, shapes, node_ids=None,
                     blocks=None):
        if blocks is not None and any(b is not None for b in blocks):
            # the mesh's rounds run eagerly, never under a device key
            raise ValueError("KeyedDraws draws whole leaves; blocks are "
                             "drawn by a GeneratorDraws")
        key = self.key[step] if self._per_step else self.key
        if self.ids is not None and node_ids is None:
            return self.draws.draw_ids(key, leaves, shapes, self.ids,
                                       self._bases)
        return self.draws.draw_at(key, leaves, shapes, node_ids,
                                  self._bases)


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 value with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _splitmix(h: int, v: int) -> int:
    """One splitmix64 fold of ``v`` into ``h`` (Python ints, 64 bits)."""
    c1, c2, c3 = _SPLITMIX
    h = (h ^ v) + c1 & _M64
    h = (h ^ (h >> 30)) * c2 & _M64
    h = (h ^ (h >> 27)) * c3 & _M64
    return h ^ (h >> 31)


class ReplayDraws(Draws):
    """Returns the arrays of ``table``, keyed ``(round_idx, step, leaf)``,
    each ``[N, *shape]`` with row i node i's, as float32 tensors on
    ``device``; ``node_ids`` picks the rows."""

    def __init__(self, table: Mapping[Key, np.ndarray], device="cuda"):
        self.device = resolve_device(device)
        self.table = {key: torch.as_tensor(np.asarray(a, np.float32))
                      for key, a in table.items()}

    def uniform(self, round_idx, step, leaf, shape, node_ids=None):
        key = (int(round_idx), int(step), leaf)
        if key not in self.table:
            raise KeyError(f"no replayed draw for (round, step, leaf) = {key}")
        out = self.table[key]
        if tuple(out.shape[1:]) != tuple(shape):
            raise ValueError(f"replayed draw {key} has shape "
                             f"{tuple(out.shape)}, asked for [N, *{tuple(shape)}]")
        if node_ids is not None:
            out = out[_ids(node_ids, out.shape[0])]
        return out.to(self.device)
