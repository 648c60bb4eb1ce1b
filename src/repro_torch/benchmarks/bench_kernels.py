"""Kernel benchmark of the port: parity, TopK against its oracle, buffer
passes and throughput.

The port of ``benchmarks/bench_kernels.py``. Four sections, written to
``results/repro_torch/BENCH_kernels.json`` (the root ``BENCH_kernels.json``
is the reference's):

  * ``parity``            ``registry.parity_suite``: each of the seven
                          ops through ``kernels.ops`` against its oracle in
                          ``kernels.ref``, over ``PARITY_SHAPES`` x {f32,
                          bf16} (``--smoke``: the reference's three smoke
                          shapes). Asserted on every run: bitwise ops
                          exactly, the rest to 1e-5 in f32 and 1e-2 in bf16.
  * ``topk_vs_reference`` the TopK compressor (K4's threshold, K5's mask on
                          the card) bitwise ``ref.top_k_ref`` at fractions
                          0.01, 0.1, 0.5 and 1.0. Asserted on every run.
  * ``buffer_passes``     fused against unfused CHOCO chains on one leaf,
                          counted by ``ops.LAUNCHES``: K2 against K7 then
                          K6, and K4 + K3 against K7, K4 and K5. On the card
                          the fused chain must launch strictly fewer kernels
                          and give the unfused chain's bits (asserted); on
                          the CPU nothing launches, and the section says so.
  * ``throughput``        every kernel at the CIFAR CNN's tree as one
                          gossip step sees it (10 leaves, 576,778 parameters
                          a node, ``[10, D]`` f32; K1's received-buffer form
                          one node's ``[D]`` leaves): K1 at ring(10) and
                          fully_connected(10), K1-received at deg 2 and 7,
                          K2-K7. Each row times the kernel, its plain
                          version and, where one PyTorch call computes the
                          same function, that call, warm (CUDA-graph replay
                          between CUDA events, operands in L2 where they
                          fit) and from DRAM (operand sets rotated through
                          more than three times the L2 cache), beside the
                          bound (the bytes the call must move at 3.35 TB/s),
                          the share of the bound, the launches a call makes
                          and whether the kernel's output is bitwise its
                          plain version's (``--smoke``: the MNIST CNN's
                          tree, 20,490 parameters a node). On ``--device
                          cpu`` the rows keep the plain versions' host times
                          and claim no speed.

``--check`` adds the structural asserts: one launch for fused QSGD, two for
fused TopK, and on the card every throughput row launched, bitwise its plain
version and timed. Times are recorded, never asserted.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \\
        --smoke --device cpu
    python3 chip_smoke.py --only bench_kernels        # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import RESULTS_DIR
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref, registry
from repro_torch.launch.roofline import HBM_BYTES_PER_S

DEFAULT_OUT = os.path.join(RESULTS_DIR, "BENCH_kernels.json")
SMOKE_SHAPES = ((64,), (1000,), (300, 70))
TOPK_FRACS = (0.01, 0.1, 0.5, 1.0)
NODES = 10             # the CIFAR runs' ring(10)
GAMMA = 0.6            # the CIFAR runs' CHOCO step
TOPK_FRAC = 0.67       # the CIFAR runs' TopK fraction
LEVELS = 16            # the CIFAR runs' QSGD levels

__all__ = ["main", "DEFAULT_OUT", "SMOKE_SHAPES", "TOPK_FRACS",
           "leaf_sizes", "throughput_rows"]


def _flat(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def same_bits(a, b) -> bool:
    """Every tensor of the (nested) outputs ``a`` and ``b`` bitwise equal."""
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(fa, fb))


def max_abs_err(a, b) -> float:
    return max((float((x.float() - y.float()).abs().max())
                for x, y in zip(_flat(a), _flat(b)) if x.numel()),
               default=0.0)


def run_parity(smoke: bool, dev) -> Dict:
    shapes = SMOKE_SHAPES if smoke else registry.PARITY_SHAPES
    records = registry.parity_suite(shapes=shapes, device=dev)
    failures = [r for r in records if not r["ok"]]
    if failures:
        raise AssertionError(f"kernel parity failures: {failures}")
    bitwise = [r for r in records if r["bitwise"]]
    print(f"[parity] {len(records)} records over {len(shapes)} shapes on "
          f"{dev.type}: all ok ({len(bitwise)} bitwise-exact)")
    return {"records": len(records), "shapes": [list(s) for s in shapes],
            "dtypes": [registry.dtype_name(d) for d in registry.PARITY_DTYPES],
            "failures": 0,
            "max_err_by_op": {op.name: max(r["max_err"] for r in records
                                           if r["op"] == op.name)
                              for op in registry.list_ops()}}


def run_topk_vs_reference(smoke: bool, dev) -> Dict:
    """The TopK compressor the port runs (K4's threshold, then K5's mask,
    on the card) is the oracle's operator, bitwise."""
    from repro_torch.core.compression import TopK

    n = 2 ** 14 if smoke else 2 ** 18
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, n), dtype=np.float32)).to(dev)
    matches = {}
    for frac in TOPK_FRACS:
        comp = TopK(frac=frac)
        got = comp.per_node(x)
        matches[str(frac)] = same_bits(got, ref.top_k_ref(x, comp._k(n)))
    if not all(matches.values()):
        raise AssertionError(f"TopK differs from ref.top_k_ref: {matches}")
    print(f"[topk] kernel-backed TopK vs ref.top_k_ref bitwise over fracs: "
          f"{matches}")
    return {"elements": n, "bitwise_by_frac": matches}


def _launched(fn) -> Dict:
    """Run ``fn()``; its output and the launches it made, by kernel."""
    before = dict(ops.LAUNCHES)
    out = fn()
    by_kernel = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                 if v != before[k]}
    return {"out": out, "launches": sum(by_kernel.values()),
            "by_kernel": by_kernel}


def run_buffer_passes(dev) -> Dict:
    """Fused against unfused CHOCO chains on one leaf (the reference's
    (3, 5, 7), one row of 105): the launches each makes and whether the
    two give the same (x_new, y_new)."""
    from repro_torch.core.compression import QSGD
    from repro_torch.kernels.choco_fused import gap

    rng = np.random.default_rng(7)
    x, y, my = (torch.from_numpy(rng.standard_normal(
        (1, 105), dtype=np.float32)).to(dev) for _ in range(3))
    noise = torch.from_numpy(rng.random((1, 105), dtype=np.float32)).to(dev)
    k = 26
    c = QSGD(levels=LEVELS)._c(105)

    def fused_qsgd():
        norm = torch.linalg.vector_norm(gap(x, y, my, 0.5).float(), dim=1)
        return ops.choco_qsgd(x, y, my, noise, norm, 0.5, LEVELS, c)

    def unfused_qsgd():
        x_new, d = ops.choco_move(x, y, my, 0.5)
        norm = torch.linalg.vector_norm(d.float(), dim=1)
        return x_new, y + ops.qsgd_quantize(d, noise, norm, LEVELS, c)

    def fused_topk():
        d = gap(x, y, my, 0.5)
        return ops.choco_topk(x, y, my, d, ops.topk_threshold(d, k), 0.5)

    def unfused_topk():
        x_new, d = ops.choco_move(x, y, my, 0.5)
        return x_new, y + ops.topk_mask(d, ops.topk_threshold(d, k))

    out = {"device": dev.type, "shape": [3, 5, 7]}
    if dev.type != "cuda":
        out["note"] = ("nothing launches on the CPU: every op runs its "
                       "plain version, so no launch is counted")
    for name, fused, unfused in (("choco_qsgd", fused_qsgd, unfused_qsgd),
                                 ("choco_topk", fused_topk, unfused_topk)):
        f, u = _launched(fused), _launched(unfused)
        same = same_bits(f.pop("out"), u.pop("out"))
        out[name] = {"fused": f, "unfused": u, "same_result": same}
        print(f"[buffer_passes] {name}: fused {f['launches']} launches "
              f"{f['by_kernel']}, unfused {u['launches']} {u['by_kernel']}, "
              f"same result {same}")
        if dev.type == "cuda" and not f["launches"] < u["launches"]:
            raise AssertionError(f"{name}: fused {f} launches not fewer "
                                 f"than unfused {u}")
        if not same:
            raise AssertionError(f"{name}: the fused and unfused chains "
                                 "differ")
    return out


@dataclasses.dataclass
class Row:
    """One throughput row: ``make()`` draws a fresh operand set and returns
    the calls on it, ``{"kernel", "plain"}`` and ``"library"`` where one
    PyTorch call computes the same function (named ``library``)."""
    row: str
    kernel: str
    replaces: str
    leaves: int
    elements: int
    nbytes: int
    make: Callable[[], Dict[str, Callable]]
    library: Optional[str] = None


def leaf_sizes(flavor: str) -> List[int]:
    """The elements of each leaf of the paper's CNN for ``flavor``."""
    from repro_torch.models.cnn import init_cnn

    return [v.numel() for v in init_cnn(torch.Generator().manual_seed(0),
                                        flavor, "cpu").values()]


def throughput_rows(dev, gen: torch.Generator,
                    flavor: str = "cifar") -> List[Row]:
    """The rows of PERF.md's kernel table on the ``flavor`` CNN's tree:
    every leaf ``[NODES, D]`` f32 for the gossip step's kernels, one node's
    ``[D]`` leaves for K1's received form."""
    from repro_torch.core.compression import QSGD
    from repro_torch.core.mixing import gossip_table
    from repro_torch.core.topology import fully_connected, ring
    from repro_torch.kernels import (choco_fused, choco_update, gossip_mix,
                                     qsgd, topk)

    sizes = leaf_sizes(flavor)
    n, e = NODES, NODES * sum(sizes)
    src = "src/repro/kernels/"

    def tree():
        return [torch.randn(n, d, generator=gen, device=dev) for d in sizes]

    def mix(topo, label):
        nbr, w = (torch.from_numpy(a).to(dev) for a in gossip_table(topo))
        ct = torch.as_tensor(topo.mixing.T, dtype=torch.float32, device=dev)

        def make():
            xs = tree()
            return {"kernel": lambda: ops.gossip_mix_many(xs, nbr, w),
                    "plain": lambda: [gossip_mix.plain(x, nbr, w)
                                      for x in xs],
                    "library": lambda: [ct @ x for x in xs]}
        return Row(f"K1 gossip_mix {label}", "gossip_mix",
                   src + "gossip_mix.py:34", len(sizes), e,
                   8 * e + 4 * (nbr.numel() + w.numel()), make, "C.T @ X")

    def received(deg):
        """One node's leaves and their ``[deg, D]`` received rows, views of
        one packed buffer with 16-byte aligned leaves, as the sparse
        engine's exchange hands them over."""
        offsets = np.cumsum([0] + [-(-d // 4) * 4 for d in sizes])

        def make():
            buf = torch.randn(deg, int(offsets[-1]), generator=gen,
                              device=dev)
            xs = [torch.randn(d, generator=gen, device=dev) for d in sizes]
            recvs = [buf[:, at:at + d] for at, d in zip(offsets, sizes)]
            w = torch.rand(deg + 1, generator=gen, device=dev) + 0.1
            w = (w / w.sum()).contiguous()
            w0, wr = float(w[0]), w[1:][None]
            return {"kernel": lambda: ops.gossip_mix_received_many(
                        xs, recvs, w),
                    "plain": lambda: [gossip_mix.plain_received(x, r, w)
                                      for x, r in zip(xs, recvs)],
                    "library": lambda: [torch.addmm(x[None], wr, r, beta=w0)
                                        for x, r in zip(xs, recvs)]}
        return Row(f"K1-received deg {deg}", "gossip_mix_received",
                   src + "gossip_mix.py:34", len(sizes), sum(sizes),
                   4 * (deg + 2) * sum(sizes), make, "addmm a leaf")

    def choco_qsgd():
        cs = [QSGD(levels=LEVELS)._c(d) for d in sizes]

        def make():
            xs, ys, mys = tree(), tree(), tree()
            noises = [torch.rand(n, d, generator=gen, device=dev)
                      for d in sizes]
            norms = [torch.linalg.vector_norm(
                choco_fused.gap(x, y, my, GAMMA).float(), dim=1)
                for x, y, my in zip(xs, ys, mys)]
            args = list(zip(xs, ys, mys, noises, norms, cs))
            return {"kernel": lambda: [
                        ops.choco_qsgd(x, y, my, z, nm, GAMMA, LEVELS, c)
                        for x, y, my, z, nm, c in args],
                    "plain": lambda: [
                        choco_fused.qsgd_plain(x, y, my, z, nm, GAMMA, LEVELS,
                                               qsgd.scale(LEVELS, c))
                        for x, y, my, z, nm, c in args]}
        return Row("K2 choco_qsgd", "choco_qsgd", src + "choco_fused.py:65",
                   len(sizes), e, 24 * e + 4 * n * len(sizes), make)

    def choco_topk():
        def make():
            xs, ys, mys = tree(), tree(), tree()
            args = []
            for x, y, my in zip(xs, ys, mys):
                d = choco_fused.gap(x, y, my, GAMMA)
                t = topk.threshold_plain(d, math.ceil(TOPK_FRAC * d.shape[1]))
                args.append((x, y, my, d, t))
            return {"kernel": lambda: [ops.choco_topk(*a, GAMMA)
                                       for a in args],
                    "plain": lambda: [choco_fused.plain(*a, GAMMA)
                                      for a in args]}
        return Row("K3 choco_topk", "choco_topk", src + "choco_fused.py:108",
                   len(sizes), e, 24 * e + 4 * n * len(sizes), make)

    ks = [math.ceil(TOPK_FRAC * d) for d in sizes]

    def threshold():
        def make():
            xs = tree()
            xas = [x.abs() for x in xs]
            return {"kernel": lambda: ops.topk_threshold_many(xs, ks),
                    "plain": lambda: [topk.threshold_plain(x, k)
                                      for x, k in zip(xs, ks)],
                    "library": lambda: [torch.topk(xa, k, dim=1)
                                        for xa, k in zip(xas, ks)]}
        return Row("K4 topk_threshold", "topk_threshold", src + "topk.py:51",
                   len(sizes), e, 4 * e + 4 * n * len(sizes), make,
                   "torch.topk of |x|")

    def mask():
        def make():
            xs = tree()
            ts = [topk.threshold_plain(x, k) for x, k in zip(xs, ks)]
            return {"kernel": lambda: ops.topk_mask_many(xs, ts),
                    "plain": lambda: [topk.mask_plain(x, t)
                                      for x, t in zip(xs, ts)]}
        return Row("K5 topk_mask", "topk_mask", src + "topk.py:79",
                   len(sizes), e, 8 * e + 4 * n * len(sizes), make)

    def quantize():
        cs = [QSGD(levels=LEVELS)._c(d) for d in sizes]

        def make():
            xs = tree()
            noises = [torch.rand(n, d, generator=gen, device=dev)
                      for d in sizes]
            norms = [torch.linalg.vector_norm(x, dim=1) for x in xs]
            return {"kernel": lambda: ops.qsgd_quantize_many(
                        xs, noises, norms, LEVELS, cs),
                    "plain": lambda: [
                        qsgd.plain(x, z, nm, LEVELS, qsgd.scale(LEVELS, c))
                        for x, z, nm, c in zip(xs, noises, norms, cs)]}
        return Row("K6 qsgd_quantize", "qsgd_quantize", src + "qsgd.py:44",
                   len(sizes), e, 12 * e + 4 * n * len(sizes), make)

    def move():
        def make():
            args = list(zip(tree(), tree(), tree()))
            return {"kernel": lambda: [ops.choco_move(x, y, my, GAMMA)
                                       for x, y, my in args],
                    "plain": lambda: [choco_update.plain(x, y, my, GAMMA)
                                      for x, y, my in args]}
        return Row("K7 choco_move", "choco_move", src + "choco_update.py:38",
                   len(sizes), e, 20 * e, make)

    return [mix(ring(n), f"ring({n})"),
            mix(fully_connected(n), f"fully_connected({n})"),
            received(2), received(7), choco_qsgd(), choco_topk(), threshold(),
            mask(), quantize(), move()]


def _host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn()`` after one warm call (the CPU's
    plain versions; no device time)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def run_throughput(dev, reps: int, flavor: str) -> Dict:
    from repro_torch.benchmarks.timing import (card_line, cold_device_ms,
                                               device_ms)

    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = dev.type == "cuda"
    out = {"device": dev.type, "tree": flavor, "nodes": NODES,
           "bound": "bytes each input read once and each output written "
                    "once, at 3.35 TB/s",
           "rows": []}
    if on_card:
        out["card"] = card_line()
    else:
        out["note"] = ("plain versions' host times on the CPU: no kernel "
                       "runs and no speed is claimed")
    for row in throughput_rows(dev, gen, flavor):
        rec = {"row": row.row, "kernel": row.kernel, "replaces": row.replaces,
               "leaves": row.leaves, "elements": row.elements,
               "bytes": row.nbytes,
               "bound_ms": row.nbytes / HBM_BYTES_PER_S * 1e3,
               "library": row.library}
        calls = row.make()
        if not on_card:
            rec["plain_host_ms"] = _host_ms(calls["plain"], reps)
            out["rows"].append(rec)
            print(f"[throughput] {row.row:32s} plain "
                  f"{rec['plain_host_ms']:9.3f} host ms (cpu)")
            continue
        ran = _launched(calls["kernel"])
        want = calls["plain"]()
        rec.update(launches=ran["launches"],
                   bitwise_plain=same_bits(ran["out"], want),
                   max_abs_err=max_abs_err(ran["out"], want))
        keys = ["kernel", "plain"] + (["library"] if row.library else [])
        for when in ("warm", "dram"):
            t = {}
            for key in keys:
                if when == "warm":
                    t[key] = device_ms(calls[key], reps=reps)
                else:
                    t[key] = cold_device_ms(
                        lambda: row.make()[key], row.nbytes, reps=reps)
            rec[when] = {"ms": t["kernel"], "plain_ms": t["plain"],
                         "library_ms": t.get("library"),
                         "share": rec["bound_ms"] / t["kernel"]}
        del calls, ran, want
        torch.cuda.empty_cache()
        out["rows"].append(rec)
        print(f"[throughput] {row.row:32s} warm {rec['warm']['ms']:.4f} ms "
              f"DRAM {rec['dram']['ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ({100 * rec['dram']['share']:.0f}% "
              f"from DRAM), {rec['launches']} launches, plain "
              f"{rec['dram']['plain_ms']:.4f}, library "
              f"{rec['dram']['library_ms']}")
    return out


def _require(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def check(result: Dict) -> None:
    """``--check``: the structural asserts beyond those every run makes."""
    bp = result["buffer_passes"]
    if bp["device"] == "cuda":
        _require(bp["choco_qsgd"]["fused"]["by_kernel"] == {"choco_qsgd": 1},
                 bp)
        _require(bp["choco_topk"]["fused"]["by_kernel"] == {
            "topk_threshold": 1, "choco_topk": 1}, bp)
        for rec in result["throughput"]["rows"]:
            _require(rec["launches"] >= 1 and rec["bitwise_plain"], rec)
            for when in ("warm", "dram"):
                _require(all(math.isfinite(v) and v > 0 for v in (
                    rec[when]["ms"], rec[when]["plain_ms"])), rec)
    _require(all(result["topk_vs_reference"]["bitwise_by_frac"].values()),
             result["topk_vs_reference"])
    _require(result["parity"]["failures"] == 0, result["parity"])
    print("[check] structural acceptance asserts passed")


def main(argv=None) -> Dict:
    """Run the four sections; returns the payload it writes to ``--out``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's three smoke shapes for parity, a "
                         "smaller TopK check, the MNIST CNN's tree for "
                         "throughput and fewer repetitions")
    ap.add_argument("--check", action="store_true",
                    help="structural asserts beyond parity, TopK and buffer "
                         "passes, which every run asserts")
    ap.add_argument("--reps", type=int, default=0,
                    help="timing repetitions (default: 2 smoke / 5 full)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reps = args.reps or (2 if args.smoke else 5)

    result = {
        "meta": {
            "device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "smoke": bool(args.smoke), "reps": reps,
            "ops": [op.name for op in registry.list_ops()],
        },
        "parity": run_parity(args.smoke, dev),
        "topk_vs_reference": run_topk_vs_reference(args.smoke, dev),
        "buffer_passes": run_buffer_passes(dev),
        "throughput": run_throughput(dev, reps,
                                     "mnist" if args.smoke else "cifar"),
    }
    if args.check:
        check(result)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
