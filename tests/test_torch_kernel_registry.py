"""The port's kernel registry, oracles and ``bench_kernels`` against the JAX
reference's (``repro.kernels.registry``, ``repro.kernels.ref``).

The oracles are held to the reference's oracles on the same numpy inputs:
``top_k_ref`` bitwise; the others within 1e-6 of the larger of 1 and |want|
in f32 (XLA on the CPU contracts the CHOCO move into an FMA, and its norm
sums in another order, so the last f32 bit may differ) and within one bf16
ulp of want in bf16. The parity harness runs on the CPU here (the kernels'
plain versions); ``chip_smoke.py --only bench_kernels`` runs it on the card.
"""
import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import registry as jregistry
from repro_torch.benchmarks import bench_kernels
from repro_torch.kernels import ref, registry

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-6
ORACLES = ("qsgd_ref", "gossip_mix_ref", "choco_move_ref", "top_k_ref",
           "choco_qsgd_ref", "choco_topk_ref")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |v| (8 bits of mantissa precision)."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _within(got, want, dtype: str, bitwise: bool) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    if bitwise:
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
    elif dtype == "float32":
        assert np.all(np.abs(g - w) <= F32_TOL * np.maximum(1.0, np.abs(w)))
    else:
        assert np.all(np.abs(g - w) <= _bf16_ulp(w))


def _oracle_case(name, shape, rng):
    """The oracle's numpy arguments and keyword arguments."""
    def normal(s=shape, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    n = int(np.prod(shape))
    c = 1.0 + min(n / 256.0, n ** 0.5 / 16.0)
    k = max(1, n // 4)
    if name == "qsgd_ref":
        return (normal(scale=3.0), rng.random(shape, dtype=np.float32)), {
            "levels": 16, "c": c}
    if name == "gossip_mix_ref":
        return (normal(), normal((2,) + tuple(shape)),
                np.array([0.5, 0.25, 0.25], np.float32)), {}
    if name == "choco_move_ref":
        return (normal(), normal(), normal(), 0.37), {}
    if name == "top_k_ref":
        return (normal(), k), {}
    if name == "choco_qsgd_ref":
        return (normal(), normal(), normal(), 0.5,
                rng.random(shape, dtype=np.float32)), {"levels": 16, "c": c}
    return (normal(), normal(), normal(), 0.5, k), {}


# the arguments cast to the case's dtype (noise and weights stay f32)
_CAST = {"qsgd_ref": (0,), "gossip_mix_ref": (0, 1),
         "choco_move_ref": (0, 1, 2), "top_k_ref": (0,),
         "choco_qsgd_ref": (0, 1, 2), "choco_topk_ref": (0, 1, 2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", bench_kernels.SMOKE_SHAPES, ids=str)
@pytest.mark.parametrize("name", ORACLES)
def test_oracle_matches_reference_oracle(name, shape, dtype):
    rng = np.random.default_rng(int(np.prod(shape)) + len(name))
    args, kw = _oracle_case(name, shape, rng)
    jdt, tdt = DTYPES[dtype]
    jargs = [jnp.asarray(a).astype(jdt) if i in _CAST[name]
             else (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
             for i, a in enumerate(args)]
    targs = [torch.from_numpy(a).to(tdt) if i in _CAST[name]
             else (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
             for i, a in enumerate(args)]
    want = getattr(jref, name)(*jargs, **kw)
    got = getattr(ref, name)(*targs, **kw)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _within(g, w, dtype, bitwise=name == "top_k_ref")


def test_registry_names_flags_and_shapes_are_the_reference_s():
    assert [(op.name, op.bitwise) for op in registry.list_ops()] == [
        (op.name, op.bitwise) for op in jregistry.list_ops()]
    assert registry.PARITY_SHAPES == jregistry.PARITY_SHAPES
    assert [registry.dtype_name(d) for d in registry.PARITY_DTYPES] == [
        np.dtype(d).name for d in jregistry.PARITY_DTYPES]
    assert registry.get_op("topk_mask").bitwise
    with pytest.raises(ValueError, match="unknown kernel op"):
        registry.get_op("pallas_call")


def test_parity_suite_on_cpu_is_ok_with_the_reference_s_records():
    shapes = bench_kernels.SMOKE_SHAPES
    records = registry.parity_suite(shapes=shapes, device="cpu")
    assert records and all(r["ok"] for r in records)
    assert all(r["max_err"] == 0.0 for r in records if r["bitwise"])
    want = jregistry.parity_suite(shapes=shapes)
    keys = ("op", "shape", "dtype", "bitwise")
    assert [tuple(r[k] for k in keys) for r in records] == [
        tuple(r[k] for k in keys) for r in want]
    assert set(records[0]) == set(want[0])


def test_oracles_are_written_apart_from_the_kernel_modules():
    """``ref.py`` imports no module of the port, so no oracle can call a
    kernel module's plain version."""
    with open(ref.__file__) as f:
        tree = ast.parse(f.read())
    imported = {a.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom)}
    assert imported <= {"__future__", "typing", "torch"}


def test_bench_kernels_smoke_on_cpu_writes_what_it_returns(tmp_path, capsys):
    out = tmp_path / "bk.json"
    payload = bench_kernels.main(["--smoke", "--check", "--device", "cpu",
                                  "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    assert payload["meta"]["device"] == "cpu"
    assert payload["meta"]["ops"] == [op.name for op in jregistry.list_ops()]
    par = payload["parity"]
    assert par["failures"] == 0 and par["records"] == 7 * 3 * 2
    assert par["max_err_by_op"]["topk_partials"] == 0.0
    assert par["max_err_by_op"]["topk_mask"] == 0.0
    assert payload["topk_vs_reference"]["bitwise_by_frac"] == {
        str(f): True for f in bench_kernels.TOPK_FRACS}
    bp = payload["buffer_passes"]
    assert "nothing launches" in bp["note"]
    for name in ("choco_qsgd", "choco_topk"):
        assert bp[name]["fused"]["launches"] == 0
        assert bp[name]["unfused"]["launches"] == 0
        assert bp[name]["same_result"]
    tp = payload["throughput"]
    assert tp["device"] == "cpu" and tp["tree"] == "mnist"
    assert "no speed" in tp["note"]
    rows = {r["row"]: r for r in tp["rows"]}
    assert list(rows) == [
        "K1 gossip_mix ring(10)", "K1 gossip_mix fully_connected(10)",
        "K1-received deg 2", "K1-received deg 7", "K2 choco_qsgd",
        "K3 choco_topk", "K4 topk_threshold", "K5 topk_mask",
        "K6 qsgd_quantize", "K7 choco_move"]
    e = 10 * sum(bench_kernels.leaf_sizes("mnist"))
    assert rows["K7 choco_move"]["bytes"] == 20 * e
    assert rows["K1-received deg 2"]["elements"] == e // 10
    for r in rows.values():
        assert r["plain_host_ms"] > 0 and "warm" not in r and "dram" not in r
    assert "structural acceptance asserts passed" in capsys.readouterr().out
    assert bench_kernels.DEFAULT_OUT.endswith(
        os.path.join("results", "repro_torch", "BENCH_kernels.json"))


def test_card_is_the_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.parity_suite()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_kernels.main(["--smoke"])
