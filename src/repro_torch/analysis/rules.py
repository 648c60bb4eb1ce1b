"""Named lint rules of the port: the invariants that have a torch meaning.

A rule is a pure function over one parsed source file; the engine in
``repro_torch.analysis.lint`` handles file iteration, ``# repro-lint:
disable=<rule> (<reason>)`` pragmas and the baseline. Rules are
*individually* suppressible and every suppression must state a reason —
a reasonless pragma is itself a violation (``bad-pragma``).

Ported from ``repro.analysis.rules`` with their torch meanings:

* ``no-import-time-backend-probe`` — no CUDA probe at import
  (``torch.cuda.is_available()`` and its kin at module or class-body
  scope): the tests import every module on a host without a card, and
  an entry point picks its device when it is called
  (``device.resolve_device``).
* ``no-host-coercion-of-device-scalars`` — no host read of a device
  tensor in round code (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``). The
  reference's tau is device data; the port's is host data by design (the
  executor reads step counts and masks from its host copy of the
  trajectory, ``core/executor.py``), so what a host read costs here is a
  wait for the card inside a dispatch, and inside a CUDA graph's capture
  an error.
* ``rng-discipline`` — draws go through the seam (``core/rng.py``,
  ``Draws.uniform``): no ``torch.rand`` and kin, no ``torch.Generator``,
  no in-place ``uniform_()`` and kin and no ``np.random`` in the other
  round-path modules, so the card's draws stay the CPU's bits.
* ``bad-pragma`` — an engine rule, as the reference's.

Not ported: ``compat-boundary`` keeps the version-sensitive JAX
``shard_map`` / ``axis_size`` spellings inside the reference's
``core/substrate.py``; the port calls no JAX API, and its sparse engine is
``torch.distributed`` (``core/sharded.py``). ``no-disable-jit`` keeps
``jax.disable_jit`` out of the reference's kernels, under which the Pallas
interpret-mode kernels recurse; the port has no jit and no interpret mode:
a CUDA tensor launches the hand-written kernel and a CPU tensor runs its
plain version (``kernels/ops.py``).

Path scoping uses posix suffixes (e.g. ``core/substrate.py``) so the
rules behave identically whether the engine was pointed at the repo
root, ``src/``, or the package directory.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["Rule", "RULES", "ROUND_PATH_FILES", "FileContext"]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named invariant. ``check(ctx)`` yields (lineno, message);
    ``check=None`` marks engine-level rules (emitted by the lint engine
    itself, e.g. ``bad-pragma``) that still need docs/pragma handling."""

    name: str
    description: str
    check: Optional[Callable[["FileContext"], Iterator[Tuple[int, str]]]]


@dataclasses.dataclass
class FileContext:
    """One parsed source file as the rules see it."""

    path: str            # posix path, e.g. "repro_torch/core/dfl.py"
    tree: ast.Module
    lines: List[str]

    def matches(self, *suffixes: str) -> bool:
        return any(self.path.endswith(s) for s in suffixes)


def _dotted(node: ast.AST) -> Optional[str]:
    """Resolve an Attribute/Name chain to 'a.b.c' (None for computed)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _method(call: ast.Call) -> Optional[str]:
    """``m`` for a call ``<expr>.m(...)``, else None."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else None


# ---------------------------------------------------------------------------
# no-import-time-backend-probe
# ---------------------------------------------------------------------------

_BACKEND_PROBES = {
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
    "torch.cuda.get_device_properties", "torch.cuda.init",
    "torch.backends.cudnn.version",
}


def _check_import_time_probe(ctx: FileContext):
    # Module scope = executed at import. Class bodies execute at import
    # too, so they stay "module scope"; only function/lambda bodies are
    # deferred. (Decorators and default-arg expressions also run at
    # import but probing there is unheard of — not modeled.)
    def visit(node: ast.AST, in_func: bool):
        for child in ast.iter_child_nodes(node):
            child_in_func = in_func or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if not in_func and isinstance(child, ast.Call):
                name = _dotted(child.func)
                if name in _BACKEND_PROBES:
                    yield child.lineno, (
                        f"{name}() at module scope: import-time CUDA probe "
                        "— the tests import every module on a host without "
                        "a card; pick the device when called "
                        "(device.resolve_device)")
            yield from visit(child, child_in_func)

    yield from visit(ctx.tree, False)


# ---------------------------------------------------------------------------
# no-host-coercion-of-device-scalars
# ---------------------------------------------------------------------------

# Modules on the round path: what runs inside a dispatch, between the
# replays of the executor's graphs and inside their captures.
ROUND_PATH_FILES = ("core/dfl.py", "core/sharded.py", "core/substrate.py",
                    "core/mixing.py", "core/compression.py", "core/graphs.py",
                    "core/rng.py")
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_READ_CALLS = {"torch.cuda.synchronize"}


def _to_cpu(call: ast.Call) -> bool:
    """``<expr>.to("cpu")`` or ``<expr>.to(device="cpu")``."""
    if _method(call) != "to":
        return False
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and isinstance(a.value, str)
               and a.value.split(":")[0] == "cpu" for a in args)


def _host_read(call: ast.Call) -> Optional[str]:
    name = _dotted(call.func)
    if name in _HOST_READ_CALLS:
        return f"{name}()"
    if _method(call) in _HOST_READ_METHODS:
        return f".{_method(call)}()"
    if _to_cpu(call):
        return '.to("cpu")'
    return None


def _check_host_coercion(ctx: FileContext):
    on_round_path = ctx.matches(*ROUND_PATH_FILES)
    is_executor = ctx.matches("core/executor.py")
    if not (on_round_path or is_executor):
        return

    # executor.py's methods read the host legitimately (trajectory checks,
    # the metrics flush); only its NESTED functions (the supersteps it
    # builds) are round code.
    def visit(node: ast.AST, depth: int):
        for child in ast.iter_child_nodes(node):
            d = depth + isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Call) and (on_round_path or d >= 2):
                what = _host_read(child)
                if what:
                    yield child.lineno, (
                        f"host read {what} in round code: a device tensor "
                        "read on the host waits for the card inside a "
                        "dispatch (and fails inside a graph's capture); "
                        "round code reads step counts and masks from the "
                        "trajectory's host copy (core/executor.py)")
            yield from visit(child, d)

    yield from visit(ctx.tree, 0)


# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

_RAW_DRAW_CALLS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.Generator", "torch.manual_seed",
}
_RAW_DRAW_METHODS = {"uniform_", "normal_", "random_", "exponential_",
                     "bernoulli_"}


def _raw_draw(call: ast.Call) -> Optional[str]:
    name = _dotted(call.func) or ""
    if name in _RAW_DRAW_CALLS or name.startswith(("np.random.",
                                                   "numpy.random.")):
        return f"{name}()"
    if _method(call) in _RAW_DRAW_METHODS:
        return f".{_method(call)}()"
    return None


def _check_rng_discipline(ctx: FileContext):
    if not ctx.matches(*ROUND_PATH_FILES) or ctx.matches("core/rng.py"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            what = _raw_draw(node)
            if what:
                yield node.lineno, (
                    f"{what} in a round-path module: draws go through the "
                    "seam (core/rng.py, Draws.uniform) — a draw outside it "
                    "breaks the card's bitwise agreement with the CPU and "
                    "with the reference's replayed draws")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

RULES: Dict[str, Rule] = {
    r.name: r
    for r in [
        Rule(
            "no-import-time-backend-probe",
            "No torch.cuda.is_available()/device_count()/... at module "
            "scope — the device is picked when an entry point is called.",
            _check_import_time_probe,
        ),
        Rule(
            "no-host-coercion-of-device-scalars",
            "No .item()/.tolist()/.cpu()/.numpy()/.to('cpu')/"
            "torch.cuda.synchronize() in round code — each is a wait for "
            "the card inside a dispatch.",
            _check_host_coercion,
        ),
        Rule(
            "rng-discipline",
            "No torch.rand*/Generator/manual_seed, in-place random fills or "
            "np.random in round-path modules; draws go through the seam "
            "(core/rng.py).",
            _check_rng_discipline,
        ),
        Rule(
            "bad-pragma",
            "Every `# repro-lint: disable=<rule>` pragma must name a known "
            "rule and carry a (reason) — no silent allowlisting.",
            None,  # emitted by the engine while applying pragmas
        ),
    ]
}
