"""The port's lint (``repro_torch.analysis.lint`` / ``rules``) against the
reference's (``repro.analysis.lint``, which imports no jax).

* the engines: on the same synthetic sources both give the same
  ``(rule, path, line)`` tuples for ``bad-pragma``, for the suppressions
  and for the rule findings the sources carry (``tau2.item()`` in a
  ``core/dfl.py``, which both engines flag); baseline demotion the same;
* the probe rule's scoping: the reference's module / class body / function
  body sources, ``jax.devices()`` replaced by ``torch.cuda.device_count()``,
  flag the same lines;
* each torch rule: a flag case and a pass case;
* the shipped tree lints clean, every suppression and baseline entry has a
  reason, and the CLI needs neither torch nor numpy.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint, rules
from repro_torch.analysis.lint import lint_paths, lint_source, lint_tree
from repro_torch.analysis.rules import RULES, ROUND_PATH_FILES

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
COERCION = "no-host-coercion-of-device-scalars"
PROBE = "no-import-time-backend-probe"


def lint_snippet(src, path, engine=lint):
    return engine.lint_source(textwrap.dedent(src), path)


def rules_of(violations):
    return [v.rule for v in violations]


def tuples(violations):
    return sorted((v.rule, v.path, v.line) for v in violations)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "reason_same_and_previous_line": """
        def round_body(tau2):
            a = tau2.item()  # repro-lint: disable=no-host-coercion-of-device-scalars (static trace-time int)
            # repro-lint: disable=no-host-coercion-of-device-scalars (second form)
            b = tau2.item()
            return a + b
        """,
    "no_reason": """
        def round_body(tau2):
            return tau2.item()  # repro-lint: disable=no-host-coercion-of-device-scalars
        """,
    "unknown_rule": """
        x = 1  # repro-lint: disable=no-such-rule (because)
        """,
    "unknown_and_known_rule": """
        def round_body(tau2):
            return tau2.item()  # repro-lint: disable=no-such-rule,no-host-coercion-of-device-scalars (why)
        """,
    "does_not_reach_past_code": """
        def round_body(tau2):
            # repro-lint: disable=no-host-coercion-of-device-scalars (meant for next line only)
            x = 1
            return tau2.item()
        """,
    "all_rules": """
        def round_body(tau2):
            return tau2.item()  # repro-lint: disable=all (every rule)
        """,
    "unparseable": """
        # repro-lint disable=no-host-coercion-of-device-scalars (typo)
        x = 1
        """,
    "does_not_parse": """
        def f(:
            pass
        """,
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_findings_equal_the_reference(case):
    path = "pkg/core/dfl.py"
    v, s = lint_snippet(ENGINE_CASES[case], path)
    rv, rs = lint_snippet(ENGINE_CASES[case], path, ref_lint)
    assert tuples(v) == tuples(rv)
    assert tuples(x for x in v if x.rule == "bad-pragma") == tuples(
        x for x in rv if x.rule == "bad-pragma")
    assert sorted((x.rule, x.path, x.line, x.reason) for x in s) == sorted(
        (x.rule, x.path, x.line, x.reason) for x in rs)


def test_engine_cases_cover_each_escape_hatch():
    path = "pkg/core/dfl.py"
    v, s = lint_snippet(ENGINE_CASES["reason_same_and_previous_line"], path)
    assert v == [] and {x.reason for x in s} == {"static trace-time int",
                                                 "second form"}
    v, s = lint_snippet(ENGINE_CASES["no_reason"], path)
    assert sorted(rules_of(v)) == ["bad-pragma", COERCION] and s == []
    v, _ = lint_snippet(ENGINE_CASES["unknown_rule"], path)
    assert rules_of(v) == ["bad-pragma"] and "no-such-rule" in v[0].message
    v, _ = lint_snippet(ENGINE_CASES["does_not_reach_past_code"], path)
    assert rules_of(v) == [COERCION]
    v, s = lint_snippet(ENGINE_CASES["all_rules"], path)
    assert v == [] and len(s) == 1


def test_baseline_demotion_equals_the_reference(tmp_path):
    (tmp_path / "core").mkdir()
    bad = tmp_path / "core" / "dfl.py"
    bad.write_text("def round_body(tau2):\n    return tau2.item()\n")
    reports = {}
    for name, engine in (("port", lint), ("ref", ref_lint)):
        first = engine.lint_paths([str(bad)], rel_to=str(tmp_path),
                                  baseline=set())
        fp = first.new[0].fingerprint
        second = engine.lint_paths([str(bad)], rel_to=str(tmp_path),
                                   baseline={fp})
        reports[name] = (fp, first.ok, second.ok,
                         tuples(second.baselined), second.files_scanned)
    assert reports["port"] == reports["ref"]
    assert reports["port"][0] == f"{COERCION}::core/dfl.py::2"
    assert reports["port"][1:3] == (False, True)


def test_reference_lint_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=SRC)
    probe = ("import json, sys, repro.analysis.lint; "
             "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib")]


# ---------------------------------------------------------------------------
# no-import-time-backend-probe
# ---------------------------------------------------------------------------

PROBE_SCOPES = {
    "module": ("""
        import jax
        N_DEV = len(jax.devices())
        """, """
        import torch
        N_DEV = torch.cuda.device_count()
        """),
    "class_body_not_function": ("""
        import jax

        class Cfg:
            backend = jax.devices()

        def ok():
            return jax.devices()
        """, """
        import torch

        class Cfg:
            backend = torch.cuda.device_count()

        def ok():
            return torch.cuda.device_count()
        """),
    "function_body": ("""
        import jax

        def ok():
            def inner():
                return jax.devices()
            return inner, lambda: jax.devices()
        """, """
        import torch

        def ok():
            def inner():
                return torch.cuda.device_count()
            return inner, lambda: torch.cuda.device_count()
        """),
}


@pytest.mark.parametrize("scope", sorted(PROBE_SCOPES))
def test_probe_scoping_flags_the_reference_lines(scope):
    ref_src, port_src = PROBE_SCOPES[scope]
    rv, _ = lint_snippet(ref_src, "repro/launch/train.py", ref_lint)
    v, _ = lint_snippet(port_src, "repro_torch/launch/train.py")
    assert [(x.rule, x.line) for x in v] == [(x.rule, x.line) for x in rv]
    assert rules_of(v) == ([PROBE] if scope != "function_body" else [])


@pytest.mark.parametrize("call", sorted(rules._BACKEND_PROBES))
def test_probe_rule_flags_each_probe_at_module_scope(call):
    v, _ = lint_snippet(f"import torch\nX = {call}()\n",
                        "repro_torch/kernels/build.py")
    assert rules_of(v) == [PROBE] and v[0].line == 2
    v, _ = lint_snippet(f"import torch\n\ndef f():\n    return {call}()\n",
                        "repro_torch/kernels/build.py")
    assert v == []


# ---------------------------------------------------------------------------
# no-host-coercion-of-device-scalars
# ---------------------------------------------------------------------------

HOST_READS = ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
              'x.to("cpu")', "x.to(device='cpu')", "x.to('cpu:0')",
              "torch.cuda.synchronize()"]


@pytest.mark.parametrize("read", HOST_READS)
def test_host_read_flagged_in_round_code(read):
    src = f"import torch\n\ndef step(x):\n    return {read}\n"
    for path in ROUND_PATH_FILES:
        v, _ = lint_snippet(src, f"repro_torch/{path}")
        assert rules_of(v) == [COERCION] and v[0].line == 4, path


def test_host_read_passes_off_the_round_path_and_for_device_moves():
    v, _ = lint_snippet("def f(x):\n    return x.item()\n",
                        "repro_torch/launch/train.py")
    assert v == []
    v, _ = lint_snippet(
        """
        import torch

        def step(x, dev):
            return x.to("cuda"), x.to(torch.float32), x.to(dev), x.sum()
        """, "repro_torch/core/dfl.py")
    assert v == []


def test_host_read_executor_scoped_to_nested_functions():
    src = """
    class Ex:
        def flush(self, x):
            rows = x.cpu()                # the metrics flush: fine

            def superstep(state):
                return state.item()       # built round code: flagged
            return superstep
    """
    v, _ = lint_snippet(src, "repro_torch/core/executor.py")
    assert rules_of(v) == [COERCION] and v[0].line == 7
    rv, _ = lint_snippet(src.replace("state.item()", "float(tau1)"),
                         "repro/core/executor.py", ref_lint)
    assert [x.line for x in rv] == [x.line for x in v]


# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

RAW_DRAWS = sorted(f"{c}(3)" for c in rules._RAW_DRAW_CALLS) + [
    "np.random.default_rng(0)", "np.random.normal(size=3)",
    "numpy.random.rand(3)"] + sorted(
    f"x.{m}()" for m in rules._RAW_DRAW_METHODS)


@pytest.mark.parametrize("draw", RAW_DRAWS)
def test_rng_rule_flags_raw_draws_on_round_path(draw):
    src = f"import torch\n\ndef f(x):\n    return {draw}\n"
    v, _ = lint_snippet(src, "repro_torch/core/compression.py")
    assert rules_of(v) == ["rng-discipline"] and v[0].line == 4
    for path in ("repro_torch/core/rng.py", "repro_torch/launch/train.py"):
        v, _ = lint_snippet(src, path)
        assert v == [], path


def test_rng_rule_allows_the_seam():
    v, _ = lint_snippet(
        """
        def compress(draws, r, step, leaf, shape):
            return draws.uniform(r, step, leaf, shape)
        """, "repro_torch/core/compression.py")
    assert v == []


# ---------------------------------------------------------------------------
# the registry and the shipped tree
# ---------------------------------------------------------------------------


def test_registry_ports_the_rules_with_a_torch_meaning():
    assert set(RULES) == {PROBE, COERCION, "rng-discipline", "bad-pragma"}
    assert set(RULES) < set(ref_lint.RULES)
    for rule in RULES.values():
        assert rule.description
    for dropped in set(ref_lint.RULES) - set(RULES):
        assert f"``{dropped}``" in rules.__doc__


def test_source_tree_is_lint_clean():
    report = lint_tree()
    assert report.files_scanned > 90
    assert report.ok, "\n".join(v.render() for v in report.new)
    assert report.to_dict()["rules"] == sorted(RULES)


def test_every_suppression_and_baseline_entry_has_a_reason():
    report = lint_tree()
    assert report.suppressed
    for s in report.suppressed:
        assert s.reason.strip(), f"reasonless suppression at {s.path}:{s.line}"
    with open(lint.default_baseline_path()) as f:
        data = json.load(f)
    assert all(str(data["reasons"].get(fp, "")).strip()
               for fp in data["fingerprints"])
    assert lint.load_baseline() == set(data["fingerprints"]) == set()


def test_baseline_entry_without_a_reason_is_refused(tmp_path):
    fp = f"{COERCION}::repro_torch/core/dfl.py::2"
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"fingerprints": [fp], "reasons": {}}))
    with pytest.raises(ValueError, match="without a reason"):
        lint.load_baseline(str(path))
    path.write_text(json.dumps({"fingerprints": [fp],
                                "reasons": {fp: "tracked debt"}}))
    assert lint.load_baseline(str(path)) == {fp}


def test_lint_cli_exits_0_and_imports_neither_torch_nor_numpy(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out_json = tmp_path / "lint.json"
    probe = ("import json, sys; from repro_torch.analysis.__main__ import "
             f"main; rc = main(['lint', '--json', {str(out_json)!r}]); "
             "print(json.dumps([rc, sorted(sys.modules)]))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    rc, mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0
    assert not {"torch", "numpy", "jax", "repro"} & {m.split(".")[0]
                                                     for m in mods}
    report = json.loads(out_json.read_text())
    assert report["ok"] and report["new"] == []
    cli = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "lint"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert cli.returncode == 0, cli.stdout + cli.stderr


def test_lint_paths_reports_a_new_violation(tmp_path):
    bad = tmp_path / "core" / "dfl.py"
    bad.parent.mkdir()
    bad.write_text("def f(x):\n    return x.item()\n")
    report = lint_paths([str(bad)], rel_to=str(tmp_path), baseline=set())
    assert not report.ok and tuples(report.new) == [
        (COERCION, "core/dfl.py", 2)]
    v, _ = lint_source("x = 1\n", "repro_torch/core/dfl.py")
    assert v == []
