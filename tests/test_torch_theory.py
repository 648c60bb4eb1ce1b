"""Proposition 1 on the analytic quadratic, through the port's numpy
testbed (``repro_torch.benchmarks.theory_check``), and ``docs/THEORY.md``'s
snippets run against the port.

The cases of the reference's ``tests/test_theory.py`` run on the port's
``check``; ``run_dfl_quadratic`` is held bitwise against the reference's
(same numpy draws, same arithmetic). THEORY.md's ``>>>`` blocks run through
doctest with ``repro.`` rewritten to ``repro_torch.`` here (never in the
doc) and the doc's expected outputs unchanged. Two blocks reach ``jax``,
which the port never imports (ROADMAP.md, standing constraints: package
boundary), and are skipped by name (``SKIPPED``); their wire-bit values are
held on the port's tensors in ``test_theory_md_wire_bits_on_the_port``.
"""
import doctest
import os
import re

import numpy as np
import pytest
import torch

import benchmarks.theory_check as jtc
from repro.core import topology as jtopology
from repro_torch.benchmarks import theory_check as tc
from repro_torch.core.topology import fully_connected, ring
from repro_torch.planner.bounds import lr_condition_19, max_eta_19

DOC = os.path.join(os.path.dirname(__file__), "..", "docs", "THEORY.md")

# THEORY.md blocks that reach a module the port lacks, by their first line
SKIPPED = {
    ">>> import jax.numpy as jnp":
        "tree_wire_bits / round_wire_bits on a jax array: the port never "
        "imports jax (standing constraint); the same values on a tensor in "
        "test_theory_md_wire_bits_on_the_port",
    ">>> import jax":
        "TopK against the reference's Pallas kernel (use_kernels=True): "
        "jax; the port's K4 / K5 are held against their plain versions on "
        "the card (chip_smoke.py phase 2)",
}
PORT_EXAMPLES = 64      # of THEORY.md's 78; SKIPPED's two blocks hold 14


@pytest.mark.parametrize("tau1,tau2", [(4, 1), (4, 4), (8, 2)])
def test_bound_holds(tau1, tau2):
    m, b = tc.check(tau1=tau1, tau2=tau2, topo=ring(8), rounds=150, seeds=3)
    assert m <= b, f"measured {m} exceeds bound {b}"


def test_sync_special_case():
    m, b = tc.check(tau1=1, tau2=1, topo=fully_connected(8), rounds=150,
                    seeds=3)
    assert m <= b


def test_condition_19_monotone_in_eta():
    topo = ring(8)
    emax = max_eta_19(4, 4, topo)
    assert lr_condition_19(emax * 0.5, 4, 4, topo)
    assert not lr_condition_19(emax * 1.5, 4, 4, topo)


def test_remark1_measured_ordering():
    """Measured gradient average improves with tau2 (Remark 1)."""
    m1, _ = tc.check(tau1=4, tau2=1, topo=ring(8), rounds=200, seeds=3)
    m8, _ = tc.check(tau1=4, tau2=8, topo=ring(8), rounds=200, seeds=3)
    assert m8 < m1


@pytest.mark.parametrize("topo_name,tau1,tau2,seed", [
    ("ring", 4, 2, 0), ("ring", 1, 8, 3), ("full", 1, 1, 1),
    ("quasi", 8, 0, 2)])
def test_run_dfl_quadratic_equals_reference(topo_name, tau1, tau2, seed):
    """The port's Algorithm 1 in matrix form is the reference's, bit for
    bit: the gradient average, the final stacked parameters and the
    targets; and so are ``check`` and ``measured_loss_at_budget``."""
    mk = {"ring": ("ring", (8,)), "full": ("fully_connected", (8,)),
          "quasi": ("paper_quasi_ring", ())}[topo_name]
    from repro_torch.core import topology

    t, jt = getattr(topology, mk[0])(*mk[1]), getattr(jtopology,
                                                      mk[0])(*mk[1])
    kw = dict(d=16, sigma=0.5, seed=seed, target_scale=0.8)
    got = tc.run_dfl_quadratic(0.03, tau1, tau2, t, 25, **kw)
    want = jtc.run_dfl_quadratic(0.03, tau1, tau2, jt, 25, **kw)
    assert got[0] == want[0]
    assert got[1].tobytes() == want[1].tobytes()
    assert got[2].tobytes() == want[2].tobytes()
    assert tc.quadratic_loss_gap(got[1], got[2]) == \
        jtc.quadratic_loss_gap(want[1], want[2])
    assert tc.measured_loss_at_budget(0.03, tau1, tau2, t, 20, seeds=2) == \
        jtc.measured_loss_at_budget(0.03, tau1, tau2, jt, 20, seeds=2)
    if tau2:
        assert tc.check(tau1=tau1, tau2=tau2, topo=t, rounds=30, seeds=2) == \
            jtc.check(tau1=tau1, tau2=tau2, topo=jt, rounds=30, seeds=2)


def test_theory_main_prints_and_holds(capsys):
    tc.main()
    out = capsys.readouterr().out
    assert "all bounds hold" in out and out.count("True") == 5


def _blocks():
    """THEORY.md's fenced blocks that hold ``>>>`` examples, in order."""
    text = open(DOC).read()
    return [b.strip("\n") + "\n" for b in re.findall(r"```\n(.*?)```", text,
                                                     flags=re.S)
            if ">>>" in b]


def test_theory_md_snippets_run_on_the_port():
    """Every THEORY.md block but the ``SKIPPED`` ones, ``repro.`` read as
    ``repro_torch.``, gives the doc's outputs on the port."""
    blocks = _blocks()
    skipped = [b for b in blocks if b.splitlines()[0].strip() in SKIPPED]
    assert len(skipped) == len(SKIPPED)
    run = [re.sub(r"\brepro\.", "repro_torch.", b) for b in blocks
           if b not in skipped]
    assert not any("jax" in b for b in run)
    parser = doctest.DocTestParser()
    test = parser.get_doctest("\n".join(run), {}, "THEORY.md (port)", DOC, 0)
    runner = doctest.DocTestRunner(
        optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE)
    runner.run(test)
    result = runner.summarize(verbose=False)
    assert result.failed == 0, f"{result.failed} THEORY.md snippets failed"
    assert result.attempted == PORT_EXAMPLES, result.attempted


def test_theory_md_wire_bits_on_the_port():
    """The values of THEORY.md's jax wire-bit block, on a tensor tree."""
    from repro_torch.core.compression import make_compressor, tree_wire_bits
    from repro_torch.core.dfl import DFLConfig, round_wire_bits

    topk = make_compressor("top_k", frac=0.25)
    params = {"w": torch.zeros(1000)}
    assert tree_wire_bits(topk, params) == 10500.0
    cfg_c = DFLConfig(tau1=4, tau2=2, topology=ring(8), compression=topk)
    assert round_wire_bits(cfg_c, params, engine="sparse") == 42000.0
    assert np.isclose(ring(8).zeta, 0.8047, atol=5e-5)
