"""The port's planner cost models (``repro_torch.planner.cost``) against the
reference's (``repro.planner.cost``): the same numpy arithmetic over the
port's topology, mixing and compressor copies, so every price equals the
reference's to 1e-12 relative: round costs per engine, compressor, link
table and overlap mode, masked round costs over surviving sets, the link
transforms, and a fault plan's episodes and cost process.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core import compression as jcompression
from repro.core import metrics as jmetrics
from repro.core import topology as jtopology
from repro.faults import FaultPlan as JFaultPlan
from repro.faults import LinkFlap as JLinkFlap
from repro.faults import LinkOutage as JLinkOutage
from repro.faults import NodeCrash as JNodeCrash
from repro.faults import StragglerDelay as JStragglerDelay
from repro.planner import cost as jcost
from repro_torch import faults
from repro_torch import planner
from repro_torch.core import compression, metrics, topology
from repro_torch.planner import cost

TOPOLOGIES = {"ring8": ("ring", (8,)), "torus": ("torus", (2, 4)),
              "quasi": ("paper_quasi_ring", ()), "full5": ("fully_connected",
                                                           (5,))}
COMPRESSORS = {"none": None, "top_k": ("top_k", {"frac": 0.3}),
               "qsgd": ("qsgd", {"levels": 8}),
               "rand_k": ("rand_k", {"frac": 0.5}),
               "rand_gossip": ("rand_gossip", {"p": 0.7})}


def topos(name):
    fn, args = TOPOLOGIES[name]
    return getattr(topology, fn)(*args), getattr(jtopology, fn)(*args)


def comps(name):
    spec = COMPRESSORS[name]
    if spec is None:
        return None, None
    return (compression.make_compressor(spec[0], **spec[1]),
            jcompression.make_compressor(spec[0], **spec[1]))


def links(kind, topo, mod):
    """The same link table built by either module."""
    base = mod.LinkModel(bytes_per_s=2.5e6, latency_s=1e-3,
                         joules_per_byte=3e-9)
    if kind == "shared":
        return base
    edges = topo.edges()
    per_edge = {edges[0]: mod.wireless_link(2e6, 12.0, efficiency=0.7),
                edges[-1]: mod.LinkModel(bytes_per_s=4e5, latency_s=2e-3)}
    return mod.WirelessLinks(default=base, per_edge=per_edge,
                             concurrency=kind)


def models(topo_name, link_kind, engine="sparse", overlap="none"):
    (t, jt) = topos(topo_name)
    out = []
    for mod, tp in ((cost, t), (jcost, jt)):
        out.append(mod.CostModel(
            compute=mod.ComputeModel(step_flops=3e9, flops_per_s=2e12,
                                     joules_per_flop=1e-11),
            link=links(link_kind, tp, mod), topology=tp,
            model_bits=32.0 * 576778, engine=engine, overlap=overlap))
    return out


def assert_cost_equal(got, want):
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        assert a == pytest.approx(b, rel=1e-12, abs=1e-300), field.name
    assert got.comm_fraction == pytest.approx(want.comm_fraction, rel=1e-12)


@pytest.mark.parametrize("comp", sorted(COMPRESSORS))
@pytest.mark.parametrize("link_kind", ["shared", "parallel", "serial"])
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_round_cost_equals_reference(topo_name, link_kind, comp):
    c, jc = comps(comp)
    for engine in ("sparse", "dense"):
        for overlap in ("none", "pipeline"):
            m, jm = models(topo_name, link_kind, engine, overlap)
            assert m.copies_per_step() == jm.copies_per_step()
            assert m.compression_ratio(c) == jm.compression_ratio(jc)
            for tau1, tau2 in ((1, 1), (4, 4), (3, 0), (2, 7)):
                assert_cost_equal(m.round_cost(tau1, tau2, c),
                                  jm.round_cost(tau1, tau2, jc))


@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_masked_round_cost_equals_reference(topo_name):
    """Over random surviving sets, every compressor, both link tables."""
    rng = np.random.default_rng(4)
    for link_kind in ("shared", "parallel"):
        m, jm = models(topo_name, link_kind)
        edges = m.topology.edges()
        for comp in sorted(COMPRESSORS):
            c, jc = comps(comp)
            for _ in range(6):
                nodes = [i for i in range(m.topology.num_nodes)
                         if rng.random() < 0.7]
                act = [e for e in edges if rng.random() < 0.6]
                kw = dict(active_nodes=nodes, active_edges=act)
                assert_cost_equal(m.masked_round_cost(2, 3, c, **kw),
                                  jm.masked_round_cost(2, 3, jc, **kw))
        full = dict(active_nodes=range(m.topology.num_nodes),
                    active_edges=edges)
        assert_cost_equal(m.masked_round_cost(2, 1, **full),
                          jm.masked_round_cost(2, 1, **full))
        empty = m.masked_round_cost(2, 1, active_nodes=[], active_edges=[])
        assert empty.time_s == 0.0 and empty.energy_j == 0.0


@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_link_transforms_equal_reference(topo_name):
    """edge_outage, straggler_links and faded_links on both link kinds,
    priced through a round."""
    for link_kind in ("shared", "parallel"):
        m, jm = models(topo_name, link_kind)
        edges = m.topology.edges()
        for make in (
                lambda mod, lk: mod.edge_outage(lk, edges[:2], residual=1e-2),
                lambda mod, lk: mod.edge_outage(lk, [edges[-1]]),
                lambda mod, lk: mod.straggler_links(lk, m.topology
                                                    if mod is cost
                                                    else jm.topology, 1, 3.0),
                lambda mod, lk: mod.faded_links(lk, 2.5)):
            got = dataclasses.replace(m, link=make(cost, m.link))
            want = dataclasses.replace(jm, link=make(jcost, jm.link))
            assert_cost_equal(got.round_cost(3, 2), want.round_cost(3, 2))


def test_cost_process_and_unit_models_equal_reference():
    t, jt = topos("ring8")
    m, jm = models("ring8", "parallel")
    eps = [(0.0, 5.0, 1.0), (3.0, 9.0, 2.0), (8.0, 12.0, 4.0)]
    proc = cost.CostProcess(m, tuple(cost.Episode(
        a, b, link=cost.edge_outage(m.link, [t.edges()[0]]),
        compute_scale=s) for a, b, s in eps))
    jproc = jcost.CostProcess(jm, tuple(jcost.Episode(
        a, b, link=jcost.edge_outage(jm.link, [jt.edges()[0]]),
        compute_scale=s) for a, b, s in eps))
    assert proc.horizon() == jproc.horizon() and not proc.is_static
    for clock in np.linspace(0.0, 13.0, 27):
        assert_cost_equal(proc.at(clock).round_cost(2, 2),
                          jproc.at(clock).round_cost(2, 2))
    for ratio in (0.1, 1.0, 7.5):
        for engine in ("sparse", "dense"):
            assert_cost_equal(
                cost.unit_cost_model(t, ratio, engine=engine).round_cost(
                    3, 1, compression.make_compressor("qsgd")),
                jcost.unit_cost_model(jt, ratio, engine=engine).round_cost(
                    3, 1, jcompression.make_compressor("qsgd")))
    kw = dict(step_flops=1e9, model_bytes=4e6, degree=2, flops_per_s=1e12,
              link_bytes_per_s=1e9, bits_per_value_ratio=0.25)
    assert cost.comm_compute_cost(3, 2, 10, **kw) == \
        jcost.comm_compute_cost(3, 2, 10, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert metrics.comm_compute_cost(3, 2, 10, **kw) == \
            jmetrics.comm_compute_cost(3, 2, 10, **kw)
    with pytest.warns(DeprecationWarning, match="repro_torch.planner"):
        metrics.comm_compute_cost(1, 1, 1, **kw)
    with pytest.raises(ValueError, match="overlap"):
        cost.CostModel(compute=m.compute, link=m.link, topology=t,
                       model_bits=1.0, overlap="sideways")
    assert set(planner.__all__) <= set(cost.__all__)


def test_fault_plan_prices_equal_reference():
    """A plan with overlapping crash, outage, flap and straggler windows:
    its episodes (bounds, compute scales, labels) and the round costs of
    its cost process along the deployment clock."""
    t, jt = topos("ring8")
    m, jm = models("ring8", "parallel")
    kinds = [("crash", dict(node=0, r_start=0, r_stop=10)),
             ("outage", dict(edges=((3, 4), (5, 6)), r_start=4, r_stop=12)),
             ("flap", dict(edge=(3, 4), period=3, up_rounds=1, r_start=5,
                           r_stop=10)),
             ("straggler", dict(node=1, slowdown=4.0, r_start=2, r_stop=6))]
    port = {"crash": faults.NodeCrash, "outage": faults.LinkOutage,
            "flap": faults.LinkFlap, "straggler": faults.StragglerDelay}
    ref = {"crash": JNodeCrash, "outage": JLinkOutage, "flap": JLinkFlap,
           "straggler": JStragglerDelay}
    plan = faults.FaultPlan(t, tuple(port[k](**kw) for k, kw in kinds))
    jplan = JFaultPlan(jt, tuple(ref[k](**kw) for k, kw in kinds))
    for spr, residual in ((1.0, 1e-3), (2.5, 1e-2)):
        eps, jeps = plan.episodes(spr, residual=residual), jplan.episodes(
            spr, residual=residual)
        assert [(e.t_start, e.t_stop, e.compute_scale, e.label)
                for e in eps] == [(e.t_start, e.t_stop, e.compute_scale,
                                   e.label) for e in jeps]
        proc = plan.cost_process(m, spr, residual=residual)
        jproc = jplan.cost_process(jm, spr, residual=residual)
        for clock in np.arange(0.0, 14.0 * spr, 0.5 * spr):
            for taus in ((1, 1), (4, 0), (2, 3)):
                assert_cost_equal(proc.at(clock).round_cost(*taus),
                                  jproc.at(clock).round_cost(*taus))
    with pytest.raises(ValueError, match="seconds_per_round"):
        plan.episodes(0.0)
