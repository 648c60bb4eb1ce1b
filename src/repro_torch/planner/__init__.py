"""The planner's cost models, ported from ``repro.planner``: per-round
wall-clock, energy and wire-bit prices of a DFL schedule
(``repro_torch.planner.cost``), which ``repro_torch.faults`` and the fault
and participation benches price their rounds with. The bounds, the
optimizer and the adaptive controller are still to port (ROADMAP.md)."""
from repro_torch.planner.cost import (
    ComputeModel,
    CostModel,
    CostProcess,
    Episode,
    LinkModel,
    RoundCost,
    WirelessLinks,
    comm_compute_cost,
    edge_outage,
    faded_links,
    straggler_links,
    unit_cost_model,
    wireless_link,
)

__all__ = [
    "ComputeModel", "CostModel", "CostProcess", "Episode", "LinkModel",
    "RoundCost", "WirelessLinks",
    "comm_compute_cost", "edge_outage", "faded_links", "straggler_links",
    "unit_cost_model", "wireless_link",
]
