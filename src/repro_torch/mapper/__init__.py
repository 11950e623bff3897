"""Mapper: mapping-search subsystem (layer -> mesh schedules), a copy of
``repro.mapper`` for the port's plan builder.

The paper evaluates exactly one mapping per layer — the fixed WS placement
of Eqs. (1)-(4) on a square N x N mesh.  This subsystem treats the mapping
as a *search problem*: it enumerates candidate placements per layer
(:mod:`.space` — rectangular meshes, chain grouping, PEs/router, precision,
WS/OS dataflow, INA vs eject/inject semantics), prunes with the analytical
model, scores survivors exactly on the event-driven simulator through the
plan-keyed sim cache (:mod:`.search`), and emits a whole-network
:class:`~.schedule.NetworkSchedule` replayable on the collective program
engine (:mod:`.schedule`).

With the GEMM front-end (:mod:`repro_torch.core.ops`) the search covers
FC and transformer layers; the plan builder
(:func:`repro_torch.plan.gemm_verdicts`) runs it over each config's decoder
GEMMs.  Design notes: DESIGN.md S9.
"""
from .schedule import LayerAssignment, NetworkSchedule
from .search import SearchOutcome, evaluate_mapping, search_network
from .space import (DATAFLOWS, Mapping, MapperConfig, PAPER_MAPPING,
                    QUICK_MAPPER, SEMANTICS, analytic_latency,
                    hardware_candidates, hardware_mapping_fields,
                    layer_candidates, shard_layer)

__all__ = [
    "Mapping", "MapperConfig", "PAPER_MAPPING", "QUICK_MAPPER",
    "DATAFLOWS", "SEMANTICS",
    "LayerAssignment", "NetworkSchedule",
    "SearchOutcome", "search_network", "evaluate_mapping",
    "analytic_latency", "hardware_candidates", "hardware_mapping_fields",
    "layer_candidates", "shard_layer",
]
