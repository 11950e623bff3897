"""Mapping search: analytic pruning + exact scoring through the sim cache
(a copy of ``repro.mapper.search``, heap engine only).

Per hardware point, each layer's candidate mappings are ranked by the
analytical model and only the best few reach the event-driven simulator —
whose results are memoized per plan shape in
:data:`repro_torch.core.noc.simcache.SIM_CACHE`, so a whole-network search costs a
handful of distinct window programs rather than |layers| x |candidates| sim
runs.

Selection is *baseline-dominating* constrained optimization: the reference
is the paper's fixed mapping (:data:`~.space.PAPER_MAPPING`) simulated per
layer; per layer the mapper minimizes latency subject to the layer's
baseline energy, and across hardware points it picks the lowest-latency
schedule whose network totals weakly dominate the baseline's (the baseline
hardware always qualifies when it is inside the budget, so the searched
schedule is never worse than the paper's on either axis — equality when the
paper mapping is already optimal).  Everything is deterministic: no RNG,
total sort keys, cache hits bit-identical to ground truth.

A mapping with ``chips`` > 1 is priced as its per-chip shard plus a
package broadcast of each weight fill (:mod:`repro_torch.core.noc.
hierarchy`), and ``debug=True`` statically verifies the winning schedule
(:func:`repro_torch.analysis.verify.verify_schedule`), as the reference
does.  What the port leaves out: the reference's engine switches and its
batched window prefetch (the compiled and vectorized executors, out of
scope in ``ROADMAP.md``), so every window runs on the heap engine, which
the reference's prefetch only warms the store ahead of.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from itertools import islice
from typing import Sequence

from repro_torch.core.noc import SIM_CACHE, NocConfig
from repro_torch.core.noc.traffic import LayerResult, simulate_layer
from repro_torch.core.ops import LayerShape
from repro_torch.exec import parallel_map

from .schedule import LayerAssignment, NetworkSchedule
from .space import (Mapping, MapperConfig, PAPER_MAPPING, analytic_latency,
                    hardware_candidates, hardware_mapping_fields,
                    layer_candidates, shard_layer)


@dataclass
class SearchOutcome:
    """Everything one network search produced."""

    workload: str
    baseline: NetworkSchedule            # the paper's fixed mapping, simulated
    best: NetworkSchedule                # lowest-latency baseline-dominating
    pareto: tuple[NetworkSchedule, ...]  # latency/energy front over hardware
    stats: dict = field(default_factory=dict)

    @property
    def latency_x(self) -> float:
        return self.baseline.latency_cycles / max(self.best.latency_cycles, 1.0)

    @property
    def energy_x(self) -> float:
        return self.baseline.total_energy_pj \
            / max(self.best.total_energy_pj, 1.0)


# --------------------------------------------------------------------------- #
# Layer-result memo: a LayerResult is a pure function of the layer's Eq.(1)-(4)
# shape (R, C, F, outputs) and the mapping, never of the layer identity —
# ResNet-50 repeats the same bottleneck shapes dozens of times, and every
# hardware point re-scores the baseline anchor.  Keyed off
# ``SIM_CACHE.generation`` so ``SIM_CACHE.clear()`` invalidates it too.
# --------------------------------------------------------------------------- #
_EVAL_MEMO: dict = {"gen": -1, "store": {}}

#: Ranked keep-list memo, same lifecycle: the candidate enumeration +
#: analytic ranking of one (layer shape, hardware, space) cell is pure and
#: repeats across identically-shaped layers and warm re-searches.
_RANK_MEMO: dict = {"gen": -1, "store": {}}


def _memo_store(memo: dict) -> dict:
    if memo["gen"] != SIM_CACHE.generation:
        memo["gen"] = SIM_CACHE.generation
        memo["store"] = {}
    return memo["store"]


def _eval_store() -> dict:
    return _memo_store(_EVAL_MEMO)


def _rank_store() -> dict:
    return _memo_store(_RANK_MEMO)


def memo_sizes() -> tuple[int, int]:
    """(eval, rank) memo lengths — pair with :func:`memo_export`."""
    return len(_eval_store()), len(_rank_store())


def memo_export(sizes: tuple[int, int]) -> tuple[dict, dict]:
    """Entries appended since ``sizes`` (insertion-ordered tails).

    Lets a pool worker ship the layer/ranking memo growth of a whole
    search back to the parent (:func:`repro_torch.experiments.sweeps.
    run_mapper` fans out at workload grain), mirroring what
    ``_score_hardware``'s delta does per hardware point.
    """
    ev, rk = _eval_store(), _rank_store()
    return ({k: ev[k] for k in islice(iter(ev), sizes[0], None)},
            {k: rk[k] for k in islice(iter(rk), sizes[1], None)})


def memo_merge(deltas: tuple[dict, dict]) -> None:
    """Merge :func:`memo_export` deltas (pure values; order-free)."""
    ev, rk = deltas
    _eval_store().update(ev)
    _rank_store().update(rk)


def _eval_key(layer: LayerShape, mapping: Mapping, base_cfg: NocConfig,
              sim_rounds: int) -> tuple:
    return ((layer.R, layer.C, layer.F, layer.outputs), mapping, base_cfg,
            sim_rounds)


def _evaluate_multichip(layer: LayerShape, mapping: Mapping,
                        base_cfg: NocConfig, sim_rounds: int,
                        package: str) -> LayerResult:
    """Multi-chip cost: the per-chip shard's simulation plus a package
    broadcast surcharge.

    Every chip runs the identical shard concurrently (latency is one
    chip's; NoC and stream energy multiply by the chip count), and each
    weight fill first broadcasts the mesh's fill payload over the package
    network (:func:`~repro_torch.core.noc.hierarchy.chip_round_cost`,
    riding the same sim store).
    """
    from repro_torch.core.noc.hierarchy import chip_round_cost
    from repro_torch.core.noc.traffic import layer_plan
    flat = dataclasses.replace(mapping, chips=1)
    shard = shard_layer(layer, mapping.chips)
    r = evaluate_mapping(shard, flat, base_cfg, sim_rounds)
    cfg = mapping.cfg(base_cfg)
    plan = layer_plan(shard, cfg, mapping.e_pes, mapping.mode,
                      mapping.q_bits, mapping.groups)
    fill_bits = plan.weight_bits_per_router * cfg.width * cfg.height
    pkg_lat, pkg_en = chip_round_cost(fill_bits, mapping.chips, cfg,
                                      package=package,
                                      semantics=mapping.semantics)
    c = mapping.chips
    return dataclasses.replace(
        r, name=layer.name,
        latency_cycles=r.latency_cycles + pkg_lat * r.fills,
        noc_energy_pj=r.noc_energy_pj * c + pkg_en * r.fills,
        stream_energy_pj=r.stream_energy_pj * c)


def _evaluate_cached(layer: LayerShape, mapping: Mapping,
                     base_cfg: NocConfig, sim_rounds: int,
                     package: str) -> LayerResult:
    """Memo-backed cost, possibly named after an identically-shaped twin.

    Internal fast path: callers that never read ``result.name``
    (``_score_hardware``'s choose/assign loop) skip the per-call re-stamp
    copy.  The returned object is shared with the memo — do not mutate.
    """
    if mapping.chips > 1:
        return _evaluate_multichip(layer, mapping, base_cfg, sim_rounds,
                                   package)
    store = _eval_store()
    key = _eval_key(layer, mapping, base_cfg, sim_rounds)
    hit = store.get(key)
    if hit is None:
        hit = simulate_layer(layer, mapping.mode, mapping.cfg(base_cfg),
                             mapping.e_pes, sim_rounds,
                             q_bits=mapping.q_bits, groups=mapping.groups)
        store[key] = hit
    return hit


def evaluate_mapping(layer: LayerShape, mapping: Mapping,
                     base_cfg: NocConfig = NocConfig(),
                     sim_rounds: int = 16,
                     package: str = "mesh") -> LayerResult:
    """Exact (event-driven, cache-backed) cost of one mapping."""
    hit = _evaluate_cached(layer, mapping, base_cfg, sim_rounds, package)
    if hit.name == layer.name:
        return hit
    # Hand out a copy re-stamped with the caller's layer identity: the memo
    # collapses identically-shaped layers, but results name their layer.
    return dataclasses.replace(hit, name=layer.name)


def _choose(results: list[tuple[Mapping, LayerResult]],
            energy_budget: float) -> tuple[Mapping, LayerResult]:
    """Min latency subject to the baseline energy budget; energy breaks ties.

    Falls back to the unconstrained (latency, energy) minimum when nothing
    on this hardware meets the budget (a rectangular mesh can be faster but
    hotter — it then competes only through the Pareto front).
    """
    within = [(m, r) for m, r in results
              if r.total_energy_pj <= energy_budget]
    pool = within or results
    return min(pool, key=lambda mr: (mr[1].latency_cycles,
                                     mr[1].total_energy_pj,
                                     mr[0].sort_key))


def _pareto(schedules: list[NetworkSchedule]) -> list[NetworkSchedule]:
    """Non-dominated schedules over (latency, total energy), sorted."""
    ordered = sorted(schedules, key=lambda s: (s.latency_cycles,
                                               s.total_energy_pj, s.hardware))
    front: list[NetworkSchedule] = []
    best_energy = float("inf")
    for s in ordered:
        if s.total_energy_pj < best_energy:
            front.append(s)
            best_energy = s.total_energy_pj
    return front


def _score_hardware(payload) -> tuple[NetworkSchedule, int, int, dict]:
    """Score every layer on one hardware point (a pool-fanout unit).

    Returns ``(schedule, candidates, simulated, layer-memo delta)``; the
    delta ships memoized LayerResults back to the parent process so a
    warm parent keeps getting warmer across ``--jobs`` fan-outs.
    """
    workload, layers, base_results, hw, mcfg, base_cfg = payload
    memo_before = len(_eval_store())
    w, h, e, chips = hardware_mapping_fields(hw)
    # The hardware's own paper-style mapping is always scored exactly,
    # whatever the analytic ranking says — it anchors the energy-budget
    # pool (and *is* the baseline mapping on the baseline hardware).
    anchor = Mapping(w, h, e, "ws", "ina", mcfg.q_list[0], None, chips)
    n_cands = n_sim = 0
    rank_before = len(_rank_store())
    per_layer = []
    for layer, base_r in zip(layers, base_results):
        # Candidates and their analytic ranking are pure functions of the
        # layer's Eq.(1)-(4) shape (same determinants as the sim memo
        # above), so identically-shaped layers share one ranked keep list.
        rkey = ((layer.R, layer.C, layer.F, layer.outputs), hw, mcfg,
                base_cfg)
        hit = _rank_store().get(rkey)
        if hit is None:
            cands = layer_candidates(layer, hw, mcfg)
            ranked = sorted(cands, key=lambda m: (
                analytic_latency(layer, m, base_cfg), m.sort_key))
            keep = ranked[:mcfg.prune_keep]
            if anchor in cands and anchor not in keep:
                keep.append(anchor)
            hit = (tuple(keep), len(cands))
            _rank_store()[rkey] = hit
        n_cands += hit[1]
        per_layer.append((layer, base_r, hit[0]))
    assignments = []
    for layer, base_r, keep in per_layer:
        results = [(m, _evaluate_cached(layer, m, base_cfg,
                                        mcfg.sim_rounds, mcfg.package))
                   for m in keep]
        n_sim += len(results)
        m, r = _choose(results, base_r.total_energy_pj)
        assignments.append(
            LayerAssignment.from_result(layer, m, r, base_cfg))
    schedule = NetworkSchedule(workload=workload, hardware=hw,
                               assignments=tuple(assignments))
    # New memo entries = everything appended past the starting length
    # (insertion-ordered dicts, never deleted from within a generation).
    store = _eval_store()
    delta = {k: store[k]
             for k in islice(iter(store), memo_before, None)}
    rstore = _rank_store()
    rank_delta = {k: rstore[k]
                  for k in islice(iter(rstore), rank_before, None)}
    return schedule, n_cands, n_sim, delta, rank_delta


def search_network(workload: str, layers: Sequence[LayerShape],
                   mcfg: MapperConfig = MapperConfig(),
                   base_cfg: NocConfig = NocConfig(),
                   baseline_mapping: Mapping = PAPER_MAPPING,
                   jobs: int = 1, debug: bool = False) -> SearchOutcome:
    """Search the mapping space for a whole network; emit the best schedule.

    Deterministic: same (layers, mcfg, base_cfg) -> identical outcome,
    whatever ``jobs`` is — hardware points are scored across a process
    pool (:mod:`repro_torch.exec.pool`) and merged back in candidate order, and
    every scored cost is a pure function of the plan shape.

    ``debug=True`` statically verifies the winning schedule's re-emitted
    packet programs (:func:`repro_torch.analysis.verify.verify_schedule`:
    routes, DAG, CDG deadlock freedom) and raises ``VerificationError`` on
    any finding before the outcome escapes.
    """
    cache_before = SIM_CACHE.stats()
    stats = {"candidates": 0, "simulated": 0, "hardware_evaluated": 0}

    base_results = [evaluate_mapping(l, baseline_mapping, base_cfg,
                                     mcfg.sim_rounds, mcfg.package)
                    for l in layers]
    stats["simulated"] += len(base_results)
    baseline = NetworkSchedule(
        workload=workload, hardware=baseline_mapping.hardware,
        assignments=tuple(
            LayerAssignment.from_result(l, baseline_mapping, r, base_cfg)
            for l, r in zip(layers, base_results)))

    hws = hardware_candidates(mcfg)
    layers = tuple(layers)
    scored = parallel_map(
        _score_hardware,
        [(workload, layers, base_results, hw, mcfg, base_cfg) for hw in hws],
        jobs=jobs)
    schedules: list[NetworkSchedule] = []
    for schedule, n_cands, n_sim, delta, rank_delta in scored:
        stats["hardware_evaluated"] += 1
        stats["candidates"] += n_cands
        stats["simulated"] += n_sim
        _eval_store().update(delta)
        _rank_store().update(rank_delta)
        schedules.append(schedule)

    dominating = [s for s in schedules
                  if s.latency_cycles <= baseline.latency_cycles
                  and s.total_energy_pj <= baseline.total_energy_pj]
    # The baseline hardware always yields a dominating schedule when it is
    # inside the budget (its energy pool contains the baseline mapping);
    # outside the budget the baseline itself is the conservative answer.
    best = min(dominating, key=lambda s: (s.latency_cycles,
                                          s.total_energy_pj, s.hardware)) \
        if dominating else baseline

    cache_after = SIM_CACHE.stats()
    stats["sim_misses"] = cache_after["misses"] - cache_before["misses"]
    stats["sim_hits"] = cache_after["hits"] - cache_before["hits"]
    if debug:
        from repro_torch.analysis.findings import VerificationError
        from repro_torch.analysis.verify import verify_schedule
        findings = verify_schedule(best, layers, base_cfg)
        if findings:
            raise VerificationError(findings)
    return SearchOutcome(workload=workload, baseline=baseline, best=best,
                         pareto=tuple(_pareto(schedules + [baseline])),
                         stats=stats)
