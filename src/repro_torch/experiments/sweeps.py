"""The paper's full evaluation as one cached, resumable sweep subsystem (a
copy of ``repro.experiments.sweeps``).

Every figure/table of the source paper is a function from a
:class:`SweepConfig` to a JSON-ready dict:

* :func:`run_tables`      — Tables I & II (P#, INA# per CONV layer, N=8/16)
* :func:`run_fig7_9`      — Figs 7-9: WS+INA vs WS-without-INA, E sweep
* :func:`run_fig10_12`    — Figs 10-12: WS+INA vs OS-with-gather, E sweep
* :func:`run_mesh_scaling`— beyond the paper: mesh-size N x E scaling

All simulation goes through
:func:`repro_torch.core.noc.traffic.simulate_network` and therefore through
the plan-keyed window cache (:mod:`repro_torch.core.noc.simcache`): a
whole-network sweep replays each distinct window program once, on the heap
engine (the port's one executor), so ResNet-50's ~53 layers cost a handful
of event-driven runs.  :func:`run_all` writes per-figure JSON + a markdown
summary into ``results/`` (see EXPERIMENTS.md).

The ``*_csv_lines`` helpers emit the legacy ``name,us_per_call,derived``
benchmark rows.  The reference's ``faults`` section (and its
``SweepConfig`` fields) waits for the port's fault layer (``ROADMAP.md``).
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.ina_model import ina_table
from repro_torch.core.noc import NocConfig, SIM_CACHE
from repro_torch.core.noc.power import (Improvement, ws_ina_improvement,
                                        ws_vs_os_improvement)
from repro_torch.core.workloads import ALEXNET, VGG16, WORKLOADS
from repro_torch.exec import parallel_map

#: Paper-reported headline numbers, attached to every emitted figure.
PAPER_REFERENCE = {
    "tables": "Tables I & II: P#/INA# per CONV layer (M=32Kbit, q=32)",
    "fig7_9": "paper: up to 1.22x latency / 2.16x power, WS+INA vs WS",
    "fig10_12": "paper: up to 1.19x latency / 2.16x power, WS+INA vs OS",
    "mesh_scaling": "beyond the paper: N x E scaling of the WS+INA gain",
    "hierarchy": "beyond the paper: mesh-of-meshes — the INA advantage vs "
                 "chip count and package-link bandwidth (DESIGN.md S14)",
    "mapper": "beyond the paper: searched mappings vs the fixed "
              "Eq. (1)-(4) placement (DESIGN.md S9)",
    "plan": "beyond the paper: whole-model ExecutionPlans — NoC-costed "
            "psum strategy, mapper verdict, pallas tiles per "
            "(config, mesh, phase, dtype) (DESIGN.md S11)",
    "serve": "beyond the paper: request-level serving capacity — the INA "
             "advantage as meshes-per-SLO (DESIGN.md S12)",
}

SECTIONS = ("tables", "fig7_9", "fig10_12", "mesh_scaling", "hierarchy",
            "mapper", "plan", "serve")


@dataclass(frozen=True)
class SweepConfig:
    """Shape of one full-evaluation sweep (defaults match the paper)."""

    e_list: tuple[int, ...] = (1, 2, 4, 8)      # PEs per router (Eq. 4)
    n_list: tuple[int, ...] = (4, 8, 16)        # mesh sizes (scaling study)
    table_n_list: tuple[int, ...] = (8, 16)     # Tables I/II mesh sizes
    sim_rounds: int = 16                        # simulated window length
    workloads: tuple[str, ...] = ("alexnet", "vgg16", "resnet50")
    jobs: int = 1                               # process-pool width (--jobs)
    # ---- hierarchy section (DESIGN.md S14) -------------------------------
    #: (chip-mesh N, allreduce payload bits) points — large configs where
    #: the package level actually carries weight.
    hier_configs: tuple[tuple[int, int], ...] = (
        (8, 1 << 20), (16, 1 << 20), (16, 1 << 22))
    hier_chips: tuple[int, ...] = (1, 2, 4, 8)  # chips per package
    #: on-die/package link-width ratios (1 = same-width interposer wires,
    #: 4 = package links carry a quarter flit per beat) — the bandwidth
    #: axis; per-hop latency stays at the 4-cycle interposer default.
    hier_pkg_widths: tuple[int, ...] = (1, 2, 4)
    hier_packages: tuple[str, ...] = ("mesh", "express")
    # ---- mapper section (DESIGN.md S9) -----------------------------------
    mapper_space: str = "full"                  # "full" | "quick" MapperConfig
    mapper_transformers: tuple[str, ...] = ("llama3-8b", "qwen2-1.5b")
    mapper_tokens: int = 256                    # GEMM M tile per pass
    mapper_pe_budget: Optional[int] = None      # per-chip PE ceiling override
    mapper_chips: tuple[int, ...] = (1,)        # package axis (--chips)
    # ---- plan section (DESIGN.md S11) ------------------------------------
    plan_phases: tuple[str, ...] = ("train", "prefill", "decode")
    plan_mesh: tuple[tuple[str, int], ...] = (("data", 16), ("model", 16))
    plan_dir: Optional[str] = None              # None -> results/.plans_torch
    # ---- serve section (DESIGN.md S12) -----------------------------------
    serve_archs: tuple[str, ...] = ("qwen2-1.5b", "llama3-8b",
                                    "deepseek-v2-lite-16b")
    serve_qps: tuple[float, ...] = (0.05, 0.1, 0.2)
    serve_fleets: tuple[int, ...] = (1, 2, 4, 8, 16)
    serve_requests: int = 200
    serve_seed: int = 0
    # The fleet answer is on p99 admission-queueing delay: the modeled
    # 1 GHz mesh is prefill-bound, so absolute TTFT/e2e floors differ per
    # collective semantics at *any* fleet size — queueing is the metric
    # fleet size actually buys down, and both semantics can meet it.
    serve_slo_metric: str = "queueing_s"
    serve_slo_ms: float = 30_000.0              # 30 s modeled queueing p99
    serve_slots: int = 8
    serve_max_seq: int = 1024
    serve_block: int = 16
    serve_chunk: int = 64                       # prefill chunk (tokens)
    serve_prompt_dist: str = "lognormal:128:0.5:512"
    serve_gen_dist: str = "uniform:32:128"
    def cfg(self, n: Optional[int] = None) -> NocConfig:
        return NocConfig() if n is None else NocConfig(n=n)


DEFAULT_SWEEP = SweepConfig()
#: CI smoke shape: small windows, two E points, no N=16 mesh.
QUICK_SWEEP = SweepConfig(e_list=(1, 4), n_list=(4, 8), sim_rounds=4,
                          workloads=("alexnet", "vgg16", "resnet50"),
                          hier_configs=((4, 1 << 14),), hier_chips=(1, 2),
                          hier_pkg_widths=(4,),
                          mapper_space="quick", plan_phases=("decode",),
                          serve_archs=("qwen2-1.5b",), serve_qps=(0.1,),
                          serve_fleets=(1, 2), serve_requests=60)


def _imp_row(imp: Improvement, **extra) -> dict:
    row = {"workload": imp.workload, "e_pes": imp.e_pes,
           "latency_x": imp.latency_x, "power_x": imp.power_x,
           "energy_x": imp.energy_x}
    row.update(extra)
    return row


# --------------------------------------------------------------------------- #
# Sections
# --------------------------------------------------------------------------- #
def run_tables(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Tables I & II: analytical P#/INA# rows per CONV layer and mesh size."""
    rows = []
    for name, layers in (("alexnet", ALEXNET), ("vgg16", VGG16)):
        for n in sweep.table_n_list:
            for r in ina_table(layers, n=n):
                rows.append({"network": name, "n": n, **r})
    return {"figure": "tables", "paper_reference": PAPER_REFERENCE["tables"],
            "rows": rows}


def _improvement_task(payload) -> dict:
    """One (workload, E, N) improvement row — the pool-fanout unit of the
    fig sweeps.  Top-level so :func:`repro_torch.exec.parallel_map` can
    pickle it.
    """
    improve, name, e, cfg, sim_rounds, extra = payload
    t0 = time.time()
    imp = improve(name, WORKLOADS[name], e, cfg, sim_rounds)
    return _imp_row(imp, elapsed_us=(time.time() - t0) * 1e6, **extra)


def _run_fig(figure: str, sweep: SweepConfig,
             improve: Callable[..., Improvement]) -> dict:
    rows = parallel_map(
        _improvement_task,
        [(improve, name, e, sweep.cfg(), sweep.sim_rounds, {})
         for name in sweep.workloads for e in sweep.e_list],
        jobs=sweep.jobs)
    avg = {k: sum(r[k] for r in rows) / len(rows)
           for k in ("latency_x", "power_x", "energy_x")}
    return {"figure": figure, "paper_reference": PAPER_REFERENCE[figure],
            "sim_rounds": sweep.sim_rounds, "rows": rows, "average": avg}


def run_fig7_9(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Figs 7-9: WS+INA improvement over WS-without-INA across workloads/E."""
    return _run_fig("fig7_9", sweep, ws_ina_improvement)


def run_fig10_12(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Figs 10-12: WS+INA improvement over OS-with-gather across workloads/E."""
    return _run_fig("fig10_12", sweep, ws_vs_os_improvement)


def run_mesh_scaling(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """N x E scaling of the WS+INA gain (the paper only reports N=8)."""
    rows = parallel_map(
        _improvement_task,
        [(ws_ina_improvement, name, e, sweep.cfg(n), sweep.sim_rounds,
          {"n": n})
         for n in sweep.n_list for name in sweep.workloads
         for e in sweep.e_list],
        jobs=sweep.jobs)
    return {"figure": "mesh_scaling",
            "paper_reference": PAPER_REFERENCE["mesh_scaling"],
            "sim_rounds": sweep.sim_rounds, "rows": rows}


def run_hierarchy(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Hierarchy section: the INA advantage on a mesh-of-meshes
    (DESIGN.md S14).

    For every ``(chip-mesh N, payload)`` point in ``sweep.hier_configs``,
    prices a whole-package allreduce over ``sweep.hier_chips`` chips,
    both package fabrics, and ``sweep.hier_pkg_widths`` package-link
    width ratios (the bandwidth axis: a ratio of 4 means cross-chip
    links carry a quarter of the on-die flit per beat) — under both
    collective semantics through
    :func:`~repro_torch.core.noc.hierarchy.hier_collective_cost` (the same
    SIM_CACHE-riding facade the plan builder and mapper use).
    ``latency_x``/``energy_x`` are eject/inject over INA, so the rows read
    as *how much of the paper's advantage survives the package level* as
    chips multiply and the cross-chip links narrow.
    """
    import dataclasses as _dc

    from repro_torch.core.noc.hierarchy import (hier_collective_cost,
                                                square_hier_mesh)

    rows = []
    for n, payload_bits in sweep.hier_configs:
        cfg = sweep.cfg(n)
        for chips in sweep.hier_chips:
            # chips == 1 is the flat paper mesh: no package level exists,
            # so the fabric/width axes would emit duplicate rows.
            variants = [("flat", 1)] if chips == 1 else \
                [(pkg, wr) for pkg in sweep.hier_packages
                 for wr in sweep.hier_pkg_widths]
            for package, width_ratio in variants:
                t0 = time.time()
                hmesh = square_hier_mesh(
                    chips, n, n,
                    package=package if chips > 1 else "mesh")
                hmesh = _dc.replace(
                    hmesh,
                    pkg_flit_bits=max(1, cfg.flit_bits // width_ratio))
                costs = {sem: hier_collective_cost(
                            "allreduce", hmesh, float(payload_bits), cfg,
                            semantics=sem)
                         for sem in ("ina", "eject_inject")}
                ina, ej = costs["ina"], costs["eject_inject"]
                rows.append({
                    "n": n, "payload_bits": payload_bits, "chips": chips,
                    "package": package, "pkg_width_ratio": width_ratio,
                    "pes": ina.participants,
                    "ina_latency_cycles": ina.latency_cycles,
                    "ej_latency_cycles": ej.latency_cycles,
                    "latency_x": ej.latency_cycles / ina.latency_cycles,
                    "ina_energy_pj": ina.energy_pj,
                    "ej_energy_pj": ej.energy_pj,
                    "energy_x": ej.energy_pj / ina.energy_pj,
                    "ina_level_latency": [list(l) for l
                                          in ina.level_latency],
                    "elapsed_us": (time.time() - t0) * 1e6,
                })
    # Headline per package fabric: the INA advantage at the largest swept
    # chip count and narrowest link (the "does it survive scale-out"
    # answer).
    headline = {}
    for package in ("flat",) + tuple(sweep.hier_packages):
        sub = [r for r in rows if r["package"] == package]
        if sub:
            worst = max(sub, key=lambda r: (r["chips"],
                                            r["pkg_width_ratio"], r["n"]))
            headline[package] = {k: worst[k] for k in
                                 ("n", "chips", "pkg_width_ratio",
                                  "latency_x", "energy_x")}
    return {"figure": "hierarchy",
            "paper_reference": PAPER_REFERENCE["hierarchy"],
            "rows": rows, "headline": headline}


def _search_one_workload(payload):
    """Pool-fanout unit for :func:`run_mapper`: one workload's search.

    Inside a worker the nested hardware-point fan-out serializes
    (``repro_torch.exec.pool`` guards against nested pools), so each worker
    runs its search alone and ships the outcome + wall time + memo growth
    back; in the serial fallback the inner fan-out still applies.
    """
    name, layers, mcfg, jobs = payload
    from repro_torch.mapper import search_network
    from repro_torch.mapper.search import memo_export, memo_sizes

    sizes = memo_sizes()
    t0 = time.time()
    out = search_network(name, layers, mcfg, jobs=jobs)
    return out, (time.time() - t0) * 1e6, memo_export(sizes)


def run_mapper(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Mapper section: paper-fixed vs auto-searched mapping, per workload.

    For every CNN in ``sweep.workloads`` (FC layers included) and every
    transformer config in ``sweep.mapper_transformers`` (one decoder block's
    GEMMs), runs :func:`repro_torch.mapper.search_network` and reports the
    improvement of the searched :class:`~repro_torch.mapper.NetworkSchedule` over
    the paper's fixed 8x8 WS+INA placement, plus the hardware-level
    latency/energy Pareto front.  Selection is baseline-dominating, so
    ``latency_x >= 1`` and ``energy_x >= 1`` by construction (equality when
    the paper mapping is already optimal).

    ``sweep.jobs > 1`` fans out at workload grain (one pool for the whole
    section), as the reference does.  Results are bit-identical whatever
    the grain (every score is a pure function of the plan shape).
    """
    import dataclasses as _dc

    from repro_torch.core.workloads import mapper_workloads
    from repro_torch.mapper import MapperConfig, QUICK_MAPPER

    base = QUICK_MAPPER if sweep.mapper_space == "quick" else MapperConfig()
    space_overrides = {"sim_rounds": sweep.sim_rounds,
                       "chips_list": sweep.mapper_chips}
    if sweep.mapper_pe_budget is not None:
        space_overrides["pe_budget"] = sweep.mapper_pe_budget
    mcfg = _dc.replace(base, **space_overrides)
    workloads = mapper_workloads(conv=sweep.workloads,
                                 transformers=sweep.mapper_transformers,
                                 tokens=sweep.mapper_tokens)
    outs = parallel_map(
        _search_one_workload,
        [(name, layers, mcfg, sweep.jobs)
         for name, layers in workloads.items()],
        jobs=sweep.jobs)
    from repro_torch.mapper.search import memo_merge

    rows, pareto, schedules = [], {}, {}
    for (name, layers), (out, elapsed_us, memos) in zip(workloads.items(),
                                                        outs):
        memo_merge(memos)
        rows.append({
            "workload": name,
            "layers": len(layers),
            "hardware": "x".join(map(str, out.best.hardware)),
            "latency_x": out.latency_x,
            "energy_x": out.energy_x,
            "paper_latency_cycles": out.baseline.latency_cycles,
            "auto_latency_cycles": out.best.latency_cycles,
            "paper_energy_pj": out.baseline.total_energy_pj,
            "auto_energy_pj": out.best.total_energy_pj,
            "paper_utilization": out.baseline.pe_utilization,
            "auto_utilization": out.best.pe_utilization,
            "search": out.stats,
            "elapsed_us": elapsed_us,
        })
        pareto[name] = [{
            "hardware": "x".join(map(str, s.hardware)),
            "latency_cycles": s.latency_cycles,
            "total_energy_pj": s.total_energy_pj,
            "pe_utilization": s.pe_utilization,
        } for s in out.pareto]
        schedules[name] = out.best.to_dict()
    return {"figure": "mapper", "paper_reference": PAPER_REFERENCE["mapper"],
            "sim_rounds": sweep.sim_rounds, "space": sweep.mapper_space,
            "pe_budget": mcfg.pe_budget, "chips_list": list(mcfg.chips_list),
            "rows": rows, "pareto": pareto, "best_schedules": schedules}


def run_plan(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Plan section: one ExecutionPlan per (config, phase) on the
    production mesh shape (DESIGN.md S11).

    Plans are produced through the persistent :class:`repro_torch.plan.PlanStore`
    (``sweep.plan_dir``, default ``results/.plans_torch``): a warm store answers
    with **zero collective engine runs** — the per-row
    ``collective_engine_runs`` delta is the evidence, and any failure
    becomes an attributable ``plan_error`` row (CI fails on those).  The
    returned dict embeds every plan verbatim, so ``plan.json`` is a
    self-contained, diffable artifact.

    A build is bound by the ``meta``-device trace of the model's step that
    finds its psum sites (no simulation: plans ride the warm sim cache), so
    this section does not fan out over ``sweep.jobs`` (a process forked
    after torch has started its thread pools is not safe to trace in).
    """
    from repro_torch.configs import ARCHS
    from repro_torch.core.noc.collective.cost import COST_STATS
    from repro_torch.plan import PlanStore

    store = PlanStore(sweep.plan_dir)
    rows, plans = [], {}
    for arch, cfg in ARCHS.items():
        for phase in sweep.plan_phases:
            t0 = time.time()
            runs0 = COST_STATS["engine_runs"]
            try:
                plan, built = store.get_or_build(
                    cfg, sweep.plan_mesh, phase,
                    mapper_space=sweep.mapper_space)
            except Exception as e:               # noqa: BLE001
                rows.append({"workload": arch, "phase": phase,
                             "plan_error": f"{type(e).__name__}: {e}",
                             "elapsed_us": (time.time() - t0) * 1e6})
                continue
            s = plan.psum_summary()
            base_lat = sum(g.baseline_latency_cycles for g in plan.gemms)
            best_lat = sum(g.latency_cycles for g in plan.gemms)
            base_en = sum(g.baseline_energy_pj for g in plan.gemms)
            best_en = sum(g.energy_pj for g in plan.gemms)
            rows.append({
                "workload": arch, "phase": phase, "key": plan.key,
                "warm": not built,
                "sites": s["sites"], "distinct_sites": s["distinct"],
                "modes": s["modes"],
                "psum_latency_x": s["latency_delta_x"],
                "psum_energy_x": s["energy_delta_x"],
                "mapper_latency_x": base_lat / best_lat if best_lat else 1.0,
                "mapper_energy_x": base_en / best_en if best_en else 1.0,
                "mapper_hardware": "x".join(map(str, plan.mapper_hardware))
                if plan.mapper_hardware else "NA",
                "tiles": len(plan.tiles),
                "collective_engine_runs":
                    COST_STATS["engine_runs"] - runs0,
                "elapsed_us": (time.time() - t0) * 1e6,
            })
            plans[plan.key] = plan.to_dict()
    return {"figure": "plan", "paper_reference": PAPER_REFERENCE["plan"],
            "phases": list(sweep.plan_phases),
            "mesh": [list(p) for p in sweep.plan_mesh],
            "store": str(store.dir), "rows": rows, "plans": plans}


def run_serve(sweep: SweepConfig = DEFAULT_SWEEP) -> dict:
    """Serve section: qps x fleet x collective-semantics capacity sweep
    (DESIGN.md S12).

    For each arch in ``sweep.serve_archs``, builds the per-phase serving
    plans once (warm :class:`~repro_torch.plan.PlanStore`), then prices the same
    plan under both collective semantics — ``ina`` (in-network
    accumulation) and ``eject_inject`` (the software baseline) — and runs
    the request-level cluster simulator over every (qps, fleet) point.
    The headline per (arch, qps, semantics) is the smallest fleet meeting
    the ``sweep.serve_slo_metric`` p99 SLO (default: admission-queueing
    delay — the latency component fleet size actually buys down on the
    prefill-bound modeled mesh), so the INA advantage reads directly as
    *fewer meshes per SLO*.  Failures become attributable ``serve_error``
    rows (CI fails on those); everything is seeded, so rows are
    deterministic.
    """
    from repro_torch.configs import ARCHS
    from repro_torch.serve.cluster import ClusterSimulator
    from repro_torch.serve.costs import PlanCostModel, SEMANTICS, serve_plans
    from repro_torch.serve.traffic import make_workload

    slo_s = sweep.serve_slo_ms / 1e3
    rows, answers = [], []
    for arch in sweep.serve_archs:
        cfg = ARCHS[arch]
        t0 = time.time()
        try:
            plans = serve_plans(cfg, sweep.plan_mesh,
                                plan_dir=sweep.plan_dir, verbose=False)
        except Exception as e:                   # noqa: BLE001
            rows.append({"workload": arch,
                         "serve_error": f"{type(e).__name__}: {e}",
                         "elapsed_us": (time.time() - t0) * 1e6})
            continue
        plan_sims = sum(info["collective_sims"]
                        for _, info in plans.values())
        for sem in SEMANTICS:
            cost = PlanCostModel.from_plans(
                cfg, plans["prefill"][0], plans["decode"][0],
                prefill_chunk=sweep.serve_chunk, semantics=sem)
            for qps in sweep.serve_qps:
                reqs = make_workload(sweep.serve_requests, qps,
                                     sweep.serve_prompt_dist,
                                     sweep.serve_gen_dist, sweep.serve_seed)
                fleet_needed = None
                for fleet in sweep.serve_fleets:
                    t1 = time.time()
                    try:
                        m = ClusterSimulator(
                            fleet, slots=sweep.serve_slots,
                            block_size=sweep.serve_block,
                            max_seq=sweep.serve_max_seq,
                            prefill_chunk=sweep.serve_chunk,
                            cost=cost).run(reqs)
                    except Exception as e:       # noqa: BLE001
                        rows.append({
                            "workload": arch, "semantics": sem, "qps": qps,
                            "fleet": fleet,
                            "serve_error": f"{type(e).__name__}: {e}",
                            "elapsed_us": (time.time() - t1) * 1e6})
                        continue
                    p99 = m[sweep.serve_slo_metric]["p99"]
                    met = p99 <= slo_s
                    if met and fleet_needed is None:
                        fleet_needed = fleet
                    rows.append({
                        "workload": arch, "semantics": sem, "qps": qps,
                        "fleet": fleet,
                        "p99_slo_ms": p99 * 1e3,
                        "p99_queueing_ms": m["queueing_s"]["p99"] * 1e3,
                        "p99_ttft_ms": m["ttft_s"]["p99"] * 1e3,
                        "p99_e2e_ms": m["e2e_s"]["p99"] * 1e3,
                        "throughput_rps": m["throughput_rps"],
                        "throughput_tok_s": m["throughput_tok_s"],
                        "littles_law_ratio": m["littles_law_ratio"],
                        "slo_met": met,
                        "plan_sims": plan_sims,
                        "elapsed_us": (time.time() - t1) * 1e6,
                    })
                answers.append({"workload": arch, "semantics": sem,
                                "qps": qps, "fleet_needed": fleet_needed})
    return {"figure": "serve", "paper_reference": PAPER_REFERENCE["serve"],
            "slo_metric": sweep.serve_slo_metric,
            "slo_ms": sweep.serve_slo_ms,
            "mesh": [list(p) for p in sweep.plan_mesh],
            "requests": sweep.serve_requests, "seed": sweep.serve_seed,
            "rows": rows, "answers": answers}


_RUNNERS: dict[str, Callable[[SweepConfig], dict]] = {
    "tables": run_tables, "fig7_9": run_fig7_9,
    "fig10_12": run_fig10_12, "mesh_scaling": run_mesh_scaling,
    "hierarchy": run_hierarchy, "mapper": run_mapper, "plan": run_plan,
    "serve": run_serve,
}


# --------------------------------------------------------------------------- #
# Legacy benchmark CSV rows (``name,us_per_call,derived``)
# --------------------------------------------------------------------------- #
def _table_csv_row(r: dict) -> str:
    ina = r["INA#"] if r["INA#"] is not None else "NA"
    return (f"table_{r['network']}_N{r['n']},{r['layer']},"
            f"P#={r['P#']},INA#={ina}")


def tables_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return [_table_csv_row(r) for r in run_tables(sweep)["rows"]]


def _fig_section_csv(section: str, fig: dict) -> list[str]:
    """Legacy rows + tail line for one computed fig7_9/fig10_12 dict (the
    single emitter shared by the bench wrappers and ``run_all``)."""
    lines = [(f"{section}_{r['workload']}_E{r['e_pes']},"
              f"{r.get('elapsed_us', 0.0):.0f},"
              f"latency_x={r['latency_x']:.3f};"
              f"energy_x={r['energy_x']:.3f};"
              f"power_x={r['power_x']:.3f}") for r in fig["rows"]]
    if section == "fig7_9":
        avg = fig["average"]
        lines.append(f"fig7_9_average,0,latency_x={avg['latency_x']:.3f};"
                     f"energy_x={avg['energy_x']:.3f};"
                     f"paper=1.22x_latency_2.16x_power")
    else:
        lines.append("fig10_12_note,0,paper=up_to_1.19x_latency_2.16x_power")
    return lines


def fig7_9_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return _fig_section_csv("fig7_9", run_fig7_9(sweep))


def fig10_12_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return _fig_section_csv("fig10_12", run_fig10_12(sweep))


def _hierarchy_csv(fig: dict) -> list[str]:
    return [(f"hier_N{r['n']}_p{r['payload_bits']}_c{r['chips']}"
             f"_{r['package']}_w{r['pkg_width_ratio']},"
             f"{r.get('elapsed_us', 0.0):.0f},"
             f"latency_x={r['latency_x']:.3f};energy_x={r['energy_x']:.3f};"
             f"ina_cycles={r['ina_latency_cycles']}")
            for r in fig["rows"]]


def hierarchy_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return _hierarchy_csv(run_hierarchy(sweep))


def _mapper_csv(fig: dict) -> list[str]:
    return [(f"mapper_{r['workload']},{r.get('elapsed_us', 0.0):.0f},"
             f"latency_x={r['latency_x']:.3f};energy_x={r['energy_x']:.3f};"
             f"hw={r['hardware']}") for r in fig["rows"]]


def mapper_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return _mapper_csv(run_mapper(sweep))


def sanitize_error(msg, escape: str = ",") -> str:
    """One-line, metachar-free rendering of an exception message for CSV
    rows and markdown tables (shared with ``report._plan_table``)."""
    return " ".join(str(msg).split()).replace(escape, ";")[:160]


def _plan_csv(fig: dict) -> list[str]:
    """CSV rows for the plan section; failures keep the ``plan_error``
    prefix CI greps for."""
    lines = []
    for r in fig["rows"]:
        if "plan_error" in r:
            msg = sanitize_error(r["plan_error"], ",")
            lines.append(f"plan_error_{r['workload']}_{r['phase']},0,{msg}")
            continue
        modes = "+".join(f"{m}:{c}" for m, c in r["modes"].items())
        lines.append(
            f"plan_{r['workload']}_{r['phase']},{r['elapsed_us']:.0f},"
            f"sites={r['sites']};modes={modes};"
            f"psum_latency_x={r['psum_latency_x']:.3f};"
            f"mapper_latency_x={r['mapper_latency_x']:.3f};"
            f"warm={int(r['warm'])};sims={r['collective_engine_runs']}")
    return lines


def plan_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return _plan_csv(run_plan(sweep))


def _serve_csv(fig: dict) -> list[str]:
    """CSV rows for the serve section; failures keep the ``serve_error``
    prefix CI greps for, and per-(arch, qps, semantics) answer rows carry
    the fleet-sizing headline."""
    lines = []
    for r in fig["rows"]:
        if "serve_error" in r:
            msg = sanitize_error(r["serve_error"], ",")
            tag = "_".join(str(r[k]) for k in ("workload", "semantics",
                                               "qps", "fleet") if k in r)
            lines.append(f"serve_error_{tag},0,{msg}")
            continue
        lines.append(
            f"serve_{r['workload']}_{r['semantics']}"
            f"_q{r['qps']:g}_f{r['fleet']},{r['elapsed_us']:.0f},"
            f"p99_queueing_ms={r['p99_queueing_ms']:.3f};"
            f"p99_ttft_ms={r['p99_ttft_ms']:.3f};"
            f"tok_s={r['throughput_tok_s']:.1f};"
            f"slo_met={int(r['slo_met'])};sims={r['plan_sims']}")
    for a in fig["answers"]:
        fleet = a["fleet_needed"] if a["fleet_needed"] is not None else "NA"
        lines.append(
            f"serve_answer_{a['workload']}_{a['semantics']}_q{a['qps']:g},0,"
            f"fleet={fleet};slo_p99_{fig['slo_metric']}={fig['slo_ms']:g}ms")
    return lines


def serve_csv_lines(sweep: SweepConfig = DEFAULT_SWEEP) -> list[str]:
    return _serve_csv(run_serve(sweep))


# --------------------------------------------------------------------------- #
# Full run: JSON per figure + markdown summary + benchmark CSV
# --------------------------------------------------------------------------- #
def run_all(sweep: SweepConfig = DEFAULT_SWEEP,
            out_dir: str | Path = "results",
            sections: tuple[str, ...] = SECTIONS,
            write_csv: bool = True) -> dict:
    """Run ``sections`` of the evaluation; write artifacts into ``out_dir``.

    Returns ``{section: figure_dict}`` plus ``_meta`` (timings + cache
    stats).  Artifacts: ``<section>.json`` per section, ``summary.md``,
    and (``write_csv``) ``benchmarks.csv`` with the legacy fig7-12 rows.
    """
    from .report import summary_markdown

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    results: dict = {}
    timings: dict[str, float] = {}
    cache_before = SIM_CACHE.stats()
    for section in sections:
        if section not in _RUNNERS:
            raise ValueError(f"unknown section {section!r}; "
                             f"pick from {SECTIONS}")
        t0 = time.time()
        fig = _RUNNERS[section](sweep)
        timings[section] = time.time() - t0
        results[section] = fig
        (out / f"{section}.json").write_text(json.dumps(fig, indent=2))
    # Report cache activity as deltas so the artifact describes *this* run
    # even when earlier work in the process warmed the process-wide cache.
    cache_after = SIM_CACHE.stats()
    delta = {k: cache_after[k] - cache_before[k]
             for k in ("hits", "misses", "disk_hits")}
    looked = delta["hits"] + delta["misses"]
    cache = {"entries": cache_after["entries"],
             "hit_rate": delta["hits"] / looked if looked else 0.0,
             "persist_dir": cache_after["persist_dir"], **delta}
    results["_meta"] = {"sweep": asdict(sweep), "elapsed_s": timings,
                        "cache": cache}
    (out / "summary.md").write_text(summary_markdown(results))
    if write_csv:
        # Derived from the rows computed above — nothing is re-simulated;
        # the timing column carries the per-section wall time instead of
        # per-call timings (the ``*_csv_lines`` helpers give those).
        csv = ["name,us_per_call,derived"]
        if "tables" in sections:
            csv += [_table_csv_row(r) for r in results["tables"]["rows"]]
        for section in ("fig7_9", "fig10_12"):
            if section in sections:
                csv += _fig_section_csv(section, results[section])
        if "hierarchy" in sections:
            csv += _hierarchy_csv(results["hierarchy"])
        if "mapper" in sections:
            csv += _mapper_csv(results["mapper"])
        if "plan" in sections:
            csv += _plan_csv(results["plan"])
        if "serve" in sections:
            csv += _serve_csv(results["serve"])
        (out / "benchmarks.csv").write_text("\n".join(csv) + "\n")
    return results
