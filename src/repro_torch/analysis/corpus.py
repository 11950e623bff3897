"""Artifact corpora the verifier and the executor tests sweep over (a copy
of ``repro.analysis.corpus``).

One place enumerates "every fig7-12 plan shape" and "all tree collectives
(both semantics x both allreduce algorithms)", clean and under seeded
faults, so ``chip_smoke.py``'s ``[noc]`` phase and the tests cannot drift
apart on what *all* means.
"""
from __future__ import annotations

from typing import Iterator, Optional

from repro_torch.core.noc.collective.schedule import (ALLREDUCE_ALGORITHMS,
                                                COLLECTIVE_OPS, SEMANTICS,
                                                plan_collective,
                                                ws_round_program)
from repro_torch.core.noc.router import NocConfig

#: PE-per-router sweep of the paper's figures.
FIG_E_LIST = (1, 2, 4, 8)
FIG_E_LIST_QUICK = (1, 4)
#: fig7-9 compares ws_ina vs ws_noina; fig10-12 ws_ina vs os_gather.
FIG_MODES = ("ws_ina", "ws_noina", "os_gather")
FIG_WORKLOADS = ("alexnet", "vgg16", "resnet50")


def collective_cases(mesh_n: int = 4) -> Iterator[dict]:
    """Every (op, semantics[, algorithm]) over three participant shapes:
    the full mesh, one row, and a scattered non-convex set."""
    full = [(x, y) for x in range(mesh_n) for y in range(mesh_n)]
    row = [(x, 0) for x in range(mesh_n)]
    scattered = [(0, 0), (mesh_n - 1, 1), (1, mesh_n - 1),
                 (mesh_n - 2, mesh_n - 2)]
    for label, parts in (("full", full), ("row", row),
                         ("scattered", scattered)):
        for op in COLLECTIVE_OPS:
            for semantics in SEMANTICS:
                algorithms = ALLREDUCE_ALGORITHMS \
                    if op == "allreduce" else ("reduce_bcast",)
                for algorithm in algorithms:
                    yield {"label": label, "op": op,
                           "participants": parts,
                           "semantics": semantics,
                           "algorithm": algorithm}


def collective_programs(cfg: Optional[NocConfig] = None,
                        payload_bits: float = 512.0) -> Iterator[tuple]:
    """``(case, cfg, program)`` for every :func:`collective_cases` entry."""
    cfg = NocConfig(n=4) if cfg is None else cfg
    for case in collective_cases(min(cfg.width, cfg.height)):
        prog = plan_collective(
            case["op"], case["participants"], payload_bits, cfg,
            algorithm=case["algorithm"], semantics=case["semantics"])
        yield case, cfg, prog


#: package grids the hierarchy corpus sweeps (quick keeps the smallest).
HIER_GRIDS = ((2, 1), (2, 2))
HIER_GRIDS_QUICK = ((2, 1),)
PACKAGE_VARIANTS = ("mesh", "express")


def hier_cases(quick: bool = False) -> Iterator[dict]:
    """Every hierarchical collective the verifier must hold: package grid
    x package variant x op x semantics x (allreduce algorithm)."""
    from repro_torch.core.noc.hierarchy import HIER_OPS
    grids = HIER_GRIDS_QUICK if quick else HIER_GRIDS
    for grid in grids:
        for package in PACKAGE_VARIANTS:
            for op in HIER_OPS:
                for semantics in SEMANTICS:
                    algorithms = ALLREDUCE_ALGORITHMS \
                        if op == "allreduce" else ("reduce_bcast",)
                    for algorithm in algorithms:
                        yield {"grid": grid, "package": package, "op": op,
                               "semantics": semantics,
                               "algorithm": algorithm}


def hier_schedules(quick: bool = False, cfg: Optional[NocConfig] = None,
                   payload_bits: float = 4096.0) -> Iterator[tuple]:
    """``(case, schedule)`` for every :func:`hier_cases` entry."""
    from repro_torch.core.noc.hierarchy import (HierarchicalMesh,
                                          plan_hier_collective)
    cfg = NocConfig(n=4) if cfg is None else cfg
    for case in hier_cases(quick):
        hmesh = HierarchicalMesh(chips_x=case["grid"][0],
                                 chips_y=case["grid"][1],
                                 package=case["package"])
        sched = plan_hier_collective(
            case["op"], hmesh, payload_bits, cfg,
            algorithm=case["algorithm"], semantics=case["semantics"])
        yield case, sched


#: Seeded fault densities the faulted corpus sweeps.
#: Rates are per-link / per-router / per-PE Bernoulli draws from one
#: ``random.Random(seed)`` stream — the corpus is a pure function of
#: these literals.
FAULT_SPECS = (
    {"label": "light", "link_rate": 0.04, "router_rate": 0.0,
     "pe_rate": 0.0, "seed": 3},
    {"label": "medium", "link_rate": 0.08, "router_rate": 0.02,
     "pe_rate": 0.05, "seed": 11},
    {"label": "heavy", "link_rate": 0.15, "router_rate": 0.05,
     "pe_rate": 0.08, "seed": 23},
)
#: Faulted programs plan on a 6x6 chip so detours have room to exist.
FAULT_MESH_N = 6


def fault_models(quick: bool = False) -> Iterator[tuple]:
    """``(spec, FaultModel)`` for every :data:`FAULT_SPECS` density
    (quick keeps the lightest)."""
    from repro_torch.core.noc.faults import seeded_faults
    for spec in FAULT_SPECS[:1] if quick else FAULT_SPECS:
        yield spec, seeded_faults(
            FAULT_MESH_N, FAULT_MESH_N, link_rate=spec["link_rate"],
            router_rate=spec["router_rate"], pe_rate=spec["pe_rate"],
            seed=spec["seed"])


def faulted_collective_programs(quick: bool = False,
                                payload_bits: float = 512.0
                                ) -> Iterator[tuple]:
    """``(case, cfg, faults, program)``: the full collective matrix
    (op x semantics x allreduce algorithm over the full mesh and a
    scattered set) repaired under every corpus fault density."""
    cfg = NocConfig(n=FAULT_MESH_N)
    n = FAULT_MESH_N
    full = [(x, y) for x in range(n) for y in range(n)]
    scattered = [(0, 0), (n - 1, 1), (1, n - 1), (n - 2, n - 2)]
    for spec, faults in fault_models(quick):
        for label, parts in (("full", full), ("scattered", scattered)):
            for op in COLLECTIVE_OPS:
                for semantics in SEMANTICS:
                    algorithms = ALLREDUCE_ALGORITHMS \
                        if op == "allreduce" else ("reduce_bcast",)
                    for algorithm in algorithms:
                        prog = plan_collective(
                            op, parts, payload_bits, cfg,
                            algorithm=algorithm, semantics=semantics,
                            faults=faults)
                        case = {"label": label, "op": op,
                                "participants": parts,
                                "semantics": semantics,
                                "algorithm": algorithm,
                                "fault": spec["label"]}
                        yield case, cfg, faults, prog


def faulted_hier_schedules(quick: bool = False,
                           payload_bits: float = 4096.0) -> Iterator[tuple]:
    """``(case, faults, schedule)``: hierarchical collectives with
    link-only on-die faults (chip roots stay alive, so the chip-root
    invariant of ``verify_hier_schedule`` still binds) and one failed
    chip on the larger grid."""
    from repro_torch.core.noc.faults import seeded_faults
    from repro_torch.core.noc.hierarchy import (HIER_OPS, HierarchicalMesh,
                                          plan_hier_collective)
    faults = seeded_faults(FAULT_MESH_N, FAULT_MESH_N, link_rate=0.08,
                           seed=5)
    grids = HIER_GRIDS_QUICK if quick else HIER_GRIDS
    for grid in grids:
        failed = (grid[0] * grid[1] - 1,) if grid[0] * grid[1] > 2 else ()
        hmesh = HierarchicalMesh(chip_w=FAULT_MESH_N, chip_h=FAULT_MESH_N,
                                 chips_x=grid[0], chips_y=grid[1])
        for op in HIER_OPS:
            for semantics in SEMANTICS:
                sched = plan_hier_collective(
                    op, hmesh, payload_bits, semantics=semantics,
                    faults=faults, failed_chips=failed)
                case = {"grid": grid, "op": op, "semantics": semantics,
                        "failed_chips": failed}
                yield case, faults, sched


def ws_plan_shapes(quick: bool = False,
                   cfg: Optional[NocConfig] = None) -> list[dict]:
    """Every distinct fig7-12 per-layer plan shape.

    Dedup key: (mode, g, p, gather_flits, unicast_flits, e_pes) — exactly
    the part of the plan that determines the emitted round program.
    """
    from repro_torch.core.noc.traffic import layer_plan
    from repro_torch.core.workloads import WORKLOADS
    cfg = NocConfig() if cfg is None else cfg
    e_list = FIG_E_LIST_QUICK if quick else FIG_E_LIST
    seen = set()
    shapes = []
    for workload in FIG_WORKLOADS:
        for layer in WORKLOADS[workload]:
            for e_pes in e_list:
                for mode in FIG_MODES:
                    plan = layer_plan(layer, cfg, e_pes, mode)
                    key = (mode, plan.g, plan.p, plan.gather_flits,
                           plan.unicast_flits, e_pes)
                    if key in seen:
                        continue
                    seen.add(key)
                    shapes.append({
                        "workload": workload, "layer": layer.name,
                        "mode": mode, "e_pes": e_pes, "g": plan.g,
                        "p": plan.p, "gather_flits": plan.gather_flits,
                        "unicast_flits": plan.unicast_flits,
                    })
    return shapes


def ws_programs(quick: bool = False, window: int = 2,
                cfg: Optional[NocConfig] = None) -> Iterator[tuple]:
    """``(shape, cfg, program)`` for every distinct fig7-12 plan shape."""
    cfg = NocConfig() if cfg is None else cfg
    for shape in ws_plan_shapes(quick, cfg):
        prog = ws_round_program(
            cfg, shape["mode"], window, g=shape["g"], p=shape["p"],
            gather_flits=shape["gather_flits"],
            unicast_flits=shape["unicast_flits"], e_pes=shape["e_pes"])
        yield shape, cfg, prog
