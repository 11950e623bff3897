"""CLI: reproduce the paper's evaluation into ``results/`` (the port's copy
of ``python -m repro.experiments``).

Usage (see EXPERIMENTS.md):

    PYTHONPATH=src python -m repro_torch.experiments              # full sweep
    PYTHONPATH=src python -m repro_torch.experiments --quick      # CI smoke
    PYTHONPATH=src python -m repro_torch.experiments --sections fig7_9,fig10_12
    PYTHONPATH=src python -m repro_torch.experiments --section mapper

The port has one simulation engine, the heap engine, and its window store
is always on, so the reference's ``--engine`` and ``--no-cache`` flags are
not copied.  The window store and the plan store default to the port's own
directories (``$REPRO_TORCH_SIMCACHE_DIR``, ``$REPRO_TORCH_PLAN_DIR``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.core.noc import simcache

from .sweeps import (DEFAULT_SWEEP, QUICK_SWEEP, SECTIONS, SweepConfig,
                     run_all)


def _int_tuple(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments",
        description="Run the paper's evaluation sweeps (Tables I/II, "
                    "Figs 7-12, mesh scaling) and write JSON + markdown "
                    "artifacts.")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke shape: sim_rounds=4, E in {1,4}, "
                         "N in {4,8}")
    ap.add_argument("--out", default="results",
                    help="output directory (default: results/)")
    ap.add_argument("--sections", "--section", dest="sections",
                    default=",".join(SECTIONS),
                    help=f"comma-separated subset of {SECTIONS}")
    ap.add_argument("--sim-rounds", type=int, default=None,
                    help="override the simulated window length")
    ap.add_argument("--e", type=_int_tuple, default=None, metavar="E1,E2,..",
                    help="override the PEs-per-router sweep")
    ap.add_argument("--n", type=_int_tuple, default=None, metavar="N1,N2,..",
                    help="override the mesh-size sweep")
    ap.add_argument("--workloads", default=None,
                    help="comma-separated subset of alexnet,vgg16,resnet50")
    ap.add_argument("--pe-budget", type=int, default=None, metavar="P",
                    help="mapper section: per-chip W*H*E PE ceiling "
                         "(default: the space's own budget, 64)")
    ap.add_argument("--chips", type=_int_tuple, default=None,
                    metavar="C1,C2,..",
                    help="mapper section: package-replication axis, e.g. "
                         "1,2,4 (default 1 = flat mesh; DESIGN.md S14)")
    ap.add_argument("--jobs", type=int, default=None, metavar="N",
                    help="fan sweeps/mapper search over N processes "
                         "(0 = all cores; default 1)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent window-cache directory (default "
                         f"${simcache.CACHE_DIR_ENV} or "
                         "results/.simcache_torch)")
    ap.add_argument("--plan-dir", default=None, metavar="DIR",
                    help="ExecutionPlan store for --section plan (default "
                         "$REPRO_TORCH_PLAN_DIR or results/.plans_torch)")
    ap.add_argument("--no-persist", action="store_true",
                    help="in-memory window cache only (no on-disk store)")
    args = ap.parse_args(argv)

    sweep: SweepConfig = QUICK_SWEEP if args.quick else DEFAULT_SWEEP
    overrides = {}
    if args.sim_rounds is not None:
        if args.sim_rounds < 1:
            ap.error("--sim-rounds must be >= 1")
        overrides["sim_rounds"] = args.sim_rounds
    for flag, value in (("--e", args.e), ("--n", args.n)):
        if value is not None and (not value or min(value) < 1):
            ap.error(f"{flag} needs at least one positive value")
    if args.e is not None:
        overrides["e_list"] = args.e
    if args.n is not None:
        overrides["n_list"] = args.n
    if args.workloads is not None:
        from repro_torch.core.workloads import WORKLOADS
        workloads = tuple(w for w in args.workloads.split(",") if w)
        unknown = [w for w in workloads if w not in WORKLOADS]
        if unknown or not workloads:
            ap.error(f"unknown workloads {unknown}; "
                     f"pick from {sorted(WORKLOADS)}")
        overrides["workloads"] = workloads
    if args.pe_budget is not None:
        if args.pe_budget < 1:
            ap.error("--pe-budget must be >= 1")
        overrides["mapper_pe_budget"] = args.pe_budget
    if args.chips is not None:
        if not args.chips or min(args.chips) < 1:
            ap.error("--chips needs at least one positive value")
        overrides["mapper_chips"] = args.chips
    if args.jobs is not None:
        from repro_torch.exec import default_jobs
        if args.jobs < 0:
            ap.error("--jobs must be >= 0 (0 = all cores)")
        overrides["jobs"] = default_jobs(args.jobs if args.jobs else None)
    if args.plan_dir is not None:
        overrides["plan_dir"] = args.plan_dir
    if overrides:
        sweep = dataclasses.replace(sweep, **overrides)

    loaded = 0
    if not args.no_persist:
        cache_dir = args.cache_dir or simcache.SIM_CACHE.persist_default_dir()
        loaded = simcache.SIM_CACHE.persist(cache_dir)
    sections = tuple(s for s in args.sections.split(",") if s)
    unknown = [s for s in sections if s not in SECTIONS]
    if unknown:
        ap.error(f"unknown sections {unknown}; pick from {SECTIONS}")
    results = run_all(sweep, out_dir=args.out, sections=sections)
    meta = results["_meta"]
    for section in sections:
        fig = results[section]
        line = f"{section}: {len(fig['rows'])} rows"
        if "average" in fig:
            avg = fig["average"]
            line += (f"  (avg latency_x={avg['latency_x']:.3f}, "
                     f"power_x={avg['power_x']:.3f}, "
                     f"energy_x={avg['energy_x']:.3f})")
        print(line)
    cache = meta["cache"]
    persisted = ""
    if not args.no_persist:
        saved = simcache.SIM_CACHE.save()
        persisted = (f"; persistent store: {loaded} rows loaded, "
                     f"{saved} saved ({simcache.SIM_CACHE.stats()['persist_dir']})")
    print(f"artifacts in {args.out}/ (summary.md, benchmarks.csv, "
          f"per-section JSON); cache: {cache['entries']} entries, "
          f"{cache['hits']} hits / {cache['misses']} misses "
          f"({cache['hit_rate']:.1%} hit rate)"
          f"{persisted}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
