"""``python -m repro_torch.analysis`` — the static-analysis CLI (the
counterpart of ``python -m repro.analysis``, over the port's modules).

Two subcommands:

``verify [--sections collectives,ws,hierarchy,schedules,plans,faults,kvcache]``
    Statically verify the repo's artifacts without running the event
    loop: every tree collective (both semantics x both allreduce
    algorithms over three participant shapes), every distinct fig7-12
    WS plan shape (source program + compiled lowering + ``replicate``),
    every hierarchical collective of the mesh-of-meshes corpus
    (chip-boundary routes, per-level fold-exactly-once, two-level CDG),
    quick-search mapper schedules, every persisted ExecutionPlan
    (``--plan-dir``; ``--build-plans`` populates the store for all
    (config x phase) cells first), and a deterministic paged-KV
    scenario.  Exit 1 on any finding; ``--json`` writes the findings
    artifact.

``lint [paths ...]``
    The determinism lint (``repro_torch.analysis.lint``) over
    ``src/repro_torch`` (or the given paths).  Exit 1 on any finding;
    reports the pragma budget.

An unknown ``verify`` section exits 2.
"""
from __future__ import annotations

import argparse
import sys

from .findings import Finding, dump_findings
from .lint import count_pragmas, lint_paths
from .verify import (verify_collective, verify_compiled,
                     verify_hier_schedule, verify_plan, verify_program,
                     verify_schedule)

#: All (config x phase) plan cells ``verify --build-plans`` covers.
PLAN_MESH = (("data", 16), ("model", 16))


def _print_findings(findings: list) -> None:
    for f in findings:
        print(f"  {f}")


# --------------------------------------------------------------------------- #
# verify sections
# --------------------------------------------------------------------------- #
def _section_collectives(args) -> tuple[int, list]:
    from repro_torch.core.noc.compiled import compile_program
    from .corpus import collective_programs
    findings: list = []
    checked = 0
    for case, cfg, prog in collective_programs():
        checked += 1
        where = (f"collective {case['op']}/{case['semantics']}/"
                 f"{case['algorithm']}/{case['label']}")
        fs = verify_program(prog, cfg)
        fs += verify_collective(
            prog, op=case["op"], participants=case["participants"],
            algorithm=case["algorithm"], semantics=case["semantics"])
        cp = compile_program(prog, cfg)
        fs += verify_compiled(cp, prog, cfg)
        findings += [Finding(f.check, f"{where}: {f.where}", f.message)
                     for f in fs]
    return checked, findings


def _section_ws(args) -> tuple[int, list]:
    from repro_torch.core.noc.compiled import compile_program
    from .corpus import ws_programs
    findings: list = []
    checked = 0
    for shape, cfg, prog in ws_programs(quick=args.quick, window=2):
        checked += 1
        where = (f"ws {shape['workload']}/{shape['layer']}/"
                 f"{shape['mode']}/E{shape['e_pes']}")
        fs = verify_program(prog, cfg)
        cp = compile_program(prog, cfg)
        fs += verify_compiled(cp, prog, cfg)
        # replicate() must preserve the encoding invariants (dep shifts).
        fs += verify_compiled(cp.replicate(3))
        findings += [Finding(f.check, f"{where}: {f.where}", f.message)
                     for f in fs]
    return checked, findings


def _section_hierarchy(args) -> tuple[int, list]:
    """Hierarchy invariants (DESIGN.md S14) over the mesh-of-meshes
    corpus: chip-boundary route legality, per-level fold-exactly-once,
    and CDG deadlock freedom over the two-level channel graph."""
    from .corpus import hier_schedules
    findings: list = []
    checked = 0
    for case, sched in hier_schedules(quick=args.quick):
        checked += 1
        cx, cy = case["grid"]
        where = (f"hier {cx}x{cy}/{case['package']}/{case['op']}/"
                 f"{case['semantics']}/{case['algorithm']}")
        findings += [Finding(f.check, f"{where}: {f.where}", f.message)
                     for f in verify_hier_schedule(sched)]
    return checked, findings


def _section_schedules(args) -> tuple[int, list]:
    from repro_torch.core.workloads import mapper_workloads
    from repro_torch.mapper.search import search_network
    from repro_torch.mapper.space import QUICK_MAPPER
    findings: list = []
    checked = 0
    workloads = mapper_workloads(conv=("alexnet",),
                                 transformers=("qwen2-1.5b",))
    for name in sorted(workloads):
        layers = workloads[name]
        outcome = search_network(name, layers, QUICK_MAPPER)
        for label, sched in (("best", outcome.best),
                             ("baseline", outcome.baseline)):
            checked += 1
            fs = verify_schedule(sched, layers)
            findings += [Finding(f.check,
                                 f"schedule {name}/{label}: {f.where}",
                                 f.message) for f in fs]
    return checked, findings


def _section_plans(args) -> tuple[int, list]:
    from repro_torch.plan.store import PlanStore
    store = PlanStore(args.plan_dir)
    findings: list = []
    if args.build_plans:
        from repro_torch.configs import ARCHS
        from repro_torch.plan.builder import PHASES
        phases = ("decode",) if args.quick else PHASES
        for name in sorted(ARCHS):
            for phase in phases:
                try:
                    store.get_or_build(ARCHS[name], PLAN_MESH, phase,
                                       mapper_space=args.mapper_space)
                except Exception as exc:   # a build crash is a finding
                    findings.append(Finding(
                        "plan-schema", f"build {name}/{phase}",
                        f"plan build failed: {exc}"))
    checked = 0
    store.dir.mkdir(parents=True, exist_ok=True)
    for path in sorted(store.dir.glob("*.json")):
        key = path.stem
        plan = store.load(key)
        if plan is None:
            findings.append(Finding(
                "plan-schema", f"plan {key}",
                "stored file is unreadable or stale-schema "
                "(would rebuild cold)"))
            continue
        checked += 1
        findings += verify_plan(plan, check_layers=True)
    return checked, findings


def _section_faults(args) -> tuple[int, list]:
    """Fault-repaired artifacts (DESIGN.md S15): every faulted corpus
    program passes the fault classes (clear routes, one turn rule, remap
    closure), the full fold/deliver algebra over the usable set, the CDG
    deadlock check on the actual detour paths, and the compiled-lowering
    conservation pass; faulted hierarchy schedules keep the S14
    invariants with a failed chip excluded end to end."""
    from repro_torch.core.noc.compiled import compile_program
    from .corpus import faulted_collective_programs, faulted_hier_schedules
    from .verify import verify_faulted
    findings: list = []
    checked = 0
    for case, cfg, faults, prog in \
            faulted_collective_programs(quick=args.quick):
        checked += 1
        where = (f"faulted[{case['fault']}] {case['op']}/"
                 f"{case['semantics']}/{case['algorithm']}/{case['label']}")
        fs = verify_faulted(prog, faults, cfg, op=case["op"],
                            participants=case["participants"],
                            algorithm=case["algorithm"],
                            semantics=case["semantics"])
        cp = compile_program(prog, cfg)
        fs += verify_compiled(cp, prog, cfg)
        findings += [Finding(f.check, f"{where}: {f.where}", f.message)
                     for f in fs]
    for case, faults, sched in faulted_hier_schedules(quick=args.quick):
        checked += 1
        cx, cy = case["grid"]
        where = (f"faulted-hier {cx}x{cy}/{case['op']}/"
                 f"{case['semantics']}")
        findings += [Finding(f.check, f"{where}: {f.where}", f.message)
                     for f in verify_hier_schedule(sched)]
    return checked, findings


def _section_kvcache(args) -> tuple[int, list]:
    """A deterministic allocator scenario: interleaved alloc/extend/free
    with failure paths, verified after every step."""
    from repro_torch.serve.kvcache import BlockAllocator
    from .verify import verify_allocator
    findings: list = []
    alloc = BlockAllocator(32)
    steps = 0

    def snap(stage: str) -> None:
        nonlocal steps
        steps += 1
        findings.extend(
            Finding(f.check, f"kvcache[{stage}]: {f.where}", f.message)
            for f in verify_allocator(alloc))

    alloc.alloc("a", 5)
    snap("alloc-a")
    alloc.alloc("b", 7)
    snap("alloc-b")
    alloc.extend("a", 3)
    snap("extend-a")
    alloc.free("b")
    snap("free-b")
    for exc_type, fn in (
            (KeyError, lambda: alloc.alloc("a", 1)),          # double table
            (KeyError, lambda: alloc.extend("ghost", 1)),     # no table
            (MemoryError, lambda: alloc.alloc("c", 99)),      # over budget
            (MemoryError, lambda: alloc.extend("a", -1)),     # negative
    ):
        try:
            fn()
            findings.append(Finding("kvcache", "scenario",
                                    f"expected {exc_type.__name__} "
                                    f"was not raised"))
        except exc_type:
            pass
        snap("failure-path")
    alloc.alloc("c", alloc.free_blocks)
    snap("alloc-to-capacity")
    alloc.free("a")
    alloc.free("c")
    snap("drained")
    if alloc.free_blocks != alloc.num_blocks:
        findings.append(Finding("kvcache", "scenario",
                                "blocks not fully recovered after drain"))
    return steps, findings


_SECTIONS = {
    "collectives": _section_collectives,
    "ws": _section_ws,
    "hierarchy": _section_hierarchy,
    "schedules": _section_schedules,
    "plans": _section_plans,
    "faults": _section_faults,
    "kvcache": _section_kvcache,
}


def cmd_verify(args) -> int:
    names = [s.strip() for s in args.sections.split(",") if s.strip()]
    unknown = [n for n in names if n not in _SECTIONS]
    if unknown:
        print(f"unknown sections: {unknown} "
              f"(have {sorted(_SECTIONS)})", file=sys.stderr)
        return 2
    all_findings: list = []
    for name in names:
        checked, findings = _SECTIONS[name](args)
        status = "ok" if not findings else f"{len(findings)} finding(s)"
        print(f"[analysis] verify {name}: {checked} artifact(s), {status}")
        _print_findings(findings)
        all_findings += findings
    if args.json:
        dump_findings(args.json, all_findings, command="verify",
                      sections=names)
        print(f"[analysis] wrote {args.json}")
    print(f"[analysis] verify: {len(all_findings)} finding(s) total")
    return 1 if all_findings else 0


def cmd_lint(args) -> int:
    paths = args.paths or ["src/repro_torch"]
    findings = lint_paths(paths)
    for f in findings:
        print(f"  {f}")
    pragmas = count_pragmas(paths)
    print(f"[analysis] lint: {len(findings)} finding(s), "
          f"{pragmas} pragma(s) in {', '.join(map(str, paths))}")
    if args.json:
        dump_findings(args.json, findings, command="lint",
                      pragmas=pragmas)
        print(f"[analysis] wrote {args.json}")
    return 1 if findings else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static artifact verifier + determinism lint")
    sub = ap.add_subparsers(dest="cmd", required=True)

    vp = sub.add_parser("verify", help="verify NoC/plan/kvcache artifacts")
    vp.add_argument("--sections", default=",".join(_SECTIONS),
                    help=f"comma list of {sorted(_SECTIONS)}")
    vp.add_argument("--plan-dir", default=None,
                    help="ExecutionPlan store to verify "
                         "(default: results/.plans_torch)")
    vp.add_argument("--build-plans", action="store_true",
                    help="populate the store for every (config x phase) "
                         "cell before verifying")
    vp.add_argument("--mapper-space", default="quick",
                    choices=("quick", "full"),
                    help="gemm search space when building plans")
    vp.add_argument("--quick", action="store_true",
                    help="CI shape: E in {1,4}; --build-plans covers the "
                         "decode phase only")
    vp.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings artifact here")
    vp.set_defaults(func=cmd_verify)

    lp = sub.add_parser("lint", help="determinism lint over source trees")
    lp.add_argument("paths", nargs="*",
                    help="files/dirs (default: src/repro_torch)")
    lp.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings artifact here")
    lp.set_defaults(func=cmd_lint)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
