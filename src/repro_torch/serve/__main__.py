"""Capacity-planning CLI: serve a seeded workload, answer fleet sizing.

  PYTHONPATH=src python -m repro_torch.serve --arch qwen2-1.5b --qps 50 \\
      --requests 200 --slo-p99-ms 200 --search-fleet

(the port's copy of ``python -m repro.serve``; add ``--device cpu`` to run
the engine demo on the CPU, or ``--no-execute`` to skip it).

Three stages, one deterministic JSON artifact:

1. **Plans** — per-phase ExecutionPlans (prefill + decode) through the
   persistent PlanStore; a warm store answers with 0 collective engine
   runs (recorded in the JSON as the warm-plan evidence).
2. **Engine demo** — a reduced-config
   :class:`~repro_torch.serve.ServingEngine` executes a few requests
   end-to-end on ``--device`` (default ``cuda``: the ``ina_matmul`` and
   ``flash_attention`` kernels; continuous batching, paged KV,
   paged==monolithic checks); its token ids land in the JSON, its wall
   time only on stdout.
3. **Cluster sim** — the full workload through N simulated instances with
   plan-derived iteration latencies; TTFT/TPOT/p50/p95/p99, throughput,
   queueing, Little's-law check, and (with ``--search-fleet``) the
   smallest fleet meeting the SLO.

The JSON contains no wall-clock and is written with sorted keys: identical
seed and flags give byte-identical output (CI diffs two runs).
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from repro_torch.configs import ARCHS
from repro_torch.exec.timing import Stopwatch

_ENGINE_EXCLUDED = ("encdec", "vlm")


def parse_mesh(spec: str):
    d, m = spec.lower().split("x")
    return (("data", int(d)), ("model", int(m)))


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.plan import add_plan_cli_args
    from repro_torch.serve.batching import POLICIES
    from repro_torch.serve.costs import SEMANTICS

    ap = argparse.ArgumentParser(
        prog="repro_torch.serve",
        description="serving capacity planner (engine + cluster simulator)")
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--seed", type=int, default=0)
    # workload
    ap.add_argument("--qps", type=float, default=50.0,
                    help="Poisson arrival rate (<=0: all at t=0)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--prompt-dist", default="lognormal:128:0.5:512")
    ap.add_argument("--gen-dist", default="uniform:32:128")
    ap.add_argument("--trace", default=None, metavar="JSON",
                    help="replay a recorded trace instead of sampling")
    # instance geometry
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--policy", default="fcfs", choices=POLICIES)
    # cost model
    ap.add_argument("--mesh", default="8x8",
                    help="per-instance mesh DxM for the phase plans")
    ap.add_argument("--semantics", default="ina", choices=SEMANTICS,
                    help="collective semantics priced by the cost model")
    ap.add_argument("--chips", type=int, default=1,
                    help="chips per replica; with --search-fleet every "
                         "power of two up to this joins the trade-off "
                         "(replica count vs chips each, DESIGN.md S14)")
    ap.add_argument("--package", default="mesh",
                    choices=("mesh", "express"),
                    help="cross-chip package fabric for --chips > 1")
    ap.add_argument("--clock-ghz", type=float, default=1.0)
    ap.add_argument("--calibration", type=float, default=1.0,
                    help="measured-seconds-per-modeled-second scale")
    add_plan_cli_args(ap)
    # fleet question
    ap.add_argument("--fleet", type=int, default=1)
    ap.add_argument("--search-fleet", action="store_true")
    ap.add_argument("--max-fleet", type=int, default=16)
    ap.add_argument("--slo-p99-ms", type=float, default=200.0)
    ap.add_argument("--slo-metric", default="e2e_s",
                    choices=("e2e_s", "ttft_s", "queueing_s"))
    # engine demo
    ap.add_argument("--no-execute", action="store_true",
                    help="skip the reduced-config engine execution")
    ap.add_argument("--execute-requests", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="device of the engine demo (cpu runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--out", default=None, metavar="JSON")
    return ap


def run_engine_demo(cfg, seed: int, n: int, device="cuda",
                    params=None) -> dict:
    """Execute ``n`` small requests on the reduced config: functional
    evidence (deterministic token ids + paged==monolithic checks).
    ``params`` are the reduced model's weights (default: seeded by the
    engine)."""
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.traffic import make_workload

    rc = cfg.reduced()
    reqs = make_workload(n, qps=0.0, prompt_dist="uniform:4:12",
                         gen_dist="uniform:2:6", seed=seed,
                         vocab=rc.vocab, prefix="e")
    eng = ServingEngine(rc, params=params, device=device, slots=2,
                        max_seq=rc.max_seq, block_size=8, prefill_chunk=4,
                        check=True)
    watch = Stopwatch()
    report = eng.run(reqs)
    wall = watch.seconds
    print(f"[serve] engine demo: {len(reqs)} requests, "
          f"{report.iterations} iterations, {report.decode_steps} decode "
          f"steps, {report.prefill_chunks} prefill chunks, "
          f"{report.checks} paged==monolithic checks in {wall:.1f}s")
    return {
        "arch_reduced": rc.name, "requests": len(reqs),
        "slots": 2, "block_size": 8, "prefill_chunk": 4,
        "iterations": report.iterations,
        "decode_steps": report.decode_steps,
        "prefill_chunks": report.prefill_chunks,
        "paged_monolithic_checks": report.checks,
        "tokens": report.tokens(),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = ARCHS[args.arch]
    mesh_shape = parse_mesh(args.mesh)
    if not args.no_execute and cfg.family not in _ENGINE_EXCLUDED:
        from repro_torch import _device
        _device.resolve(args.device)        # refuse a missing GPU up front

    # -- per-phase plans + cost model ---------------------------------- #
    # chip options: powers of two up to --chips (1 always included); the
    # single-run path prices exactly --chips, --search-fleet trades them.
    chip_options = [1]
    while chip_options[-1] * 2 <= max(1, args.chips):
        chip_options.append(chip_options[-1] * 2)
    if args.chips not in chip_options:
        chip_options.append(args.chips)
    doc_plan = None
    cost_by_chips = None
    if args.no_plan:
        from repro_torch.serve.costs import SyntheticCostModel
        cost = SyntheticCostModel()
        print("[serve] --no-plan: synthetic cost model")
    else:
        from repro_torch.serve.costs import PlanCostModel, serve_plans
        doc_plan = {}
        cost_by_chips = {}
        want = chip_options if args.search_fleet else [args.chips]
        for chips in want:
            plans = serve_plans(cfg, mesh_shape, plan_dir=args.plan_dir,
                                chips=chips, package=args.package)
            cost_by_chips[chips] = PlanCostModel.from_plans(
                cfg, plans["prefill"][0], plans["decode"][0],
                prefill_chunk=args.prefill_chunk, semantics=args.semantics,
                clock_ghz=args.clock_ghz, calibration=args.calibration)
            for phase, (_, info) in plans.items():
                doc_plan[f"{phase}__c{chips}" if chips > 1 else phase] = {
                    "key": info["key"], "from_store": info["from_store"],
                    "collective_sims": info["collective_sims"],
                    "modes": info["psum"]["modes"]}
        cost = cost_by_chips[args.chips if not args.search_fleet
                             else chip_options[0]]
        total_sims = sum(p["collective_sims"] for p in doc_plan.values())
        print(f"[serve] per-phase plans ready "
              f"(collective sims this launch: {total_sims})")

    # -- workload ------------------------------------------------------ #
    from repro_torch.serve.traffic import load_trace, make_workload
    if args.trace:
        requests = load_trace(args.trace)
    else:
        requests = make_workload(args.requests, args.qps, args.prompt_dist,
                                 args.gen_dist, args.seed)
    too_big = [r for r in requests if r.total_positions > args.max_seq]
    if too_big:
        raise SystemExit(f"{len(too_big)} requests exceed --max-seq "
                         f"{args.max_seq} (first: {too_big[0].rid})")

    # -- engine demo --------------------------------------------------- #
    doc_engine = None
    if not args.no_execute:
        if cfg.family in _ENGINE_EXCLUDED:
            print(f"[serve] engine demo skipped: family {cfg.family!r} "
                  "needs media plumbing")
        else:
            doc_engine = run_engine_demo(cfg, args.seed,
                                         args.execute_requests, args.device)

    # -- cluster simulation / fleet search ----------------------------- #
    sim_kwargs = dict(slots=args.slots, block_size=args.block_size,
                      num_blocks=args.num_blocks, max_seq=args.max_seq,
                      prefill_chunk=args.prefill_chunk, cost=cost,
                      policy=args.policy)
    slo_s = args.slo_p99_ms / 1e3
    watch = Stopwatch()
    if args.search_fleet:
        from repro_torch.serve.cluster import search_fleet
        multi = cost_by_chips if cost_by_chips and len(cost_by_chips) > 1 \
            else None
        if multi is not None:
            sim_kwargs.pop("cost")
        answer = search_fleet(requests, slo_s, metric=args.slo_metric,
                              max_fleet=args.max_fleet,
                              cost_by_chips=multi, **sim_kwargs)
        metrics = answer["metrics"] or {}
        doc_fleet = answer
        fleet_str = answer["fleet"] if answer["fleet"] is not None \
            else f">{args.max_fleet}"
        if multi is not None and answer["fleet"] is not None:
            fleet_str = (f"{answer['fleet']} x "
                         f"{answer['chips_per_replica']}-chip "
                         f"({answer['total_chips']} chips total)")
        print(f"[serve] fleet answer: {fleet_str} instance(s) for p99 "
              f"{args.slo_metric} <= {args.slo_p99_ms} ms "
              f"({len(answer['searched'])} sizes simulated, "
              f"{watch.seconds:.1f}s)")
    else:
        from repro_torch.serve.cluster import ClusterSimulator
        metrics = ClusterSimulator(args.fleet, **sim_kwargs).run(requests)
        met = metrics[args.slo_metric]["p99"]
        doc_fleet = {"fleet": args.fleet, "slo_s": slo_s,
                     "metric": args.slo_metric, "searched": [],
                     "metrics": metrics, "slo_met": bool(met <= slo_s)}
        print(f"[serve] fleet {args.fleet}: p99 {args.slo_metric} "
              f"{met*1e3:.2f} ms (SLO {args.slo_p99_ms} ms) "
              f"in {watch.seconds:.1f}s")
    if metrics:
        print(f"[serve] throughput {metrics['throughput_rps']:.2f} req/s "
              f"{metrics['throughput_tok_s']:.1f} tok/s | "
              f"ttft p99 {metrics['ttft_s']['p99']*1e3:.2f} ms | "
              f"tpot p99 {metrics['tpot_s']['p99']*1e3:.2f} ms | "
              f"little's-law ratio {metrics['littles_law_ratio']:.4f}")

    # -- deterministic artifact ---------------------------------------- #
    doc = {
        "arch": args.arch, "seed": args.seed, "qps": args.qps,
        "requests": len(requests), "mesh": [list(p) for p in mesh_shape],
        "semantics": args.semantics, "clock_ghz": args.clock_ghz,
        "calibration": args.calibration,
        "chips": args.chips, "package": args.package,
        "instance": {"slots": args.slots, "max_seq": args.max_seq,
                     "block_size": args.block_size,
                     "num_blocks": args.num_blocks,
                     "prefill_chunk": args.prefill_chunk,
                     "policy": args.policy},
        "plan": doc_plan,
        "engine": doc_engine,
        "fleet_answer": doc_fleet,
    }
    out = args.out or os.path.join(
        "results", "serve", f"serve_{args.arch}_seed{args.seed}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    from repro_torch.core.noc.simcache import atomic_write_text
    atomic_write_text(Path(out),
                      json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"[serve] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
