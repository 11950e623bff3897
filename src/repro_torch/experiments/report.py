"""Markdown summary for a sweep run (written as ``results/summary.md``; a
copy of ``repro.experiments.report``)."""
from __future__ import annotations


def _ratio_table(rows: list[dict], extra_cols: tuple[str, ...] = ()) -> str:
    cols = list(extra_cols) + ["workload", "e_pes",
                               "latency_x", "power_x", "energy_x"]
    head = "| " + " | ".join(cols) + " |"
    rule = "|" + "|".join("---" for _ in cols) + "|"
    body = []
    for r in rows:
        cells = [f"{r[c]:.3f}" if isinstance(r[c], float) else str(r[c])
                 for c in cols]
        body.append("| " + " | ".join(cells) + " |")
    return "\n".join([head, rule] + body)


def _hierarchy_table(rows: list[dict]) -> str:
    head = ("| N | payload (Kbit) | chips | package | width ratio | "
            "INA cycles | latency_x | energy_x |")
    rule = "|---|---|---|---|---|---|---|---|"
    body = [(f"| {r['n']} | {r['payload_bits'] / 1024:g} | {r['chips']} | "
             f"{r['package']} | {r['pkg_width_ratio']} | "
             f"{r['ina_latency_cycles']} | {r['latency_x']:.3f} | "
             f"{r['energy_x']:.3f} |") for r in rows]
    return "\n".join([head, rule] + body)


def _mapper_table(rows: list[dict]) -> str:
    head = ("| workload | layers | best hw (WxHxE) | latency_x | energy_x | "
            "util (paper -> auto) |")
    rule = "|---|---|---|---|---|---|"
    body = [(f"| {r['workload']} | {r['layers']} | {r['hardware']} | "
             f"{r['latency_x']:.3f} | {r['energy_x']:.3f} | "
             f"{r['paper_utilization']:.3f} -> {r['auto_utilization']:.3f} |")
            for r in rows]
    return "\n".join([head, rule] + body)


def _plan_table(rows: list[dict]) -> str:
    head = ("| workload | phase | sites (distinct) | modes | psum lat_x | "
            "mapper lat_x | hw | warm | sims |")
    rule = "|---|---|---|---|---|---|---|---|---|"
    body = []
    for r in rows:
        if "plan_error" in r:
            # Keep the table well-formed: exception text may carry
            # newlines/pipes.
            from .sweeps import sanitize_error
            msg = sanitize_error(r["plan_error"], "|")
            body.append(f"| {r['workload']} | {r['phase']} | "
                        f"ERROR: {msg} | | | | | | |")
            continue
        modes = ", ".join(f"{m}:{c}" for m, c in r["modes"].items())
        body.append(
            f"| {r['workload']} | {r['phase']} | {r['sites']} "
            f"({r['distinct_sites']}) | {modes} | "
            f"{r['psum_latency_x']:.3f} | {r['mapper_latency_x']:.3f} | "
            f"{r['mapper_hardware']} | {'yes' if r['warm'] else 'no'} | "
            f"{r['collective_engine_runs']} |")
    return "\n".join([head, rule] + body)


def _serve_table(fig: dict) -> str:
    head = ("| workload | semantics | qps | fleet | p99 queueing (s) | "
            "p99 ttft (s) | tok/s | SLO |")
    rule = "|---|---|---|---|---|---|---|---|"
    body = []
    for r in fig["rows"]:
        if "serve_error" in r:
            from .sweeps import sanitize_error
            msg = sanitize_error(r["serve_error"], "|")
            body.append(f"| {r['workload']} | {r.get('semantics', '')} | "
                        f"{r.get('qps', '')} | {r.get('fleet', '')} | "
                        f"ERROR: {msg} | | | |")
            continue
        body.append(
            f"| {r['workload']} | {r['semantics']} | {r['qps']:g} | "
            f"{r['fleet']} | {r['p99_queueing_ms'] / 1e3:.2f} | "
            f"{r['p99_ttft_ms'] / 1e3:.2f} | {r['throughput_tok_s']:.1f} | "
            f"{'met' if r['slo_met'] else 'miss'} |")
    lines = [head, rule] + body
    answers = fig.get("answers") or []
    if answers:
        lines += ["", f"**Fleet sizing (p99 {fig['slo_metric']} <= "
                      f"{fig['slo_ms'] / 1e3:g} s modeled):**"]
        for a in answers:
            fleet = (f"{a['fleet_needed']} instance(s)"
                     if a["fleet_needed"] is not None
                     else "not met at swept sizes")
            lines.append(f"- {a['workload']} @ {a['qps']:g} qps "
                         f"[{a['semantics']}]: {fleet}")
    return "\n".join(lines)


def _faults_table(fig: dict) -> str:
    head = ("| workload | fault | links/routers/PEs down | latency_x | "
            "energy_x | INA degraded_x |")
    rule = "|---|---|---|---|---|---|"
    body = []
    for r in fig["rows"]:
        if "faults_error" in r:
            from .sweeps import sanitize_error
            msg = sanitize_error(r["faults_error"], "|")
            body.append(f"| {r['workload']} | {r['fault']} | "
                        f"ERROR: {msg} | | | |")
            continue
        deg = (f"{r['ina_degraded_x']:.3f}"
               if r["ina_degraded_x"] is not None else "NA")
        body.append(
            f"| {r['workload']} | {r['fault']} | "
            f"{r['failed_links']}/{r['failed_routers']}/{r['failed_pes']} | "
            f"{r['latency_x']:.3f} | {r['energy_x']:.3f} | {deg} |")
    lines = [head, rule] + body
    cluster = fig.get("cluster_rows") or []
    if cluster:
        lines += ["", "**Cluster degradation (seeded replica-failure "
                      "trace + fault-priced slowdown):**"]
        for r in cluster:
            if "faults_error" in r:
                from .sweeps import sanitize_error
                lines.append(f"- {r['fault']}: ERROR "
                             f"{sanitize_error(r['faults_error'], '|')}")
                continue
            lines.append(
                f"- {r['fault']}: slowdown {r['slowdown']:.3f}x, "
                f"goodput {r['goodput']:.3f}, p99 e2e "
                f"{r['p99_e2e_ms'] / 1e3:.2f} s, {r['retries']} retries, "
                f"{r['failed_requests']} failed, "
                f"{r['downtime_events']} downtime event(s)")
    return "\n".join(lines)


def _tables_table(rows: list[dict]) -> str:
    head = "| network | N | layer | P# | INA# |"
    rule = "|---|---|---|---|---|"
    body = [f"| {r['network']} | {r['n']} | {r['layer']} | {r['P#']} | "
            f"{r['INA#'] if r['INA#'] is not None else 'NA'} |"
            for r in rows]
    return "\n".join([head, rule] + body)


def summary_markdown(results: dict) -> str:
    """Render the dict returned by :func:`~.sweeps.run_all` as markdown."""
    parts = ["# Paper-evaluation sweep summary", ""]
    meta = results.get("_meta", {})
    sweep = meta.get("sweep", {})
    if sweep:
        parts += [f"Sweep: `sim_rounds={sweep.get('sim_rounds')}`, "
                  f"E ∈ {sweep.get('e_list')}, N ∈ {sweep.get('n_list')}, "
                  f"workloads {sweep.get('workloads')}", ""]
    for section in ("fig7_9", "fig10_12"):
        fig = results.get(section)
        if not fig:
            continue
        parts += [f"## {section} — {fig['paper_reference']}", "",
                  _ratio_table(fig["rows"]), ""]
        avg = fig.get("average")
        if avg:
            parts += [f"**Simulated average:** latency_x="
                      f"{avg['latency_x']:.3f}, power_x={avg['power_x']:.3f},"
                      f" energy_x={avg['energy_x']:.3f}", ""]
    fig = results.get("mesh_scaling")
    if fig:
        parts += [f"## mesh_scaling — {fig['paper_reference']}", "",
                  _ratio_table(fig["rows"], extra_cols=("n",)), ""]
    fig = results.get("hierarchy")
    if fig:
        parts += [f"## hierarchy — {fig['paper_reference']}", "",
                  _hierarchy_table(fig["rows"]), "",
                  "Whole-package allreduce over every PE; ratios are "
                  "eject/inject over INA, so a row > 1 means the paper's "
                  "advantage survives that chip count and package-link "
                  "speed (`package=flat` rows are the single-chip paper "
                  "mesh; see DESIGN.md S14).", ""]
    fig = results.get("mapper")
    if fig:
        parts += [f"## mapper — {fig['paper_reference']}", "",
                  _mapper_table(fig["rows"]), "",
                  "Ratios are paper-fixed / auto-searched (>= 1 by the "
                  "baseline-dominating selection; see DESIGN.md S9). "
                  "Per-workload Pareto fronts and the winning "
                  "`NetworkSchedule`s are in `mapper.json`.", ""]
    fig = results.get("plan")
    if fig:
        parts += [f"## plan — {fig['paper_reference']}", "",
                  _plan_table(fig["rows"]), "",
                  "`psum lat_x` = predicted whole-model accumulation gain "
                  "of the planned strategies over all-eject/inject; "
                  "`warm`/`sims` show store behaviour (a warm store plans "
                  "with 0 collective simulations).  Full plans: "
                  "`plan.json` + the store dir (see EXPERIMENTS.md).", ""]
    fig = results.get("serve")
    if fig:
        parts += [f"## serve — {fig['paper_reference']}", "",
                  _serve_table(fig), "",
                  "Both semantics price the *same* per-phase ExecutionPlan; "
                  "`ina` uses planned collective latencies, `eject_inject` "
                  "the software-baseline ones, so a smaller fleet under "
                  "`ina` is the in-network-accumulation advantage stated "
                  "as capacity (see DESIGN.md S12).", ""]
    fig = results.get("faults")
    if fig:
        parts += [f"## faults — {fig['paper_reference']}", "",
                  _faults_table(fig), "",
                  "Collectives replan over repaired (turn-model-safe) "
                  "trees on the seeded faulted mesh; ratios are "
                  "eject/inject over INA on the *same* faulted fabric, "
                  "and `INA degraded_x` is faulted-INA over clean-INA "
                  "(see DESIGN.md S15).", ""]
    fig = results.get("tables")
    if fig:
        parts += [f"## Tables I & II — {fig['paper_reference']}", "",
                  _tables_table(fig["rows"]), ""]
    if meta:
        cache = meta.get("cache", {})
        timings = meta.get("elapsed_s", {})
        hit_rate = cache.get("hit_rate")
        rate = f", {hit_rate:.1%} hit rate" if hit_rate is not None else ""
        disk = cache.get("disk_hits")
        disk_s = f", {disk} from the persistent store" if disk else ""
        jobs = sweep.get("jobs")
        parts += ["## Run stats", "",
                  "Section timings: " + ", ".join(
                      f"{k} {v:.2f}s" for k, v in timings.items())
                  + (f" (jobs={jobs})" if jobs and jobs > 1 else ""),
                  f"Window cache: {cache.get('entries')} entries, "
                  f"{cache.get('hits')} hits / {cache.get('misses')} misses"
                  f"{rate}{disk_s} "
                  f"(see EXPERIMENTS.md)", ""]
    return "\n".join(parts)
