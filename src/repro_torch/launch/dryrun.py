"""Multi-pod dry-run on ``meta``: each rank's work for every (arch x shape x
mesh) cell (counterpart of ``repro.launch.dryrun``).

For each cell this runs the real train, prefill or serve step of rank 0 of
the production mesh on the ``meta`` device, where nothing is computed or
allocated, and counts what the step would do on the card
(:mod:`repro_torch.core.cost`): FLOPs, bytes, collective bytes by kind,
kernel launches, and the argument, output, temp and peak memory.  The
reference lowers and compiles each step for the mesh and reads XLA's
cost and memory analyses and the HLO's collectives; eager PyTorch has no
compiler to ask, so the step is traced instead:

* the rank's :class:`~repro_torch.parallel.tp.ParallelCtx` has an
  :class:`~repro_torch.core.collectives.AxisSpan` on each axis of span
  > 1, so every collective runs its strategy's code up to the
  communication, which is recorded (one ``collective-permute`` a ring
  hop under ``ina_ring`` and ``eject_inject``; ``xla_spmd``, ``ina`` and
  ``xla`` run the native kinds);
* its parameters (and AdamW state for train) are the rank's pieces, as
  :func:`~repro_torch.parallel.sharding.shard_params` cuts them; its
  batch is its rows of ``model.input_specs(shape)``, each its own
  tensor;
* the step is the one :func:`~repro_torch.parallel.steps.build_train_step`,
  :func:`~repro_torch.parallel.steps.build_prefill` or
  :func:`~repro_torch.parallel.steps.build_serve_step` returns (with its
  cache), so a train cell runs the forward, the backward through the
  kernels' Functions, the gradient reductions, the FSDP gathers and
  AdamW.

A full-depth trace runs every layer (there is no scan body counted once),
so ``flops_per_device`` is the step's whole count.  ``roofline`` still
traces :func:`~repro_torch.configs.base.depth_scaled` configs of 1 and 2
units and extrapolates, as the reference does, with its keys; the full
trace makes it redundant (the two agree exactly wherever the costs are
linear in depth), and it stays for the reference's result keys.  Multi-pod
cells skip it, as the reference's do.  The result has ``trace_s`` where
the reference has ``lower_s`` and ``compile_s``, and ``kernels``:
launches, FLOPs and bytes by kernel.

Where the reference's ``fit_specs`` would drop or move a mesh axis, the
port cuts unevenly: a model span that does not divide the heads takes
the uneven head cut of the dense and moe families
(:func:`~repro_torch.parallel.sharding.head_split`; rank 0's piece is
traced), and a serve or prefill batch that the hosts (pod x data) do not
divide is replicated over them (:func:`_rows`).  A cell the port still
cannot cut (a train batch the hosts do not divide, a family without the
uneven head cut) raises with the port's own message and goes to
``failures``, as a failed cell does in the reference; the exit code is 1
if any cell failed.  Nothing is allocated on any
device, so the dry-run needs no GPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--psum-mode ina_ring]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Optional

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.configs.base import (ModelConfig, ShapeConfig, depth_scaled,
                                      depth_units)
from repro_torch.core.collectives import CLI_PSUM_MODES, AxisSpan
from repro_torch.core.cost import Cost, counting
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.steps import (build_prefill, build_serve_step,
                                        build_train_step)
from repro_torch.parallel.tp import ParallelCtx


def rank_ctx(mesh: RankMesh, psum_mode: str = "xla_spmd",
             plan=None) -> ParallelCtx:
    """Rank 0's context on ``mesh``: an :class:`AxisSpan` on each axis of
    span > 1, ``None`` elsewhere."""
    def span(axis):
        n = mesh.span(axis)
        return AxisSpan(n) if n > 1 else None
    return ParallelCtx(group=span("model"), psum_mode=psum_mode, plan=plan,
                       data_group=span("data"), pod_group=span("pod"))


def _rows(shape: ShapeConfig, hosts: int) -> tuple[int, bool]:
    """(the rows of a serve or prefill ``shape`` batch each data-parallel
    host takes, whether they are the hosts' cut of it): where the hosts
    do not divide the batch (``long_500k``'s one row), every host takes
    all of it, replicated over ``(pod, data)``, as the reference's
    ``fit_specs`` drops the tokens' data axis."""
    if shape.global_batch % hosts:
        return shape.global_batch, False
    return shape.global_batch // hosts, True


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh: RankMesh,
               pctx: Optional[ParallelCtx] = None) -> Cost:
    """Count one step of rank 0 of ``mesh`` (see the module docstring);
    ``pctx`` defaults to :func:`rank_ctx`'s.  The train step runs the
    default schedule: its learning rate changes no count."""
    pctx = pctx if pctx is not None else rank_ctx(mesh)
    model = get_model(cfg)
    world = (mesh.span("data"), mesh.span("model"))
    hosts = mesh.span("pod") * world[0]
    specs = model.input_specs(shape)
    if shape.kind == "train":
        ts = build_train_step(model, shape, pctx)
        params = shard_params(model.init(device="meta", masters=True), cfg,
                              (0, 0), world)
        opt = adamw_init(params)
        batch = {k: v.clone() for k, v in ts.rows(specs).items()}
        with counting() as cost:
            cost.arguments(params, opt, batch)
            cost.outputs(ts.fn(params, opt, batch))
        return cost
    n, cut = _rows(shape, hosts)
    batch = {k: v[:n].clone() for k, v in specs.items()}
    weights, dims = fsdp.serving_params(model.init(device="meta"), cfg, pctx,
                                        pctx.data_group)
    data_group = pctx.data_group
    if not cut:
        # replicated rows are routed as one host's (an MoE layer's group)
        pctx = dataclasses.replace(pctx, data_group=None, pod_group=None)
    if shape.kind == "prefill":
        fn, extra = build_prefill(model, pctx).fn, ()
    else:
        fn = build_serve_step(model, pctx).fn
        extra = (model.init_cache(n, shape.seq_len, device="meta",
                                  world=world[1]),)
    with counting() as cost:
        cost.arguments(weights, batch, *extra)
        with fsdp.serving(weights, dims, data_group) as w:
            cost.outputs(fn(w, batch, *extra))
    return cost


def _cost_point(cfg: ModelConfig, shape: ShapeConfig, mesh: RankMesh,
                pctx: ParallelCtx) -> dict:
    """flops/bytes/collective bytes of one traced step."""
    c = trace_step(cfg, shape, mesh, pctx)
    coll = c.collective_bytes()
    return {"flops": c.flops, "bytes": c.bytes, "coll": coll["total"],
            "coll_by_kind": coll}


def roofline_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: RankMesh,
                   pctx: ParallelCtx) -> dict:
    """Per-unit marginal costs from traces at 1 and 2 repeating units
    (:func:`~repro_torch.configs.base.depth_scaled`), extrapolated to full
    depth, as the reference's."""
    units = depth_units(cfg)
    m1 = _cost_point(depth_scaled(cfg, 1), shape, mesh, pctx)
    m2 = _cost_point(depth_scaled(cfg, 2), shape, mesh, pctx)
    out = {}
    for key in ("flops", "bytes", "coll"):
        marginal = max(m2[key] - m1[key], 0)
        fixed = max(m1[key] - marginal, 0)
        out[key] = fixed + marginal * units
        out[f"{key}_per_unit"] = marginal
        out[f"{key}_fixed"] = fixed
    out["units"] = units
    out["coll_by_kind_u2"] = m2["coll_by_kind"]
    return out


def run_cell(arch: str, shape_name: str, mesh: RankMesh,
             psum_mode: str = "xla_spmd", verbose: bool = True,
             roofline: bool = True, plan_dir=None,
             use_plan: bool = True) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    # One plan per cell through the shared launch helper (the train and
    # serve launchers' store keys); only --psum-mode auto plans.
    from repro_torch.plan import plan_for_launch
    plan, plan_info = plan_for_launch(cfg, mesh.pairs, shape, psum_mode,
                                      plan_dir=plan_dir, enabled=use_plan,
                                      verbose=False)
    pctx = rank_ctx(mesh, psum_mode, plan)

    t0 = time.perf_counter()
    cost = trace_step(cfg, shape, mesh, pctx)
    t_trace = time.perf_counter() - t0

    result = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": dict(mesh.pairs), "devices": mesh.size,
        "psum_mode": psum_mode,
        "trace_s": round(t_trace, 1),
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.collective_bytes(),
        "memory": cost.memory(),
        "kernels": {name: dict(k) for name, k in sorted(cost.kernels.items())},
    }
    if plan_info is not None:
        result["plan"] = plan_info
    if roofline:
        result["roofline"] = roofline_costs(cfg, shape, mesh, pctx)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh.size}dev "
              f"({psum_mode}): trace {t_trace:.1f}s")
        if plan_info is not None:
            src = "warm store" if plan_info["from_store"] else "built"
            print(f"  plan: {plan_info['key']} ({src}, "
                  f"{plan_info['collective_sims']} collective sims, "
                  f"{plan_info['plan_s']}s) "
                  f"modes={plan_info['psum']['modes']}")
        print(f"  flops={cost.flops:.3e} bytes={cost.bytes:.3e} "
              f"coll={cost.collective_bytes()['total']:.3e} "
              f"launches={cost.launches}")
        print(f"  memory: args={result['memory']['argument_bytes']:.3e} "
              f"temp={result['memory']['temp_bytes']:.3e} "
              f"peak={result['memory']['peak_bytes']:.3e}")
        if roofline:
            r = result["roofline"]
            print(f"  roofline/dev: flops={r['flops']:.3e} "
                  f"bytes={r['bytes']:.3e} coll={r['coll']:.3e} "
                  f"(units={r['units']})")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    from repro_torch.plan import add_plan_cli_args
    ap.add_argument("--psum-mode", default="xla_spmd",
                    choices=CLI_PSUM_MODES)
    add_plan_cli_args(ap)
    ap.add_argument("--no-roofline", action="store_true",
                    help="skip the two shallow traces")
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = [make_production_mesh(multi_pod=False),
                  make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]

    if args.all:
        cells = [(arch, sname) for arch, cfg in ARCHS.items()
                 for sname, shp in SHAPES.items()
                 if shape_applicable(cfg, shp)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    results, failures = [], []
    done = set()
    if args.out and args.resume:
        try:
            with open(args.out) as f:
                prev = json.load(f)
            results = prev.get("results", [])
            done = {(r["arch"], r["shape"], tuple(sorted(r["mesh"].items())))
                    for r in results}
            print(f"[dryrun] resuming: {len(done)} cells already done")
        except FileNotFoundError:
            pass

    def flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"results": results, "failures": failures}, f,
                          indent=1)

    t0 = time.perf_counter()
    for mesh in meshes:
        for arch, sname in cells:
            key = (arch, sname, tuple(sorted(dict(mesh.pairs).items())))
            if key in done:
                continue
            try:
                multi = mesh.span("pod") > 1
                results.append(run_cell(arch, sname, mesh, args.psum_mode,
                                        roofline=not (args.no_roofline
                                                      or multi),
                                        plan_dir=args.plan_dir,
                                        use_plan=not args.no_plan))
            except Exception as e:               # noqa: BLE001
                if not isinstance(e, ValueError):
                    traceback.print_exc()
                failures.append({"arch": arch, "shape": sname,
                                 "mesh": dict(mesh.pairs),
                                 "error": f"{type(e).__name__}: {e}"})
                print(f"[dryrun] {arch} x {sname} x {mesh.size}dev: "
                      f"{failures[-1]['error'][:200]}")
            flush()

    if args.out:
        print(f"wrote {args.out}")
    print(f"\n{len(results)} cells OK, {len(failures)} failed in "
          f"{time.perf_counter() - t0:.1f} s")
    for f in failures:
        print(f"  FAIL {f['arch']} x {f['shape']} x {f['mesh']}: "
              f"{f['error'][:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
