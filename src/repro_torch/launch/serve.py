"""Serving driver (counterpart of ``repro.launch.serve``).

The default path seats every prompt through the engine
(:mod:`repro_torch.serve.engine`): chunked batched prefill, then per-slot
paged decode.  ``--legacy-loop`` keeps the pre-engine behaviour (one batch,
one decode step per prompt token) as the reference the engine's tokens are
held against.  Both run on the GPU unless ``--device cpu`` is given.

``--model-parallel N`` serves through tensor parallelism over N ranks, one
process each (NCCL on N cards, or gloo with ``--device cpu``); every rank
runs the same schedule on its shard and rank 0 prints the report.
``--ranks R`` (default ``--model-parallel``) serves on the reference's
``make_host_mesh(R, model_parallel)``, ``(data R/M, model M)``: each data
rank holds its share of the slots (the legacy loop: of the batch rows) and
its FSDP pieces of the weights, gathered layer by layer each step, or,
with ``--serve-replicated-params``, its model shard gathered once
(:mod:`repro_torch.serve.engine`); the tokens are gathered over ``data``.
``--psum-mode`` picks how the row-parallel partial sums are accumulated
(:data:`repro_torch.core.collectives.CLI_PSUM_MODES`).  Under ``auto`` the
engine carries one :class:`~repro_torch.plan.ExecutionPlan` a phase
(prefill and decode, from :func:`~repro_torch.plan.plan_for_launch`, kept
in ``--plan-dir``): its psum table answers the ``auto`` sites and its
tiles are the projections' ``ina_matmul`` launches.  ``--no-plan`` keeps
``auto`` planless (each site resolved by the cost model as it runs).

Examples (one H100, at the published widths):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --slots 2 --prompt-len 128 --gen 32 --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --slots 2 --prompt-len 128 --gen 32 --prefill-chunk 64 \\
      --psum-mode auto --plan-dir build/plans
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --batch 4 --slots 2 --prompt-len 64 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --batch 4 --slots 2 --prompt-len 64 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 4 --slots 2 --prompt-len 64 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-11b --batch 2 --prompt-len 16 --gen 8
(the ssm, moe, mla_moe and hybrid families seat prompts token by token;
encdec and vlm take media, which no engine request carries, so they run
the legacy loop on media of ones, as the reference's launcher does;
``--layers N`` cuts the depth, as llama4-scout's 48 layers need on one
card), and on the CPU, two gloo ranks of the reduced qwen2, and of the
reduced rwkv6-7b, deepseek-v2-lite and whisper-medium (every family takes
``--model-parallel``; the media families run the legacy loop on every
rank):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --model-parallel 2 --psum-mode ina_ring --check
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --reduced --device cpu --batch 3 \\
      --slots 2 --prompt-len 6 --gen 5 --block-size 4 --model-parallel 4 \\
      --psum-mode auto --check
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --reduced --device cpu --batch 3 --prompt-len 6 --gen 5 \\
      --model-parallel 2 --psum-mode ina_ring
and four gloo ranks as ``(data 2, model 2)``:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --ranks 4 --model-parallel 2 --slots 4 \\
      --batch 6 --prompt-len 6 --gen 5 --block-size 4 --check
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import sys
import time

import torch

from repro_torch import _device
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.launch import mesh
from repro_torch.models import vision
from repro_torch.models.api import MEDIA_FAMILIES, get_model, media_ones
from repro_torch.parallel import fsdp
from repro_torch.parallel.fsdp import serving_params
from repro_torch.parallel.steps import build_serve_step
from repro_torch.parallel.tp import Hosts, ParallelCtx
from repro_torch.plan import add_plan_cli_args, plan_for_launch
from repro_torch.plan.builder import MODEL_AXIS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths as "
                         "the config has them)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests (legacy: batch rows)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--psum-mode", default="ina", choices=CLI_PSUM_MODES,
                    help="how the row-parallel partial sums are accumulated")
    add_plan_cli_args(ap)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel ranks, one process each")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the (data, model) mesh, one process "
                         "each (default: --model-parallel)")
    ap.add_argument("--serve-replicated-params", action="store_true",
                    help="each data rank holds its model shard whole, "
                         "gathered once, not its FSDP pieces")
    # engine path
    ap.add_argument("--slots", type=int, default=None,
                    help="continuous-batching slots (default: --batch)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="tokens per batched prefill chunk; no effect for a "
                         "family without a batched prefill (ssm, moe, "
                         "mla_moe, hybrid), whose prompts are seated token "
                         "by token")
    ap.add_argument("--no-batched-prefill", action="store_true",
                    help="prefill via the per-token decode loop")
    ap.add_argument("--check", action="store_true",
                    help="verify paged==monolithic cache on every retire")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="pre-engine path: one batch, per-token prefill")
    return ap


def make_prompts(cfg, batch: int, prompt_len: int) -> torch.Tensor:
    """The seeded prompt block both paths share (CPU generator, seed 7)."""
    gen = torch.Generator().manual_seed(7)
    return torch.randint(3, cfg.vocab, (batch, prompt_len), generator=gen)


def _params(args, cfg, params):
    """The caller's weights, or random ones from a generator seeded with 0."""
    if params is not None:
        return params
    return get_model(cfg).init(device=_device.resolve(args.device))


def launch_plans(args, cfg, world: int = 1) -> dict:
    """The plans of an engine launch over ``world`` ranks, one a phase, at
    the mesh ``(("model", world),)``: ``{"decode": (plan, info),
    "prefill": (plan, info)}`` as :func:`~repro_torch.plan.plan_for_launch`
    returns them, each ``(None, None)`` unless ``--psum-mode auto`` without
    ``--no-plan``.  The decode plan's tiles are at the slots' M; the
    prefill plan's at the reference's 256 tokens (a prefill chunk's M is
    not planned)."""
    max_seq = args.prompt_len + args.gen + 1
    slots = args.slots or args.batch
    mesh = ((MODEL_AXIS, world),)
    return {kind: plan_for_launch(cfg, mesh, ShapeConfig("cli", max_seq,
                                                         slots, kind),
                                  args.psum_mode, plan_dir=args.plan_dir,
                                  enabled=not args.no_plan)
            for kind in ("decode", "prefill")}


def run_engine(args, cfg, params=None, group=None, data_group=None,
               pod_group=None):
    """Serve ``--batch`` requests through the engine on this rank of the
    model ``group`` and of ``data_group`` and ``pod_group`` (``None``:
    span 1); returns its report."""
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import ServingEngine

    max_seq = args.prompt_len + args.gen + 1
    slots = args.slots or args.batch
    plans = launch_plans(args, cfg, ParallelCtx(group=group).world)
    block = args.block_size
    if max_seq % block:
        block = 1 << max(0, (max_seq & -max_seq).bit_length() - 1)
        block = min(block, args.block_size)
        print(f"[serve] block size {args.block_size} does not divide "
              f"max_seq {max_seq}; using {block}")
    engine = ServingEngine(
        cfg, params=_params(args, cfg, params), device=args.device,
        slots=slots, max_seq=max_seq, block_size=block,
        prefill_chunk=args.prefill_chunk, psum_mode=args.psum_mode,
        prefill_plan=plans["prefill"][0], decode_plan=plans["decode"][0],
        batched_prefill=not args.no_batched_prefill, check=args.check,
        group=group, data_group=data_group, pod_group=pod_group,
        serve_replicated_params=args.serve_replicated_params)

    prompts = make_prompts(cfg, args.batch, args.prompt_len)
    requests = [
        Request(rid=f"req{i}", prompt_len=args.prompt_len,
                max_new=args.gen + 1, prompt=tuple(prompts[i].tolist()))
        for i in range(args.batch)]

    t0 = time.perf_counter()
    report = engine.run(requests)
    dt = time.perf_counter() - t0
    total = sum(len(r["tokens"]) for r in report.requests)
    print(f"[serve] engine: {args.batch} requests on {slots} slots, "
          f"{report.iterations} iterations ({report.prefill_chunks} prefill "
          f"chunks, {report.decode_steps} decode steps), {total} tokens in "
          f"{dt * 1e3:.1f} ms ({total / dt:.1f} tok/s); prefill "
          f"{report.prefill_ms:.1f} ms, decode {report.decode_ms:.1f} ms")
    by_rid = report.tokens()
    print(f"[serve] sample req0: {by_rid['req0']}")
    for rid, toks in by_rid.items():
        if not all(0 <= t < cfg.vocab for t in toks):
            raise RuntimeError(f"{rid}: token out of the vocabulary")
    return report


def run_legacy(args, cfg, params=None, group=None, *, rows=None,
               max_seq=None, data_group=None, pod_group=None) -> dict:
    """The pre-engine loop: one fixed batch, per-token prefill steps, on
    this rank of the model ``group`` (``None``: one rank).  ``rows`` picks
    the requests (rows of the prompt block) that form the batch, all of
    them by default; ``max_seq`` the cache's positions, prompt + gen by
    default.  On the data axis (``data_group``, ``pod_group``) host ``h``
    of ``H`` runs rows ``[h B/H, (h+1) B/H)`` of the batch (and of the
    media) on its FSDP pieces (:func:`~repro_torch.parallel.fsdp.
    serving_params`), and the hosts' tokens, margins and first-token
    logits are gathered back in row order.  An MoE layer routes the
    hosts' rows as the one group of the batch, as the reference's serve
    step does over its global batch.

    The encdec and vlm families get media of ones [B, M, D] in the compute
    dtype, as the reference's launcher gives them, in every step's batch;
    vlm's cross-attention K/V over it are written into the cache first
    (:func:`~repro_torch.models.vision.prefill_media_kv`).

    Returns the tokens [B, gen+1] (the first generated token, then ``gen``
    greedy continuations), each step's top-2 logit margin [B, gen+1], and
    the first-token logits [B, V]."""
    model = get_model(cfg)
    dev = _device.resolve(args.device)
    prompts = make_prompts(cfg, args.batch, args.prompt_len)
    if rows is not None:
        prompts = prompts[list(rows)]
    hosts = Hosts(data_group, pod_group)
    # rows the hosts do not divide are replicated over them (the
    # reference's fit_specs drops the batch's data axis): every host runs
    # every row, routes them as one host, and gathers nothing
    cut = prompts.shape[0] % hosts.count == 0
    if cut:
        n = prompts.shape[0] // hosts.count
        prompts = prompts[hosts.index * n:(hosts.index + 1) * n]
    gather = hosts.all_gather if cut else (lambda t: t)
    world = ParallelCtx(group=group).world
    plan, _ = plan_for_launch(
        cfg, ((MODEL_AXIS, world),),
        ShapeConfig("cli", max_seq or args.prompt_len + args.gen,
                    prompts.shape[0], "decode"),
        args.psum_mode, plan_dir=args.plan_dir, enabled=not args.no_plan)
    # the rows are the hosts' cut of one batch: an MoE layer routes them
    # as one group over the data and pod groups (replicated rows: as one
    # host's)
    pctx = ParallelCtx(group=group, psum_mode=args.psum_mode, plan=plan,
                       data_group=data_group if cut else None,
                       pod_group=pod_group if cut else None,
                       serve_replicated_params=args.serve_replicated_params)
    params, dims = serving_params(_params(args, cfg, params), cfg, pctx,
                                  data_group)
    step = build_serve_step(model, pctx)

    def run(batch, cache):
        with fsdp.serving(params, dims, data_group) as held:
            return step.fn(held, batch, cache)
    prompts = prompts.to(dev)
    batch = prompts.shape[0]
    cache = model.init_cache(batch, max_seq or args.prompt_len + args.gen,
                             device=dev, world=pctx.world, rank=pctx.rank)
    extra = media_ones(cfg, batch, dev)
    if cfg.family == "vlm":
        with fsdp.serving(params, dims, data_group) as held:
            cache = vision.prefill_media_kv(held, cfg, extra["media"], cache,
                                            pctx)

    def margin(logits):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        return top2[:, 0] - top2[:, 1]

    # prefill token-by-token through the serve step (keeps one artifact)
    t0 = time.perf_counter()
    for pos in range(args.prompt_len):
        nxt, cache, logits = run(
            {"tokens": prompts[:, pos:pos + 1], "pos": pos, **extra}, cache)
    tokens, margins, first_logits = [nxt], [margin(logits)], logits
    nxt.tolist()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"[serve] prefill {args.prompt_len} steps {prefill_ms:.1f} ms")

    t0 = time.perf_counter()
    for i in range(args.gen):
        nxt, cache, logits = run(
            {"tokens": nxt[:, None], "pos": args.prompt_len + i, **extra},
            cache)
        tokens.append(nxt)
        margins.append(margin(logits))
    out = gather(torch.stack(tokens, dim=1)).cpu()
    margins = gather(torch.stack(margins, dim=1))
    first_logits = gather(first_logits)
    batch = out.shape[0]
    dt = time.perf_counter() - t0
    print(f"[serve] generated {args.gen} x {batch} tokens in "
          f"{dt * 1e3:.1f} ms ({args.gen * batch / dt:.1f} tok/s)")
    print(f"[serve] sample row: {out[0].tolist()}")
    if out.shape != (batch, args.gen + 1) or not (
            bool((out >= 0).all()) and bool((out < cfg.vocab).all())):
        raise RuntimeError(f"bad legacy output {tuple(out.shape)}")
    return {"tokens": out, "margins": margins.cpu(),
            "first_logits": first_logits, "prefill_ms": prefill_ms,
            "decode_ms": dt * 1e3}


def config(args):
    """The model config ``args`` name: ``--arch``, ``--reduced``,
    ``--layers``."""
    cfg = ARCHS[args.arch]
    cfg = cfg.reduced() if args.reduced else cfg
    return cfg if args.layers is None else \
        dataclasses.replace(cfg, n_layers=args.layers)


def _legacy(args, cfg) -> bool:
    return args.legacy_loop or cfg.family in MEDIA_FAMILIES


def _serve(args, cfg, group=None, params=None, data_group=None,
           pod_group=None):
    """Run the path ``args`` asks for (the legacy loop for the families
    that take media) on ``params`` (the full weights; seeded random ones
    by default); its tokens, one row a request."""
    if _legacy(args, cfg):
        if not args.legacy_loop:
            print(f"[serve] family {cfg.family!r} needs media plumbing; "
                  "running the legacy loop")
        return run_legacy(args, cfg, params, group, data_group=data_group,
                          pod_group=pod_group)["tokens"].tolist()
    tokens = run_engine(args, cfg, params, group, data_group,
                        pod_group).tokens()
    return [tokens[f"req{i}"] for i in range(args.batch)]


def serve_rank(rank, world, group, device, argv, params=None, groups=None):
    """One rank of the launch's mesh: the same requests on its shard of
    ``params`` (the full weights; seeded random ones by default).
    ``groups`` (``{"pod", "data", "model"}``, as
    :meth:`~repro_torch.launch.mesh.RankMesh.groups` gives them) default to
    those of ``make_host_mesh(world, --model-parallel)``, the model line a
    whole world of ``group`` where ``data`` has span 1.  Rank 0 prints; the
    others' prints are dropped."""
    args = build_parser().parse_args(argv)
    args.device = str(device)
    if groups is None:
        ranks = mesh.make_host_mesh(world, args.model_parallel)
        groups = ranks.groups(rank) if ranks.span("data") > 1 else \
            {"pod": None, "data": None, "model": group}
    quiet = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with quiet:
        return _serve(args, config(args), groups["model"], params,
                      groups["data"], groups["pod"])


def spawn_ranks(fn, world: int, device: str, launches, *args) -> list:
    """Each rank's ``fn(rank, world, group, device, *args)`` over ``world``
    spawned ranks, the plans of every ``(args, cfg)`` of ``launches`` built
    first in this process, so that every rank loads them warm.  Raises
    unless every rank returns the same."""
    for launch_args, cfg in launches:
        launch_plans(launch_args, cfg, launch_args.model_parallel)
    results = mesh.spawn(fn, world, device, args=args)
    if any(r != results[0] for r in results):
        raise AssertionError(f"ranks disagree on the tokens: {results}")
    return results


def main(argv=None) -> list:
    """Serve as ``argv`` asks; returns the tokens, one row a request (the
    same on every rank)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = config(args)
    if args.ranks is not None and args.ranks < args.model_parallel:
        raise ValueError(f"--ranks {args.ranks} is fewer than "
                         f"--model-parallel {args.model_parallel}")
    ranks = mesh.make_host_mesh(args.ranks or args.model_parallel,
                                args.model_parallel)
    world, hosts = ranks.size, ranks.span("data")
    # refuse what the ranks would, before any starts
    rows = args.batch if _legacy(args, cfg) else (args.slots or args.batch)
    if rows % hosts:
        raise ValueError(f"{rows} {'rows' if _legacy(args, cfg) else 'slots'}"
                         f" do not divide over the {hosts} data-parallel "
                         f"ranks of {ranks.pairs}")
    if world == 1:
        return _serve(args, cfg)
    dev = _device.resolve(args.device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks need {world} CUDA devices; "
                           f"{torch.cuda.device_count()} present")
    tokens = spawn_ranks(serve_rank, world, dev.type, [(args, cfg)], argv)
    print(f"[serve] {world} ranks {ranks.pairs} ({args.psum_mode}) agree on "
          f"every token")
    return tokens[0]


if __name__ == "__main__":
    main()
