"""Training entry point (counterpart of ``repro.launch.train``).

Trains a model of any family: float32 masters, compute in the config's
dtype, every layer checkpointed (zamba2's and the vlm's by group, as the
reference's scan bodies are), the projections and their gradients on the
INA matmul, RWKV6's WKV on the wkv6 kernel (its gradient the VJP of its
plain version), AdamW with a cosine schedule, the synthetic token
pipeline, and the preemption-safe loop with retries and keep-k
checkpoints (``runtime.fault_tolerance.run_training``).  The encdec and
vlm families' batches also hold ``media`` of ones [B, M, D] in the
compute dtype, as ``launch.serve`` gives them, this host's rows of it
(:meth:`~repro_torch.parallel.steps.TrainStep.rows`): the reference's
``build_train_step`` takes media (``Model.batch_specs``), but its train
launcher feeds the token pipeline alone, so its loss would fail on
``batch["media"]`` for these families.  ``--layers N`` cuts the depth
(whisper's decoder; its encoder keeps its own), widths as published, a
multiple of a group for zamba2 (``shared_attn_every``) and the vlm
(``cross_attn_every``); a resume needs the same N.  A second run into
the same ``--ckpt-dir`` resumes after the newest checkpoint.  Under
``--psum-mode auto`` the step carries the train-phase
:class:`~repro_torch.plan.ExecutionPlan` (``--plan-dir``, ``--no-plan``),
as the reference's does.  It runs on the GPU unless ``--device cpu`` is
given, and exits non-zero when the loss did not fall.

The ranks form the reference's host mesh, ``(ranks // mp, mp)`` over
``("data", "model")`` (``launch.mesh.make_host_mesh``), one process each
(NCCL on the cards; gloo on the CPU under ``--device cpu``): on the card
``ranks`` is the card count, on the CPU ``--ranks N`` (the counterpart of
XLA's forced host device count; default ``--model-parallel``, so
``--model-parallel N`` alone trains tensor-parallel on N ranks).  Each rank
cuts the seeded masters to its piece (its model shard, cut again over
``data``: FSDP), builds its own AdamW state, trains on its rows of the
global batch and loads the train-phase plan at the mesh's ``(axis, span)``
pairs, built once before the ranks start.  ``--production-mesh`` takes the
reference's 16 x 16 mesh, and raises before any rank starts where fewer
than its 256 ranks exist.  The checkpoints hold the full logical state,
so a run resumes at any mesh whose model span divides the heads.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 8 --batch 4 --seq 1024 --ckpt-dir /tmp/ck --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 6 --batch 2 --seq 32 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 3 --batch 4 --seq 32 --lr 1e-2 \\
      --ckpt-dir /tmp/dp --ckpt-every 2 --ranks 4 --model-parallel 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --layers 8 --steps 4 --batch 2 --seq 1024 --ckpt-dir /tmp/rw \\
      --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
      --layers 12 --steps 4 --batch 2 --seq 1024 --ckpt-dir /tmp/za \\
      --ckpt-every 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import mesh
from repro_torch.models.api import get_model, media_ones
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.steps import build_train_step
from repro_torch.parallel.tp import ParallelCtx
from repro_torch.plan import add_plan_cli_args, plan_for_launch
from repro_torch.runtime.fault_tolerance import (FTConfig,
                                                 ShardedCheckpointManager,
                                                 run_training)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths as "
                         "published)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--psum-mode", default="ina", choices=CLI_PSUM_MODES)
    add_plan_cli_args(ap)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks under --device cpu (default: "
                         "--model-parallel); on the card, the card count")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16x16 mesh (needs 256 ranks)")
    return ap


def run(args, on_step: Optional[Callable] = None) -> dict:
    """Train as ``args`` say; ``on_step(step, metrics, seconds)`` is called
    after each step.  Returns the final ``state`` (params, opt), the
    ``steps`` run and their ``losses``, and the straggler events.

    A mesh of more than one rank (:func:`rank_mesh`) spawns its ranks
    (``launch.mesh.spawn``: NCCL on the cards, gloo where ``--device cpu``
    asks for the CPU), each training its piece; it returns rank 0's steps
    and losses, without a state (each rank's lived in its own process),
    and takes no ``on_step``."""
    cfg = _config(args)
    ranks = rank_mesh(args)
    if ranks.size == 1:
        return _train(args, cfg, ranks, on_step=on_step)
    if on_step is not None:
        raise ValueError("on_step is called at one rank only: on a mesh of "
                         "more ranks the steps run in the ranks' processes")
    # refuse what the ranks would, before any starts: every model rank's
    # cut of the parameters (on ``meta``: the head cut of each rank, even
    # or not, and every dim the model axis must divide)
    world = (ranks.span("data"), ranks.span("model"))
    meta = get_model(cfg).init(device="meta", masters=True)
    for m in range(world[1]):
        shard_params(meta, cfg, (0, m), world)
    hosts = ranks.span("pod") * ranks.span("data")
    if args.batch % hosts:
        raise ValueError(f"--batch {args.batch} does not divide over the "
                         f"{hosts} data-parallel ranks of {ranks.pairs}")
    # build the plan once, so that every rank loads it warm
    _plan(args, cfg, ranks)
    dev = _device.resolve(args.device)
    return mesh.spawn(train_rank, ranks.size, dev.type,
                      args=(args, ranks))[0]


def rank_mesh(args) -> mesh.RankMesh:
    """The launch's rank mesh: ``make_host_mesh(ranks, --model-parallel)``
    with ``ranks`` the card count on the card and ``--ranks`` (default
    ``--model-parallel``) on the CPU, or ``make_production_mesh()`` under
    ``--production-mesh``.  Raises where the ranks are too few."""
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        if args.ranks is not None:
            raise ValueError("--ranks sets the CPU's rank count; on the card "
                             "it is the card count")
        ranks, what = torch.cuda.device_count(), "CUDA devices"
    else:
        ranks = args.model_parallel if args.ranks is None else args.ranks
        what = "ranks (--ranks)"
    if args.production_mesh:
        prod = mesh.make_production_mesh()
        if ranks < prod.size:
            raise RuntimeError(f"--production-mesh is the reference's "
                               f"{' x '.join(map(str, prod.shape))} mesh over "
                               f"{prod.axes}: it needs {prod.size} ranks; "
                               f"{ranks} {what} present")
        return prod
    if args.model_parallel > ranks:
        raise RuntimeError(f"--model-parallel {args.model_parallel} needs "
                           f"{args.model_parallel} {what}; {ranks} present"
                           + (" (no gloo fallback on the card)"
                              if dev.type == "cuda" else ""))
    return mesh.make_host_mesh(ranks, args.model_parallel)


def train_rank(rank, world, group, device, args, ranks) -> dict:
    """One rank of the mesh ``ranks``: its piece of the seeded masters,
    its own AdamW state, its rows of each batch, and the ranks' shared
    checkpoints.  Rank 0 prints; the others' prints are dropped."""
    args = argparse.Namespace(**{**vars(args), "device": str(device)})
    quiet = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with quiet:
        out = _train(args, _config(args), ranks, groups=ranks.groups(rank))
    del out["state"]
    return out


def _config(args):
    cfg = ARCHS[args.arch]
    cfg = cfg.reduced() if args.reduced else cfg
    if args.layers is None:
        return cfg
    group = cfg.shared_attn_every or cfg.cross_attn_every
    if group and args.layers % group:
        raise ValueError(f"--layers {args.layers}: {cfg.name} runs groups of "
                         f"{group} layers")
    return dataclasses.replace(cfg, n_layers=args.layers)


def _shape(args) -> ShapeConfig:
    return ShapeConfig("cli", args.seq, args.batch, "train")


def _plan(args, cfg, ranks: mesh.RankMesh):
    plan, _ = plan_for_launch(cfg, ranks.pairs, _shape(args),
                              args.psum_mode, plan_dir=args.plan_dir,
                              enabled=not args.no_plan)
    return plan


def _train(args, cfg, ranks: mesh.RankMesh, groups: Optional[dict] = None,
           on_step: Optional[Callable] = None) -> dict:
    dev = _device.resolve(args.device)
    groups = groups or {}
    at = ranks.coords(dist.get_rank() if groups else 0)
    world = ranks.size
    shards = (ranks.span("data"), ranks.span("model"))
    model = get_model(cfg)
    pctx = ParallelCtx(group=groups.get("model"), psum_mode=args.psum_mode,
                       plan=_plan(args, cfg, ranks),
                       data_group=groups.get("data"),
                       pod_group=groups.get("pod"))
    ts = build_train_step(model, _shape(args), pctx, base_lr=args.lr,
                          warmup=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)
    print(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}) "
          f"mesh={dict(ranks.pairs)} psum={args.psum_mode} device={dev}",
          flush=True)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    media = ts.rows(media_ones(cfg, args.batch, dev))

    def step_fn(state, batch):
        params, opt = state
        batch = {k: v.to(dev) for k, v in batch.items()}
        params, opt, stats = ts.fn(params, opt, batch)
        return (params, opt), stats

    steps, losses = [], []

    def on_metrics(step, metrics, dt):
        loss = float(metrics["loss"])
        steps.append(step)
        losses.append(loss)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}  {dt * 1e3:6.0f} ms",
                  flush=True)
        if on_step:
            on_step(step, metrics, dt)

    # a rank cannot retry a step alone: the others' collectives moved on
    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                  **({"max_step_retries": 0} if world > 1 else {}))
    mgr = None if world == 1 else ShardedCheckpointManager(
        args.ckpt_dir, cfg, dist.group.WORLD, dev, keep=ft.keep,
        every=ft.ckpt_every, world=shards)
    # run_training holds the only reference to the initial state, so a
    # restored one replaces it in device memory instead of joining it
    state, last, stragglers = run_training(
        step_fn, initial_state(model, dev, (at["data"], at["model"]), shards),
        lambda step: {**pipe.host_batch(step, ts.host, ts.hosts), **media},
        ft=ft,
        num_steps=args.steps, on_metrics=on_metrics, mgr=mgr)
    if not losses:
        print(f"[train] nothing to do: the checkpoint under {args.ckpt_dir} "
              f"is at step {last - 1} of {args.steps}", flush=True)
    else:
        print(f"[train] done at step {last}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; stragglers={len(stragglers)}", flush=True)
        if len(losses) > 1 and not losses[-1] < losses[0]:
            raise RuntimeError(f"loss did not improve: {losses[0]} -> "
                               f"{losses[-1]}")
    return {"state": state, "steps": steps, "losses": losses,
            "last": last, "stragglers": stragglers}


def initial_state(model, dev, rank=0, world=1) -> tuple:
    """(float32 masters seeded with 0, zero AdamW state) on ``dev``: on more
    than one rank, ``rank``'s piece of the masters of ``world`` (as
    ``shard_params`` takes them: the model axis, or ``(data, model)``)
    and its own state."""
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev, masters=True)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {n_params / 1e6:.1f}M params", flush=True)
    params = shard_params(params, model.cfg, rank, world)
    return params, adamw_init(params)


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
