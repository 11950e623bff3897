"""Train, serve, prefill and forward steps (counterpart of
``repro.parallel.steps``).

The reference builds jitted, sharded artifacts; PyTorch runs eagerly, so
each builder here returns the plain callable in the same kind of record.
The train step differentiates the loss with ``torch.autograd.grad``: the
projections' gradients run on the INA matmul (``kernels.ina_matmul.
InaMatmul``), and each layer is checkpointed and recomputed.
Tensor parallelism reaches the model through ``pctx``: its process group
and psum mode (:class:`repro_torch.parallel.tp.ParallelCtx`), with the
parameters a rank's shards.  Greedy decoding takes the first maximal
logit, as ``jnp.argmax``.

Every builder accepts ``plan`` (a :class:`repro_torch.plan.ExecutionPlan`):
it rides the step's ``ParallelCtx`` (:func:`_with_plan`), so ``auto`` psum
sites resolve from its table and the projections launch its tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import Model, cache_batch_axes
from repro_torch.models.layers import STACKED
from repro_torch.optim.adamw import adamw_update, cosine_schedule, tree_map
from repro_torch.parallel.tp import ParallelCtx


def _with_plan(pctx: Optional[ParallelCtx], plan) -> Optional[ParallelCtx]:
    """The step's ParallelCtx, carrying ``plan`` when one was supplied.

    An explicit ``pctx.plan`` wins (the caller already decided); otherwise
    the plan is attached so auto psum sites and projections read it."""
    if plan is None:
        return pctx
    pctx = pctx if pctx is not None else ParallelCtx()
    if pctx.plan is None:
        pctx = dataclasses.replace(pctx, plan=plan)
    return pctx


@dataclasses.dataclass
class TrainStep:
    """``fn(params, opt, batch) -> (params, opt, stats)`` with ``batch =
    {"tokens", "labels"}`` of ``shape`` and ``stats = {"loss",
    "grad_norm", "lr"}`` (float32 scalars on the device).  ``params``
    (float32 masters, ``Model.init(masters=True)``) and ``opt`` are
    updated in place and returned."""
    fn: Callable
    shape: ShapeConfig


def _grad_leaves(params: dict) -> tuple[dict, list]:
    """(a tree the loss is differentiated through, its leaves in order).
    Each leaf is a detached alias of the master that requires a gradient;
    a stacked ``[L, ...]`` leaf becomes its L layer slices, so autograd
    gives each layer its own gradient, not L full-size ``select``
    gradients summed into one."""
    leaves = []

    def leaf(p):
        leaves.append(p.detach().requires_grad_())
        return leaves[-1]

    def per_layer(p):
        return [leaf(p[i]) for i in range(p.shape[0])]

    work = {k: tree_map(per_layer if k in STACKED else leaf, v)
            for k, v in params.items()}
    return work, leaves


def loss_and_grads(model: Model, params: dict, batch: dict,
                   pctx: Optional[ParallelCtx] = None):
    """(loss, grads): ``model.loss`` and ``torch.autograd.grad`` of it, the
    gradients in ``params``' structure (a stacked leaf's restacked) and
    dtypes."""
    work, leaves = _grad_leaves(params)
    loss = model.loss(work, batch, pctx)
    grads = list(torch.autograd.grad(loss, leaves))
    grads.reverse()

    def take(p):
        return grads.pop()

    def restack(p):
        return torch.stack([grads.pop() for _ in range(p.shape[0])])

    out = {k: tree_map(restack if k in STACKED else take, v)
           for k, v in params.items()}
    return loss.detach(), out


# why build_train_step refuses a family the port serves
_UNTRAINED = {
    "ssm": "the wkv6 kernel has no gradient yet (ROADMAP.md Queue 1, "
           "item 4.3)",
    "moe": "its training is not ported (ROADMAP.md Queue 1, item 5.2)",
    "mla_moe": "its training is not ported (ROADMAP.md Queue 1, item 5.2)"}


def build_train_step(model: Model, shape: ShapeConfig,
                     pctx: Optional[ParallelCtx] = None,
                     base_lr: float = 3e-4, warmup: int = 200,
                     total_steps: int = 10_000, plan=None) -> TrainStep:
    """loss -> gradients -> AdamW with the reference's cosine schedule.

    The dense family at one rank.  The ssm family raises: its loss is
    differentiable on the CPU through the plain wkv6 but gets no gradient
    through the CUDA kernel, which has no backward yet.  The moe and
    mla_moe families raise: their training is not ported.  A group of more
    than one rank raises: tensor-parallel training needs autograd through
    the rings of ``core/collectives.py``.  All are ROADMAP.md Queue 1."""
    family = model.cfg.family
    if family != "dense":
        raise NotImplementedError(
            f"training family {family!r}: {_UNTRAINED[family]}; the port "
            f"trains the dense family")
    if pctx is not None and pctx.world > 1:
        raise NotImplementedError(
            f"training at world {pctx.world}: tensor-parallel training "
            f"needs autograd through core/collectives.py's rings "
            f"(ROADMAP.md Queue 1, item 4.1)")
    pctx = _with_plan(pctx, plan)
    lr = cosine_schedule(base_lr, warmup, total_steps)
    want = (shape.global_batch, shape.seq_len)

    def step(params, opt, batch):
        if tuple(batch["tokens"].shape) != want:
            raise ValueError(f"batch {tuple(batch['tokens'].shape)}, the "
                             f"step was built for {want}")
        loss, grads = loss_and_grads(model, params, batch, pctx)
        with torch.profiler.record_function("adamw_update"):
            try:
                params, opt, stats = adamw_update(params, grads, opt, lr)
            except torch.cuda.OutOfMemoryError as e:
                # the update is in place: a retry would apply it twice
                raise RuntimeError("AdamW ran out of memory part way "
                                   "through its in-place update") from e
        stats["loss"] = loss
        return params, opt, stats
    return TrainStep(fn=step, shape=shape)


@dataclasses.dataclass
class ServeStep:
    """``fn(params, batch, cache) -> (next_tok [B], cache, logits [B, V])``
    with ``batch = {"tokens": [B, 1], "pos": int}``: one batch, one
    position.  The logits of the last position are returned as well, for
    the comparisons the legacy loop reports."""
    fn: Callable


def build_serve_step(model: Model, pctx: Optional[ParallelCtx] = None,
                     plan=None) -> ServeStep:
    pctx = _with_plan(pctx, plan)

    def step(params, batch, cache):
        logits, cache = model.decode_step(params, batch, cache, pctx)
        last = logits[:, -1, :]
        return torch.argmax(last, dim=-1), cache, last
    return ServeStep(fn=step)


@dataclasses.dataclass
class PagedServeStep:
    """Continuous-batching decode: ``fn(params, batch, cache) -> (next_tok
    [B], cache)`` with ``batch = {"tokens": [B, 1], "pos": [B]}``.  Slot
    ``i`` computes what a B=1 decode at ``pos[i]`` would: RoPE, cache write
    and mask are per row, an MoE layer routes each row as its own group
    (its capacity that of one token, never pooled over the slots), and
    every projection treats rows independently."""
    fn: Callable
    cache_batch_axes: dict


def build_paged_serve_step(model: Model,
                           pctx: Optional[ParallelCtx] = None,
                           plan=None) -> PagedServeStep:
    pctx = _with_plan(pctx, plan)

    def step(params, batch, cache):
        logits, cache = model.decode_step(params, batch, cache, pctx)
        return torch.argmax(logits[:, -1, :], dim=-1), cache
    return PagedServeStep(fn=step, cache_batch_axes=cache_batch_axes(model.cfg))


@dataclasses.dataclass
class PrefillStep:
    """Chunked cache-populating prefill: ``fn(params, batch, cache) ->
    (logits [B, C, V], cache)`` with ``batch = {"tokens": [B, C], "pos0":
    int}``."""
    fn: Callable
    chunk: int


def build_prefill_step(model: Model, chunk: int,
                       pctx: Optional[ParallelCtx] = None,
                       plan=None) -> PrefillStep:
    if not model.has_prefill:
        raise NotImplementedError(
            f"family {model.cfg.family!r} has no batched prefill")
    pctx = _with_plan(pctx, plan)

    def step(params, batch, cache):
        return model.prefill(params, {"tokens": batch["tokens"]}, cache,
                             pctx, pos_offset=batch["pos0"])
    return PrefillStep(fn=step, chunk=chunk)


@dataclasses.dataclass
class Prefill:
    """Forward-only full-sequence pass (the ``prefill_32k`` cells):
    ``fn(params, batch) -> logits [B, S, V]`` with ``batch = {"tokens":
    [B, S]}``.  For the ssm family it runs the wkv6 kernel in every layer."""
    fn: Callable


def build_prefill(model: Model, pctx: Optional[ParallelCtx] = None,
                  plan=None) -> Prefill:
    pctx = _with_plan(pctx, plan)

    def fwd(params, batch):
        return model.forward(params, batch, pctx)
    return Prefill(fn=fwd)
