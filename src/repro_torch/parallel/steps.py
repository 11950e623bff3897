"""Train, serve, prefill and forward steps (counterpart of
``repro.parallel.steps``).

The reference builds jitted, sharded artifacts; PyTorch runs eagerly, so
each builder here returns the plain callable in the same kind of record.
The train step differentiates the loss with ``torch.autograd.grad``: the
projections' gradients run on the INA matmul (``kernels.ina_matmul.
InaMatmul``), and each layer is checkpointed and recomputed.
Tensor parallelism reaches the model through ``pctx``: its process group
and psum mode (:class:`repro_torch.parallel.tp.ParallelCtx`), with the
parameters a rank's shards; in training the collectives' backwards run
through autograd, each layer's forward collectives run again in its
recompute (in the same order on every rank), and :class:`GradSync` sums
the gradients of leaves that several ranks hold.  Greedy decoding takes the first maximal
logit, as ``jnp.argmax``.

Every builder accepts ``plan`` (a :class:`repro_torch.plan.ExecutionPlan`):
it rides the step's ``ParallelCtx`` (:func:`_with_plan`), so ``auto`` psum
sites resolve from its table and the projections launch its tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.core import collectives as C
from repro_torch.models.api import Model, cache_batch_axes
from repro_torch.models.layers import STACKED
from repro_torch.optim.adamw import adamw_update, cosine_schedule, tree_map
from repro_torch.parallel import sharding
from repro_torch.parallel.tp import ParallelCtx, seq_sharded


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


#: per-head norm weights: each rank's gradient covers its own heads only
_HEAD_NORMS = ("q_norm", "k_norm")
#: norm weights on the residual stream, sequence-sharded under rs_seq
_STREAM_NORMS = ("ln1", "ln2", "ln_f")
_KV = ("wk", "bk", "wv", "bv")


@dataclasses.dataclass
class GradSync:
    """The reductions a rank's gradients need after the backward, beyond
    the collectives' own backwards: a KV head that ``kv_group``'s ranks
    share gets each one's share of its gradient summed over them, and the
    norm weights whose gradient is partial (per-head norms always, the
    stream's under ``rs_seq``) are summed over ``group``.  Every other
    replicated leaf's gradient comes out whole, and bit-equal, on every
    rank."""
    group: object
    kv_group: Optional[object]

    def reduce(self, grads: dict, seq_sharded: bool) -> None:
        kv, partial = [], []
        for names, g in _named_leaves(grads):
            if names[-1] in _KV and names[-2:-1] == ("attn",):
                kv.append(g)
            elif names[-1] in _HEAD_NORMS or \
                    (seq_sharded and names[-1] in _STREAM_NORMS):
                partial.append(g)
        for leaves, group in ((kv, self.kv_group), (partial, self.group)):
            if leaves and group is not None:
                flat = C.all_reduce_(torch.cat([g.reshape(-1)
                                                for g in leaves]), group)
                for g, part in zip(leaves, flat.split([g.numel()
                                                       for g in leaves])):
                    g.copy_(part.view_as(g))


def _named_leaves(tree: dict, names: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, names + (k,))
        else:
            yield names + (k,), v


def grad_sync(cfg, pctx: Optional[ParallelCtx]) -> Optional[GradSync]:
    """The :class:`GradSync` of a rank of ``pctx.group`` (``None`` at one
    rank).  Where ranks share a KV head it makes one ``dist.new_group``
    for each KV head, in KV-head order, which every rank of the default
    group must call alike."""
    if pctx is None or not pctx.manual:
        return None
    kv = None
    for ranks in sharding.kv_groups(cfg, pctx.world):
        pg = dist.new_group([dist.get_global_rank(pctx.group, r)
                             for r in ranks])
        if pctx.rank in ranks:
            kv = pg
    return GradSync(group=pctx.group, kv_group=kv)


def loss_and_grads(model: Model, params: dict, batch: dict,
                   pctx: Optional[ParallelCtx] = None,
                   sync: Optional[GradSync] = None):
    """(loss, grads): ``model.loss`` and ``torch.autograd.grad`` of it, the
    gradients in ``params``' structure (a stacked leaf's restacked) and
    dtypes.  At more than one rank ``params`` are this rank's shards, and
    the gradients, after ``sync``'s reductions (:func:`grad_sync`'s where
    none is given), are the shards of the logical gradient."""
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
    if pctx is not None and pctx.manual:
        sync = sync or grad_sync(model.cfg, pctx)
        sync.reduce(out, seq_sharded(pctx, batch["tokens"].shape[1]))
    return loss.detach(), out


# why build_train_step refuses a family the port serves
_UNTRAINED = {
    "ssm": "the wkv6 kernel has no gradient yet (ROADMAP.md Queue 1, "
           "item 4.3)",
    "moe": "its training is not ported (ROADMAP.md Queue 1, item 5.2)",
    "mla_moe": "its training is not ported (ROADMAP.md Queue 1, item 5.2)"}


def check_trainable(cfg) -> None:
    """Raise for a family whose training the port lacks."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training family {cfg.family!r}: {_UNTRAINED[cfg.family]}; "
            f"the port trains the dense family")


def build_train_step(model: Model, shape: ShapeConfig,
                     pctx: Optional[ParallelCtx] = None,
                     base_lr: float = 3e-4, warmup: int = 200,
                     total_steps: int = 10_000, plan=None) -> TrainStep:
    """loss -> gradients -> AdamW with the reference's cosine schedule.

    The dense family, at one rank or tensor-parallel over ``pctx.group``
    (``params`` and ``opt`` then this rank's shards, as
    :func:`repro_torch.parallel.sharding.shard_params` cuts them): the
    collectives' backwards, :class:`GradSync`'s reductions and AdamW's
    norm over the logical arrays give every rank its shard of the
    unsharded step's update.  A world that does not divide the heads
    raises ValueError.  The ssm family raises: its loss is
    differentiable on the CPU through the plain wkv6 but gets no gradient
    through the CUDA kernel, which has no backward yet.  The moe and
    mla_moe families raise: their training is not ported.  Both are
    ROADMAP.md Queue 1."""
    cfg = model.cfg
    check_trainable(cfg)
    pctx = _with_plan(pctx, plan)
    sync = grad_sync(cfg, pctx)
    group = None if sync is None else pctx.group
    lr = cosine_schedule(base_lr, warmup, total_steps)
    want = (shape.global_batch, shape.seq_len)

    def step(params, opt, batch):
        if tuple(batch["tokens"].shape) != want:
            raise ValueError(f"batch {tuple(batch['tokens'].shape)}, the "
                             f"step was built for {want}")
        loss, grads = loss_and_grads(model, params, batch, pctx, sync)
        holding = None if group is None else sharding.leaf_holding(
            params, cfg, pctx.rank, pctx.world)
        with torch.profiler.record_function("adamw_update"):
            try:
                params, opt, stats = adamw_update(params, grads, opt, lr,
                                                  group=group,
                                                  holding=holding)
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
