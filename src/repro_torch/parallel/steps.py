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
the gradients of leaves that several ranks hold.  On the rank mesh the
train step is also data-parallel and FSDP over ``pctx.data_group`` and
``pctx.pod_group`` (:class:`DataSync`), which the reference leaves to
GSPMD.  Greedy decoding takes the first maximal logit, as ``jnp.argmax``.

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
from repro_torch.models.api import Model, cache_batch_axes, stream_leaves
from repro_torch.optim.adamw import adamw_update, cosine_schedule, tree_map
from repro_torch.parallel import fsdp, sharding
from repro_torch.parallel.tp import Hosts, ParallelCtx, seq_sharded


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
    {"tokens", "labels"}`` (and ``"media"`` for the encdec and vlm
    families) this rank's rows of a global batch of ``shape``
    (:meth:`rows`; all of it without a data axis) and ``stats = {"loss",
    "grad_norm", "lr"}`` (float32 scalars on the device, the loss the
    global batch's mean).  ``params`` (float32 masters,
    ``Model.init(masters=True)``) and ``opt`` are updated in place and
    returned.  The rank is data host ``host`` of ``hosts``
    (``TokenPipeline.host_batch``'s arguments)."""
    fn: Callable
    shape: ShapeConfig
    host: int = 0
    hosts: int = 1

    def rows(self, batch: dict) -> dict:
        """This rank's rows of the global ``batch``."""
        n = self.shape.global_batch // self.hosts
        return {k: v[self.host * n:(self.host + 1) * n]
                for k, v in batch.items()}


def _grad_leaves(params: dict, cfg=None, world=(1, 1),
                 dims: Optional[dict] = None) -> tuple[dict, list]:
    """(a tree the loss is differentiated through, its leaves in order);
    ``dims`` (where given) gets the data dims of the FSDP pieces among
    them (:func:`~repro_torch.parallel.fsdp.layer_pieces`).  Each leaf is
    a detached alias of the master (this rank's piece of ``world = (D,
    M)``) that requires a gradient; a stacked leaf
    (:data:`~repro_torch.models.layers.STACK_AXES`) becomes its layer
    slices, a list over each stacked axis (``groups`` [G, per, ...] a list
    of G lists of ``per``; :func:`~repro_torch.parallel.fsdp.
    layer_pieces`), so autograd gives each layer its own gradient, not one
    full-size ``select`` gradient a layer summed into the stack's."""
    leaves = []

    def leaf(p):
        leaves.append(p.detach().requires_grad_())
        return leaves[-1]
    work, cut = fsdp.layer_pieces(params, cfg, world, leaf)
    if dims is not None:
        dims.update(cut)
    return work, leaves


#: per-head norm weights: each rank's gradient covers its own heads only
_HEAD_NORMS = ("q_norm", "k_norm")
#: (parent, name) of whole leaves that every path of theirs leads into
#: rank-local work behind one ``f``: RWKV6's time-mix token shift and the
#: decay LoRA's first factor (``models.ssm.rwkv_tmix``)
_PARTIAL = {("tmix", "mu"), ("tmix", "w_lora_a")}
_KV = ("wk", "bk", "wv", "bv")


@dataclasses.dataclass
class GradSync:
    """The reductions a rank's gradients need after the backward, beyond
    the collectives' own backwards: each KV head that other ranks share
    with this one (self- or cross-attention) gets each one's share of its
    gradient summed over them (``kv_groups``: ``(group, j, n)``, head
    ``j`` of the rank's ``n``, one entry a shared head; under the uneven
    head cut a rank straddling two KV heads sums each over its own
    group, in KV-head order), and the whole leaves whose gradient is partial on
    every path (per-head norms always, the family's stream leaves,
    :func:`~repro_torch.models.api.stream_leaves`, where their sequence is
    sharded, :data:`_PARTIAL`, and the whole B and C segments of
    Mamba2's packed ``w_in``, ``conv_w`` and ``conv_b``,
    :func:`~repro_torch.parallel.sharding.segment_runs`) are summed over
    ``group``.  Every other replicated leaf's gradient comes out whole,
    and bit-equal, on every rank: a whole leaf with both a partial and a
    whole path (RWKV6's channel-mix ``mu``) gets its sum from an ``f`` on
    the cut path alone, never here."""
    group: object
    kv_groups: tuple
    cfg: object

    def reduce(self, grads: dict, stream: frozenset) -> None:
        """Sum ``grads``' shared and partial leaves in place; ``stream``
        holds the paths of the stream leaves whose sequence the step's
        rs_seq cut.  No row site of the port adds a bias
        (``layers.init_attn``'s are q's, k's and v's, column-parallel), so
        no bias is a stream leaf."""
        kv, partial = [], []
        world = C.axis_size(self.group)
        for names, g in _named_leaves(grads):
            runs = sharding.segment_runs(names, self.cfg, world)
            if runs is not None:
                partial += [g.narrow(-1, start, size)
                            for cut, start, size in runs if not cut]
            elif names[-1] in _KV and names[-2:-1] in (("attn",),
                                                       ("xattn",)):
                kv.append(g)
            elif names[-1] in _HEAD_NORMS or names[-2:] in _PARTIAL or \
                    "/".join(names) in stream:
                partial.append(g)
        buckets = [([g.narrow(-1, j * (g.shape[-1] // n), g.shape[-1] // n)
                     for g in kv], group) for group, j, n in self.kv_groups]
        for leaves, group in buckets + [(partial, self.group)]:
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


def _model_lines(pctx: ParallelCtx) -> list:
    """The global ranks of every model line of the default group.  The
    model axis is the rank mesh's innermost (``launch.mesh.RankMesh``), so
    its lines are the blocks of ``pctx.world`` consecutive ranks; one of
    them is ``pctx.group``'s."""
    m = pctx.world
    own = [dist.get_global_rank(pctx.group, r) for r in range(m)]
    lines = [list(range(b, b + m)) for b in range(0, dist.get_world_size(), m)]
    if own not in lines:
        raise ValueError(f"the model group's ranks {own} are not one of the "
                         f"blocks of {m} consecutive ranks of the rank mesh")
    return lines


def grad_sync(cfg, pctx: Optional[ParallelCtx]) -> Optional[GradSync]:
    """The :class:`GradSync` of a rank of ``pctx.group`` (``None`` at one
    rank).  Where ranks share a KV head it makes one ``dist.new_group``
    for each shared KV head of each model line
    (:func:`~repro_torch.parallel.sharding.kv_holders`), line after line,
    in KV-head order, which every rank of the default group must call
    alike.  On an :class:`~repro_torch.core.collectives.AxisSpan` (the
    dry-run's rank 0) each KV group is a span of the ranks sharing one
    of rank 0's KV heads, and no group is made."""
    if pctx is None or not pctx.manual:
        return None
    holders = sharding.kv_holders(cfg, pctx.world)
    heads = sharding.attn_heads(cfg, ("shared",) if cfg.family == "hybrid"
                                else ())
    mine = sharding.head_split(cfg, pctx.rank, pctx.world, heads)[1] \
        if holders else range(0)
    kv = []
    if isinstance(pctx.group, C.AxisSpan):
        kv = [(C.AxisSpan(len(ranks)), u - mine.start, len(mine))
              for u, ranks in holders if pctx.rank in ranks]
        return GradSync(group=pctx.group, kv_groups=tuple(kv), cfg=cfg)
    for line in _model_lines(pctx) if holders else []:
        for u, ranks in holders:
            members = [line[r] for r in ranks]
            pg = dist.new_group(members)
            if dist.get_rank() in members:
                kv.append((pg, u - mine.start, len(mine)))
    return GradSync(group=pctx.group, kv_groups=tuple(kv), cfg=cfg)


@dataclasses.dataclass
class DataSync:
    """The data-parallel half of a train step on the rank mesh (the part
    of the reference's step that GSPMD writes): a rank at ``(pod p, data
    d)`` of ``(P, D)`` trains on host ``p * D + d``'s rows of the global
    batch and holds its model shard cut into D pieces
    (:func:`~repro_torch.parallel.sharding.shard_params` at ``(d, m)`` of
    ``world = (D, M)``).  The pieces are gathered layer by layer inside
    the forward, and each cut leaf's gradient comes out of the backward
    reduce-scattered over ``data`` (:mod:`repro_torch.parallel.fsdp`);
    :meth:`reduce` finishes the gradient of the global batch's mean loss,
    and that loss: an all-reduce over ``data`` of the leaves held whole
    there (and of the loss), an all-reduce over ``pod`` of all of them,
    then a division by ``P * D``.  Each collective runs once for each
    dtype among the leaves (one bucket each); at span 1 an axis runs
    none."""
    cfg: object
    data_group: Optional[object]
    pod_group: Optional[object]
    model_world: int = 1

    @property
    def world(self) -> tuple:
        """``(D, M)``: the shards' world."""
        return (C.axis_size(self.data_group), self.model_world)

    @property
    def hosts(self) -> int:
        return Hosts(self.data_group, self.pod_group).count

    @property
    def host(self) -> int:
        return Hosts(self.data_group, self.pod_group).index

    def reduce(self, loss: torch.Tensor, grads: dict) -> tuple:
        """(the global batch's mean loss, this rank's pieces of its
        gradient) from this rank's loss and its pieces' gradients (the cut
        leaves' already summed over ``data`` by the gather's backward)."""
        dd, pp = self.world[0], C.axis_size(self.pod_group)
        if dd * pp == 1:
            return loss, grads
        out = {}
        whole = [((), loss)]
        for names, g in _named_leaves(grads):
            if sharding.data_cut(names, self.cfg, self.world) is None:
                whole.append((names, g))
            else:
                out[names] = g
        for bucket in _by_dtype(whole):
            out.update(_reduced(bucket, self.data_group))
        for bucket in _by_dtype(list(out.items())) if pp > 1 else []:
            out.update(_reduced(bucket, self.pod_group))
        out = {names: g / (dd * pp) for names, g in out.items()}
        return out.pop(()), _replaced(grads, out)


def data_sync(cfg, pctx: Optional[ParallelCtx]) -> DataSync:
    """The :class:`DataSync` of a rank of ``pctx``'s mesh (with no data or
    pod group: one that gathers and reduces nothing)."""
    if pctx is None:
        return DataSync(cfg, None, None)
    return DataSync(cfg, pctx.data_group, pctx.pod_group, pctx.world)


def _by_dtype(items: list) -> list:
    """``items`` (tuples whose second entry is a tensor) in buckets of
    one dtype each, in order of first appearance."""
    buckets = {}
    for item in items:
        buckets.setdefault(item[1].dtype, []).append(item)
    return list(buckets.values())


def _reduced(bucket: list, group) -> list:
    """(names, the all-reduced sum) of each ``(names, tensor)`` of one
    dtype, in one all-reduce over ``group``."""
    if C.axis_size(group) == 1:
        return bucket
    flat = C.all_reduce_(torch.cat([g.reshape(-1) for _, g in bucket]),
                         group)
    return [(names, part.view(g.shape)) for (names, g), part in zip(
        bucket, flat.split([g.numel() for _, g in bucket]))]


def _replaced(tree: dict, new: dict, names: tuple = ()) -> dict:
    """``tree`` with the leaves named in ``new`` replaced."""
    return {k: _replaced(v, new, names + (k,)) if isinstance(v, dict)
            else new.get(names + (k,), v) for k, v in tree.items()}


def loss_and_grads(model: Model, params: dict, batch: dict,
                   pctx: Optional[ParallelCtx] = None,
                   sync: Optional[GradSync] = None,
                   data: Optional[DataSync] = None):
    """(loss, grads): ``model.loss`` and ``torch.autograd.grad`` of it, the
    gradients in ``params``' structure (a stacked leaf's restacked) and
    dtypes.  At more than one rank ``params`` are this rank's shards, and
    the gradients, after ``sync``'s reductions (:func:`grad_sync`'s where
    none is given), are the shards of the logical gradient.  With
    ``data`` (:func:`data_sync`) ``params`` are this rank's pieces and
    ``batch`` its rows: the leaves outside the layers are gathered whole
    first, each layer's pieces inside its checkpointed body
    (:mod:`repro_torch.parallel.fsdp`), and the loss and the gradient's
    pieces are those of the global batch's mean."""
    world = (1, 1) if data is None else data.world
    dims = {}
    work, leaves = _grad_leaves(params, model.cfg, world, dims)
    group = None if data is None else data.data_group
    with fsdp.gathering(fsdp.Gatherer(group, dims)):
        loss = model.loss(fsdp.gather_tree(work, dims, group), batch, pctx)
    # a rank of the uneven head cut with no head leaves its (empty)
    # attention pieces and its whole per-head norms unused: zero gradients
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    grads.reverse()

    def restack(node):
        if isinstance(node, list):
            return torch.stack([restack(q) for q in node])
        return grads.pop()
    out = tree_map(restack, work)
    del work, leaves
    if pctx is not None and pctx.manual:
        sync = sync or grad_sync(model.cfg, pctx)
        sync.reduce(out, frozenset(
            path for path, key in stream_leaves(model.cfg).items()
            if seq_sharded(pctx, batch[key].shape[1])))
    if data is not None:
        return data.reduce(loss.detach(), out)
    return loss.detach(), out


def build_train_step(model: Model, shape: ShapeConfig,
                     pctx: Optional[ParallelCtx] = None,
                     base_lr: float = 3e-4, warmup: int = 200,
                     total_steps: int = 10_000, plan=None) -> TrainStep:
    """loss -> gradients -> AdamW with the reference's cosine schedule.

    Every family, at one rank, or on the rank mesh: tensor-parallel
    over ``pctx.group`` and data-parallel with FSDP shards over
    ``pctx.data_group`` and ``pctx.pod_group`` (``params`` and ``opt`` then
    this rank's pieces, as :func:`repro_torch.parallel.sharding.
    shard_params` cuts them at ``(data rank, model rank)``, and ``batch``
    its rows of the global batch, :meth:`TrainStep.rows`).  The step
    gathers each layer's pieces over ``data`` inside its checkpointed body
    (:mod:`repro_torch.parallel.fsdp`), runs the loss and its gradient as
    the tensor-parallel step does (the collectives' backwards,
    :class:`GradSync`), reduces the gradients to this rank's pieces of the
    global batch's mean (:class:`DataSync`), and AdamW updates the
    pieces, its norm over the logical arrays: every rank gets its piece of
    the unsharded step's update.  A global batch that the data ranks
    (pod x data) do not divide raises ValueError (the reference's
    ``fit_specs`` would move the batch's data axis to the sequence, which
    the port does not cut over ``data``), as does a model world that does
    not divide the heads outside the uneven head cut's families
    (:data:`~repro_torch.parallel.sharding.UNEVEN_HEAD_FAMILIES`).  The
    encdec and vlm families' ``batch`` also holds this rank's rows of
    ``media`` [B, M, D], as the reference's ``batch_specs`` cut it."""
    cfg = model.cfg
    pctx = _with_plan(pctx, plan)
    sync = grad_sync(cfg, pctx)
    data = data_sync(cfg, pctx)
    if shape.global_batch % data.hosts or shape.global_batch < data.hosts:
        raise ValueError(
            f"a global batch of {shape.global_batch} rows does not divide "
            f"over {data.hosts} data-parallel ranks (pod x data): the "
            f"reference's fit_specs would move the batch's data axis to the "
            f"sequence, which the port does not cut over data")
    groups = tuple(g for g in (data.data_group,
                               None if sync is None else pctx.group)
                   if C.axis_size(g) > 1)
    lr = cosine_schedule(base_lr, warmup, total_steps)
    want = (shape.global_batch // data.hosts, shape.seq_len)
    coord = (C.axis_index(data.data_group), 0 if pctx is None else pctx.rank)

    def step(params, opt, batch):
        if tuple(batch["tokens"].shape) != want:
            raise ValueError(f"batch {tuple(batch['tokens'].shape)}, the "
                             f"step was built for {want} (this rank's rows "
                             f"of {shape.global_batch})")
        loss, grads = loss_and_grads(model, params, batch, pctx, sync, data)
        holding = sharding.leaf_holding(params, cfg, coord, data.world) \
            if groups else None
        with torch.profiler.record_function("adamw_update"):
            try:
                params, opt, stats = adamw_update(params, grads, opt, lr,
                                                  group=groups,
                                                  holding=holding)
            except torch.cuda.OutOfMemoryError as e:
                # the update is in place: a retry would apply it twice
                raise RuntimeError("AdamW ran out of memory part way "
                                   "through its in-place update") from e
        stats["loss"] = loss
        return params, opt, stats
    return TrainStep(fn=step, shape=shape, host=data.host, hosts=data.hosts)


@dataclasses.dataclass
class ServeStep:
    """``fn(params, batch, cache) -> (next_tok [B], cache, logits [B, V])``
    with ``batch = {"tokens": [B, 1], "pos": int}``, and for the encdec and
    vlm families ``"media"`` [B, M, D], which reaches ``decode_step`` with
    the rest of the batch: one batch, one position.  The logits of the last
    position are returned as well, for the comparisons the legacy loop
    reports."""
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
