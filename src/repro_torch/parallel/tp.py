"""Tensor parallelism with the paper's INA toggle (counterpart of
``repro.parallel.tp``).

Column-parallel projections hold a slice of the *output* features and need
no communication.  Row-parallel projections hold a slice of the
*contraction* dim: each rank produces a full-shape **partial sum**, the
paper's WS situation (weights split across PEs), and the ranks accumulate
it under ``psum_mode``:

  * ``"ina"``          — the native all-reduce (NCCL on the card, gloo on
                         the CPU), which schedules the in-network reduce;
  * ``"ina_ring"``     — the explicit chunked ring with in-flight adds
                         (the paper's algorithm, hop by hop);
  * ``"eject_inject"`` — the full-tensor relay ring with endpoint adds
                         (the paper's Fig. 4(a) baseline);
  * ``"auto"``         — resolved per call site: from the attached
                         ``plan`` (a ``repro_torch.plan.ExecutionPlan``,
                         decided once per (config, mesh, phase, dtype) and
                         persisted) when it holds the site, else by the NoC
                         cost model (a memo lookup after each site shape's
                         first call);
  * ``"xla_spmd"``     — in the reference, no ``shard_map``: GSPMD chooses.
                         Eager PyTorch has no compiler to choose, and the
                         weights here are already cut, so it runs the
                         native all-reduce, as ``"ina"`` does.

The weights arrive cut (:func:`repro_torch.parallel.sharding.shard_params`),
so every projection runs the INA matmul kernel on the rank's shard and the
reduction follows it.  With a group of one rank every collective returns
its input: the step launches what a step without a group launches.

Under ``rs_seq`` every family keeps its residual stream sequence-sharded
between blocks, by the reference's rule (``repro.parallel.tp.row_linear``):
a row site whose [B, S, F/P] input's S the group divides reduce-scatters
over S, any other psums, and the MoE combine always psums whole.  The
stream is cut after the embedding (:func:`scatter_seq`), gathered whole at
each block's entry (:func:`gather_seq`), and a tensor a block computes
whole on every rank meets the stream's slice through :func:`scatter_seq`
too (an MoE layer's combined experts, RWKV6's channel-mix gate).  The
norms, adds and gates between the blocks run on the rank's rows.

In training each collective's backward runs through autograd: the row
sites' (:func:`row_linear`), the column-parallel block's entry
(:func:`gather_seq`, Megatron's ``f`` or, under ``rs_seq``, the
backward's reduce-scatter; :func:`enter_cut`, the ``f`` alone, where a
block's whole tensors meet its cut work), the sequence scatter's and the
vocabulary's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import collectives as C
from repro_torch.kernels import ops


@dataclass(frozen=True)
class ParallelCtx:
    """How model-axis parallelism runs inside the forward pass.

    ``group`` is the ``model`` axis's ``torch.distributed`` process group
    (``None``: one rank, no collectives at all); :attr:`world` and
    :attr:`rank` are this axis's.  ``data_group`` and ``pod_group`` are the
    rank's lines along the ``data`` and ``pod`` axes
    (:meth:`repro_torch.launch.mesh.RankMesh.groups`; ``None`` at span 1),
    which the train step reads: it gathers the FSDP shards and reduces
    the gradients over them (:mod:`repro_torch.parallel.steps`); and an
    MoE layer routes the hosts' rows as the one group they are in the
    reference (:func:`host_offsets`, :func:`host_mean`).
    ``rs_seq`` turns the row-parallel psum into a
    reduce-scatter over the sequence, so the residual stream between
    layers stays sequence-sharded (Megatron SP); ``sp_entry`` takes the
    explicit INA ring for it.  ``plan`` (a
    :class:`repro_torch.plan.ExecutionPlan`) answers the ``auto`` sites from
    its table and gives every projection its planned ``ina_matmul`` launch
    (:func:`repro_torch.kernels.ops.matmul`).  The reference's
    ``seq_shard`` (a GSPMD constraint; eager PyTorch has none to set) is not
    carried.  ``serve_replicated_params`` (the reference's, default
    ``False``): a serving rank on the data axis holds its model shard
    whole, gathered once, instead of its FSDP pieces gathered layer by
    layer each step (:func:`repro_torch.parallel.fsdp.serving_params`);
    a serving step carries the data and pod groups where its rows are
    the hosts' cut of one global batch (the legacy loop's step: an MoE
    layer routes that batch as one group, as the reference's jitted serve
    step does), and none where each row is its own group (the engine's
    paged step, a ``vmap`` of a B=1 decode in the reference) or where
    every host runs the same rows (the engine's B=1 prefill).
    """
    group: Optional[object] = None
    psum_mode: str = "ina"
    rs_seq: bool = False
    sp_entry: bool = False
    plan: Optional[object] = None
    data_group: Optional[object] = None
    pod_group: Optional[object] = None
    serve_replicated_params: bool = False

    def __post_init__(self):
        if self.psum_mode not in C.CLI_PSUM_MODES:
            raise ValueError(f"unknown psum mode {self.psum_mode!r}; have "
                             f"{C.CLI_PSUM_MODES}")

    @property
    def world(self) -> int:
        return C.axis_size(self.group)

    @property
    def rank(self) -> int:
        return C.axis_index(self.group)

    @property
    def manual(self) -> bool:
        """True when the group spans more than one rank.  (The reference's
        is false under ``xla_spmd``, where GSPMD reduces; here the weights
        are already cut, so every mode must reduce.)"""
        return self.world > 1

    @property
    def mode(self) -> str:
        """The strategy the collectives run (``xla_spmd`` runs native)."""
        return "xla" if self.psum_mode == "xla_spmd" else self.psum_mode


def _grouped(pctx: Optional[ParallelCtx]) -> bool:
    return pctx is not None and pctx.group is not None


def _plan(pctx: Optional[ParallelCtx]):
    return None if pctx is None else pctx.plan


def seq_sharded(pctx: Optional[ParallelCtx], seq: int) -> bool:
    """Whether a row-parallel output of ``seq`` positions is
    reduce-scattered over the sequence (the reference's ``rs_seq`` rule)."""
    return (_grouped(pctx) and pctx.rs_seq and seq % pctx.world == 0
            and seq >= pctx.world)


def _records(x: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _grad_mode(pctx: ParallelCtx, nbytes: int) -> str:
    """The strategy of a sequence site's backward: the explicit ring under
    ``sp_entry``, else ``pctx.mode``, an ``auto`` one resolved here, in the
    forward, as a reduce-scatter of ``nbytes`` (the plan builder traces
    the forward without gradients, so it records no such site)."""
    if pctx.sp_entry:
        return "ina_ring"
    if pctx.mode == "auto":
        return C.resolve_auto_mode("reduce_scatter", pctx.world, nbytes,
                                   pctx.plan)
    return pctx.mode


def scatter_seq(x: torch.Tensor, pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """This rank's slice of a replicated [B, S, D] where the residual
    stream is sequence-sharded (no communication): the embedded tokens, or
    a tensor a block computes whole on every rank meeting the stream.  Its
    backward gathers the slices' gradients whole, as the replicated input
    needs: by the ring under the ring modes, natively under ``ina`` and
    ``xla``.  At one rank the slice is ``x``."""
    if not seq_sharded(pctx, x.shape[1]) or pctx.world == 1:
        return x
    c = x.shape[1] // pctx.world
    if not _records(x):
        return x.narrow(1, pctx.rank * c, c)
    ring = _grad_mode(pctx, C.nbytes(x)) in C.RING_MODES
    return C.collective(x, None, lambda t: t.narrow(1, pctx.rank * c, c),
                        C.gather_back(pctx.group, 1, ring))


def gather_seq(x: torch.Tensor, pctx: Optional[ParallelCtx], seq: int,
               cut: bool = True) -> torch.Tensor:
    """The input of a column-parallel block, whole on every rank.

    Under ``rs_seq`` the whole sequence comes back from its shards by
    :func:`~repro_torch.core.collectives.ring_all_gather` over S (the
    reference leaves this gather to GSPMD).  Its backward is the
    backward's INA site: the ranks' partial input gradients (``cut``: the
    block's weights are column-cut, so each rank's covers its columns
    only) are reduce-scattered over S under ``pctx.mode``, resolved in the
    forward (the ring under ``sp_entry``).  Without ``rs_seq``, at more
    than one rank and where autograd records, it is Megatron's ``f``:
    the identity, whose backward sums the partial gradients with the
    native all-reduce, once for the block's projections (``col_linear``
    leaves its input's gradient partial).  A block whose input gradient
    comes out whole on every rank (``cut=False``: a head the world does
    not divide, or a block that keeps its own ``f``s where its whole work
    meets its cut work, :func:`enter_cut`: RWKV6's token-shift mixes,
    Mamba2's whole B and C, MLA's latent, the MoE router) takes this
    rank's slice of it in the gather's backward, and there is no ``f``
    here: both would count the cut path's gradient P times."""
    if seq_sharded(pctx, seq):
        back = None
        if cut and _records(x):
            mode = _grad_mode(pctx, C.nbytes(x) * pctx.world)
            back = C.scatter_back(pctx.group, 1, mode)
        return C.ring_all_gather(x, pctx.group, gather_axis=1, back=back)
    return enter_cut(x, pctx) if cut else x


def enter_cut(x: torch.Tensor, pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """Megatron's ``f``: a replicated ``x`` entering rank-local work (a
    column-cut projection, this rank's heads or experts).  At more than one
    rank and where autograd records, the identity whose backward sums the
    ranks' partial gradients of ``x`` with the native all-reduce; else
    ``x``.  It goes exactly where the whole tensor meets the cut work: on
    a path every rank computes whole (a router, a whole weight) the sum
    would count that path's gradient P times."""
    if _grouped(pctx) and pctx.manual and _records(x):
        return C.collective(x, None, lambda t: t, C.sum_back(pctx.group))
    return x


def col_linear(x: torch.Tensor, w: torch.Tensor,
               pctx: Optional[ParallelCtx] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column-parallel matmul: w sharded on its last dim; no communication.
    The gradient of ``x`` it gives is this rank's columns' share only;
    the block's entry (:func:`gather_seq`) sums the shares, once for all
    of the block's projections."""
    out = ops.matmul(x, w.to(x.dtype), _plan(pctx))
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def row_linear(x: torch.Tensor, w: torch.Tensor,
               pctx: Optional[ParallelCtx] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-parallel matmul + psum: the paper's INA site.

    ``x``: [..., F/P] this rank's activations; ``w``: [F/P, D] its rows.
    The local partial [..., D] comes from the INA matmul, and the partials
    are accumulated per ``pctx.psum_mode``: over the last dim, or, under
    ``rs_seq`` on a [B, S, F/P] input whose S the group divides, scattered
    over the sequence (each rank keeps [B, S/P, D]).  The bias is added
    once, after the reduction.

    In training, the psum's backward is the identity on dOut: the output
    is replicated and every rank uses it whole, so each rank's dOut is
    already the whole gradient (the reference's transpose sums P copies
    of dOut / P, the same value up to rounding).  Under ``rs_seq`` the
    backward gathers the dOut shards whole: by ``ring_all_gather`` under
    the ring modes (and ``sp_entry``), natively under ``ina`` and ``xla``.
    Each backward runs the strategy its forward resolved.

    A rank of the uneven head cut with no head has ``F/P = 0``: its
    partial is zero, launched by no kernel, and tied to ``x`` so that the
    block entry's backward collective (:func:`gather_seq`) runs on it as
    on every other rank.
    """
    if x.shape[-1] == 0:
        out = x.new_zeros(*x.shape[:-1], w.shape[1]) + \
            x.sum(-1, keepdim=True)
    else:
        out = ops.matmul(x, w.to(x.dtype), _plan(pctx))
    if _grouped(pctx):
        if x.dim() == 3 and seq_sharded(pctx, x.shape[1]):
            if pctx.sp_entry:
                out = C.ring_reduce_scatter_ina(out, pctx.group,
                                                scatter_axis=1)
            else:
                out = C.reduce_scatter_with_mode(out, pctx.group, pctx.mode,
                                                 scatter_axis=1,
                                                 plan=pctx.plan)
        else:
            out = psum_partial(out, pctx)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def psum_partial(out: torch.Tensor,
                 pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """Each rank's full-shape partial sum ``out`` accumulated over the
    group per ``pctx.psum_mode``, scattered (by the rings) over its last
    dim: one INA site.  Without a group, ``out`` itself."""
    if _grouped(pctx):
        out = C.psum_with_mode(out, pctx.group, pctx.mode,
                               scatter_axis=out.dim() - 1, plan=pctx.plan)
    return out


def combine_experts(combine: torch.Tensor, expert_out: torch.Tensor,
                    pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Combine expert-parallel outputs: the MoE INA site.

    ``combine``: [B, S, E/P, C] combine weights; ``expert_out``: [E/P, C, D]
    this rank's experts.  The contraction over E gives per-rank partial
    sums, accumulated per ``pctx.psum_mode`` as a row-parallel linear's
    (:func:`psum_partial`; ``models.moe.moe_mlp`` combines its experts by a
    gather and sums the partial the same way).
    """
    return psum_partial(torch.einsum("bsec,ecd->bsd", combine,
                                     expert_out.to(combine.dtype)), pctx)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, vocab: int,
                pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """Embedding lookup; a table of ``vocab / world`` rows is this rank's
    slice (vocab-parallel): rows outside it read zero, and the native
    all-reduce sums the one rank that holds each token's row.  Its
    backward is the identity: every rank uses the sum whole."""
    if table.shape[0] == vocab:
        return table[tokens]
    lo = pctx.rank * table.shape[0]
    local = tokens - lo
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = rows * hit[..., None].to(rows.dtype)
    return C.psum_xla(rows, pctx.group)


def vocab_gather(logits: torch.Tensor, vocab: int,
                 pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's slice, so every rank
    takes the same argmax.  In training the loss runs on every rank
    redundantly, so the backward is this rank's slice of dLogits, not a
    reduce-scatter (which would scale the head's gradient by P)."""
    if logits.shape[-1] == vocab:
        return logits
    return C.ring_all_gather(logits, pctx.group, gather_axis=-1)


@dataclass(frozen=True)
class Hosts:
    """The data-parallel hosts (pod x data) of a rank on the mesh: host
    ``index = p D + d`` of ``count``, the order of their rows in the
    global batch."""
    data_group: Optional[object] = None
    pod_group: Optional[object] = None

    @property
    def count(self) -> int:
        return C.axis_size(self.pod_group) * C.axis_size(self.data_group)

    @property
    def index(self) -> int:
        return (C.axis_index(self.pod_group) * C.axis_size(self.data_group)
                + C.axis_index(self.data_group))

    def all_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every host's ``rows`` [n, ...], in host order [count n, ...]:
        one native all-gather over ``data``, then one over ``pod`` (no
        gradient)."""
        out = rows.contiguous()
        for group in (self.data_group, self.pod_group):
            n = C.axis_size(group)
            if n > 1:
                flat = out.reshape(-1)
                out = C.all_gather_into_(flat.new_empty(n * flat.numel()),
                                         flat, group)
                out = out.view(-1, *rows.shape[1:])
        return out


def hosts(pctx: Optional[ParallelCtx]) -> Hosts:
    """The hosts whose rows make up the global batch ``pctx`` runs on."""
    if pctx is None:
        return Hosts()
    return Hosts(pctx.data_group, pctx.pod_group)


def host_offsets(counts: torch.Tensor,
                 pctx: ParallelCtx) -> torch.Tensor:
    """The sum of ``counts`` over the hosts before this one
    (:class:`Hosts`' order)."""
    h = hosts(pctx)
    every = h.all_gather(counts.reshape(1, -1))
    return every[:h.index].sum(0).reshape(counts.shape)


def host_mean(x: torch.Tensor, pctx: ParallelCtx) -> torch.Tensor:
    """The mean over the hosts of a statistic each computes over its own
    rows (equal counts): native all-reduces over ``data`` and ``pod``.
    The train step averages the hosts' gradients, and each host's reaches
    the statistic only through its own rows, so the backward sums the
    hosts' gradients (:func:`~repro_torch.core.collectives.psum_stat`)."""
    for group in (pctx.data_group, pctx.pod_group):
        x = C.psum_stat(x, group)
    return x / hosts(pctx).count
