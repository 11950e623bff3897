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

    ``group`` is a ``torch.distributed`` process group (``None``: one rank,
    no collectives at all).  ``rs_seq`` turns the row-parallel psum into a
    reduce-scatter over the sequence, so the residual stream between
    layers stays sequence-sharded (Megatron SP); ``sp_entry`` takes the
    explicit INA ring for it.  ``plan`` (a
    :class:`repro_torch.plan.ExecutionPlan`) answers the ``auto`` sites from
    its table and gives every projection its planned ``ina_matmul`` launch
    (:func:`repro_torch.kernels.ops.matmul`).  The reference's
    ``seq_shard`` (a GSPMD constraint; eager PyTorch has none to set) is not
    carried.
    """
    group: Optional[object] = None
    psum_mode: str = "ina"
    rs_seq: bool = False
    sp_entry: bool = False
    plan: Optional[object] = None

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


def scatter_seq(x: torch.Tensor, pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """This rank's slice of a replicated [B, S, D] where the residual
    stream is sequence-sharded (no communication)."""
    if not seq_sharded(pctx, x.shape[1]):
        return x
    c = x.shape[1] // pctx.world
    return x.narrow(1, pctx.rank * c, c)


def gather_seq(x: torch.Tensor, pctx: Optional[ParallelCtx],
               seq: int) -> torch.Tensor:
    """The whole sequence back from its shards, before a column-parallel
    projection.  The reference leaves this gather to GSPMD; the port runs
    it explicitly, with :func:`~repro_torch.core.collectives.ring_all_gather`
    over the sequence."""
    if not seq_sharded(pctx, seq):
        return x
    return C.ring_all_gather(x, pctx.group, gather_axis=1)


def col_linear(x: torch.Tensor, w: torch.Tensor,
               pctx: Optional[ParallelCtx] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column-parallel matmul: w sharded on its last dim; no communication."""
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
    """
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
            out = C.psum_with_mode(out, pctx.group, pctx.mode,
                                   scatter_axis=out.dim() - 1,
                                   plan=pctx.plan)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def combine_experts(combine: torch.Tensor, expert_out: torch.Tensor,
                    pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Combine expert-parallel outputs: the MoE INA site.

    ``combine``: [B, S, E/P, C] combine weights; ``expert_out``: [E/P, C, D]
    this rank's experts.  The contraction over E gives per-rank partial
    sums, accumulated per ``pctx.psum_mode`` as a row-parallel linear's.
    """
    out = torch.einsum("bsec,ecd->bsd", combine,
                       expert_out.to(combine.dtype))
    if _grouped(pctx):
        out = C.psum_with_mode(out, pctx.group, pctx.mode,
                               scatter_axis=out.dim() - 1, plan=pctx.plan)
    return out


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, vocab: int,
                pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """Embedding lookup; a table of ``vocab / world`` rows is this rank's
    slice (vocab-parallel): rows outside it read zero, and the native
    all-reduce sums the one rank that holds each token's row."""
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
    takes the same argmax."""
    if logits.shape[-1] == vocab:
        return logits
    return C.ring_all_gather(logits, pctx.group, gather_axis=-1)


def single_rank(world: int, family: str) -> None:
    """Raise where a family that runs on one rank in this port is asked
    for more."""
    if world > 1:
        raise NotImplementedError(
            f"family {family!r} runs on one rank in this port; its "
            f"tensor-parallel path is in ROADMAP.md")
