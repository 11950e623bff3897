"""INA across ranks: accumulate-while-routing against eject/inject
(counterpart of ``repro.core.collectives``).

The paper's dichotomy (Fig. 4) on a ring of ranks of a ``torch.distributed``
process group:

* :func:`ring_psum_eject_inject` — Fig. 4(a).  The *full* partial-sum
  tensor is relayed around the ring; at every stop it is "ejected" into the
  rank (added to the local accumulator) and the received tensor is
  "re-injected" for the next hop.  P-1 hops of ``|x|`` bytes a link.
* :func:`ring_reduce_scatter_ina` — Fig. 4(b).  The tensor is chunked 1/P;
  each hop adds the local contribution into the moving chunk and forwards
  it.  P-1 hops of ``|x|/P``: a ~P x cut in bytes a link.
* :func:`psum_ina` — reduce-scatter then all-gather, when every rank needs
  the whole sum.

``*_xla`` are the native collectives (``dist.all_reduce`` and
``dist.reduce_scatter_tensor``: NCCL on the card, gloo on the CPU), as the
reference's are XLA's ``psum`` and ``psum_scatter``.

Where the reference binds an ``axis_name`` inside ``shard_map``, these take
a ``group``: a ``ProcessGroup``, ``None`` for one rank without a group, or
an :class:`AxisSpan` (``p`` ranks without processes, on ``meta`` tensors).
``jax.lax.ppermute`` to the ring successor becomes one
``batch_isend_irecv``: send to ``(i+1) % p``, receive from ``(i-1) % p``.
The ring functions add in the reference's order, so float32 results match
its bit for bit.  At ``p == 1`` every function returns ``x`` itself, the
native ones too: a one-rank step launches nothing more than a step without
a group.  Each of them is one autograd node at ``p > 1`` (see
"Gradients" below): JAX transposes ``psum``, ``ppermute`` and
``psum_scatter`` itself, and autograd sees through neither
``batch_isend_irecv`` nor a copy into a fresh tensor.  The reference's CPU upcast around bf16 collectives
(``_needs_f32_workaround``, an XLA fault) has no counterpart: gloo and NCCL
reduce bf16 as it is.
"""
from __future__ import annotations

import collections
import functools
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Literal, Optional

import torch
import torch.distributed as dist

from repro_torch.core.cost import record_collective

PsumMode = Literal["ina", "ina_ring", "eject_inject", "xla", "auto"]

#: The ``--psum-mode`` choices every launch CLI offers.
CLI_PSUM_MODES = ("xla_spmd", "ina", "ina_ring", "eject_inject", "auto")

#: The strategies whose gathers run hop by hop on the ring.
RING_MODES = ("eject_inject", "ina_ring")


@dataclass(frozen=True)
class AxisSpan:
    """A group of ``p`` ranks that has no processes: what the plan builder
    and the dry-run trace a ``p``-way mesh axis with (the reference's
    ``AbstractMesh``).  It stands at rank 0.  Every collective below runs
    its strategy's code on it up to the communication itself, which is
    recorded instead (:func:`repro_torch.core.cost.record_collective`:
    the kind and the output's bytes, one ``collective-permute`` a ring
    hop) and answered with a ``meta`` tensor of the result's shape; a
    tensor on any other device raises (:func:`_span_only`)."""
    p: int


def _span_only(x: torch.Tensor, group: AxisSpan, op: str) -> None:
    if x.device.type != "meta":
        raise ValueError(f"{op} over {group}: a span without processes "
                         f"carries meta tensors only, not {x.device}")


def _on_span(group, kind: str, out: torch.Tensor, *inputs) -> bool:
    """Whether ``group`` is an :class:`AxisSpan`; if so the collective of
    ``kind`` with output ``out`` is recorded, not run (``inputs`` and
    ``out`` must be ``meta``)."""
    if not isinstance(group, AxisSpan):
        return False
    for t in (out, *inputs):
        _span_only(t, group, kind)
    record_collective(kind, nbytes(out))
    return True


def axis_size(group) -> int:
    """Ranks in ``group`` (1 for ``None``: one rank, no group)."""
    if group is None:
        return 1
    return group.p if isinstance(group, AxisSpan) \
        else dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's index in ``group`` (0 for ``None`` or an
    :class:`AxisSpan`)."""
    if group is None or isinstance(group, AxisSpan):
        return 0
    return dist.get_rank(group)


def ppermute_next(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` to the ring successor and return what the predecessor
    sent: ``jax.lax.ppermute`` with ``perm = [(i, (i+1) % p)]``."""
    p, i = axis_size(group), axis_index(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    if _on_span(group, "collective-permute", recv, send):
        return recv
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (i + 1) % p),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (i - 1) % p),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _chunk(x: torch.Tensor, k: int, c: int, axis: int) -> torch.Tensor:
    return x.narrow(axis, k * c, c)


# --------------------------------------------------------------------------- #
# Gradients.  Every collective of a group of more than one rank runs inside
# one autograd node whose backward is given with its forward, so a site's
# backward runs the strategy its forward resolved.  The convention: a
# tensor every rank holds whole (replicated) gets its whole gradient on
# every rank; a rank's slice or partial sum gets its own.  So a psum's
# backward is the identity, a reduce-scatter's an all-gather, and an
# all-gather's this rank's slice.  ``CALLS`` counts the group operations
# run, forward and backward, by kind.
# --------------------------------------------------------------------------- #
CALLS: collections.Counter = collections.Counter()


class _Collective(torch.autograd.Function):
    """``fwd(x)``; the backward ``bwd[1](dy)``.  ``op`` and ``bwd[0]`` name
    the group operation each side runs for :data:`CALLS` (``None``: no
    communication)."""

    @staticmethod
    def forward(ctx, x, op, fwd, bwd):
        ctx.bwd = bwd
        if op is not None:
            CALLS[op] += 1
        return fwd(x)

    @staticmethod
    def backward(ctx, dy):
        op, fn = ctx.bwd
        if op is not None:
            CALLS[op] += 1
        return fn(dy), None, None, None


def collective(x: torch.Tensor, op: Optional[str], fwd: Callable,
               bwd: tuple) -> torch.Tensor:
    """``fwd(x)`` as one autograd node whose backward is ``bwd = (name,
    fn)``: ``fn(dy)`` gives ``x``'s gradient."""
    return _Collective.apply(x, op, fwd, bwd)


def _whole(dy: torch.Tensor) -> torch.Tensor:
    return dy


WHOLE = (None, _whole)          # the backward of a replicated result


def _own_chunk(group, axis: int) -> tuple:
    """The backward of a gather whose result every rank uses whole: this
    rank's slice of the (whole) gradient."""
    def fn(dy):
        c = dy.shape[axis] // axis_size(group)
        return _chunk(dy, axis_index(group), c, axis)
    return None, fn


def _eject_inject(x: torch.Tensor, group) -> torch.Tensor:
    acc = x
    send = x
    for _ in range(axis_size(group) - 1):
        send = ppermute_next(send, group)       # inject -> next hop
        acc = acc + send                        # eject -> local add
    return acc


def _rs_ina(x: torch.Tensor, group, scatter_axis: int) -> torch.Tensor:
    p, i = axis_size(group), axis_index(group)
    c = x.shape[scatter_axis] // p
    # Seeded with chunk (i-1) so that after p-1 hops rank i holds chunk i
    # summed over every rank (the moving chunk's index falls by one a hop).
    carry = _chunk(x, (i - 1) % p, c, scatter_axis)
    for s in range(p - 1):
        carry = ppermute_next(carry, group)
        carry = carry + _chunk(x, (i - 2 - s) % p, c, scatter_axis)
    return carry


def _ring_gather(x: torch.Tensor, group, gather_axis: int) -> torch.Tensor:
    p, i = axis_size(group), axis_index(group)
    c = x.shape[gather_axis]
    shape = list(x.shape)
    shape[gather_axis] = c * p
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    send = x
    _chunk(out, i, c, gather_axis).copy_(send)
    for s in range(p - 1):
        send = ppermute_next(send, group)
        # after s+1 forwards we hold the chunk owned by (i - s - 1)
        _chunk(out, (i - s - 1) % p, c, gather_axis).copy_(send)
    return out


def _native_gather(x: torch.Tensor, group, gather_axis: int) -> torch.Tensor:
    """``dist.all_gather_into_tensor`` on ``gather_axis``."""
    p = axis_size(group)
    front = x.movedim(gather_axis, 0).contiguous()
    out = torch.empty((front.shape[0] * p,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if not _on_span(group, "all-gather", out, front):
        dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, gather_axis)


def _native_scatter(x: torch.Tensor, group, scatter_axis: int) -> torch.Tensor:
    p = axis_size(group)
    front = x.movedim(scatter_axis, 0).contiguous()
    out = torch.empty((front.shape[0] // p,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if not _on_span(group, "reduce-scatter", out, front):
        dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, scatter_axis)


def _native_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    if not _on_span(group, "all-reduce", out):
        dist.all_reduce(out, group=group)
    return out


def gather_back(group, axis: int, ring: bool) -> tuple:
    """The backward of a reduce-scatter: the gradient's shards gathered
    whole, by the ring (``ring``) or the native all-gather."""
    if ring:
        return "all_gather", lambda dy: _ring_gather(dy, group, axis)
    return "all_gather", lambda dy: _native_gather(dy, group, axis)


def scatter_back(group, axis: int, mode: str) -> tuple:
    """The backward of a gather whose result feeds column-cut work (each
    rank's gradient a partial sum): the partials reduce-scattered under
    ``mode``, a resolved strategy."""
    return "reduce_scatter", lambda dy: _reduce_scatter(dy, group, mode, axis)


def sum_back(group) -> tuple:
    """The backward of a replicated input to column-cut work (Megatron's
    ``f``): the partial gradients summed by the native all-reduce."""
    return "all_reduce", lambda dy: _native_sum(dy, group)


# --------------------------------------------------------------------------- #
# Fig. 4(a): eject -> local add -> inject, hop by hop (full tensor each hop).
# --------------------------------------------------------------------------- #
def ring_psum_eject_inject(x: torch.Tensor, group) -> torch.Tensor:
    """Unchunked ring all-reduce: P-1 full-tensor hops with endpoint adds."""
    if axis_size(group) == 1:
        return x
    return collective(x, "psum", lambda t: _eject_inject(t, group), WHOLE)


# --------------------------------------------------------------------------- #
# Fig. 4(b): chunked ring reduce-scatter with in-flight accumulation.
# --------------------------------------------------------------------------- #
def _divides(x: torch.Tensor, p: int, axis: int) -> None:
    if x.shape[axis] % p != 0:
        raise ValueError(f"scatter axis {axis} ({x.shape[axis]}) "
                         f"not divisible by axis size {p}")


def ring_reduce_scatter_ina(x: torch.Tensor, group,
                            scatter_axis: int = 0) -> torch.Tensor:
    """In-network accumulation: each hop adds its contribution to the moving
    1/P chunk and forwards it.  Rank ``i`` returns fully-reduced chunk ``i``.
    The backward gathers the gradient's chunks by the ring.
    """
    p = axis_size(group)
    if p == 1:
        return x
    scatter_axis %= x.dim()
    _divides(x, p, scatter_axis)
    return collective(x, "reduce_scatter",
                      lambda t: _rs_ina(t, group, scatter_axis),
                      gather_back(group, scatter_axis, ring=True))


def ring_all_gather(x: torch.Tensor, group, gather_axis: int = 0,
                    back: Optional[tuple] = None) -> torch.Tensor:
    """Ring all-gather (P-1 hops of |x| each); inverse of the scatter.  Its
    backward is this rank's slice of the gradient, where every rank uses
    the gathered tensor whole; ``back`` gives another (a ``(name, fn)``
    pair such as :func:`scatter_back`'s)."""
    if axis_size(group) == 1:
        return x
    gather_axis %= x.dim()
    return collective(x, "all_gather",
                      lambda t: _ring_gather(t, group, gather_axis),
                      back or _own_chunk(group, gather_axis))


def psum_ina(x: torch.Tensor, group, scatter_axis: int = 0) -> torch.Tensor:
    """Full all-reduce via INA: reduce-scatter (in-flight adds) + all-gather."""
    p = axis_size(group)
    if p == 1:
        return x
    scatter_axis %= x.dim()
    _divides(x, p, scatter_axis)
    return collective(x, "psum", lambda t: _ring_gather(
        _rs_ina(t, group, scatter_axis), group, scatter_axis), WHOLE)


# --------------------------------------------------------------------------- #
# Native collectives (NCCL / gloo schedule the reduction themselves).
# --------------------------------------------------------------------------- #
def psum_scatter_xla(x: torch.Tensor, group, scatter_axis: int = 0,
                     ) -> torch.Tensor:
    """``dist.reduce_scatter_tensor`` on ``scatter_axis`` (tiled: rank i
    keeps the i-th 1/P slab of the sum); the backward is the native
    all-gather."""
    if axis_size(group) == 1:
        return x
    scatter_axis %= x.dim()
    return collective(x, "reduce_scatter",
                      lambda t: _native_scatter(t, group, scatter_axis),
                      gather_back(group, scatter_axis, ring=False))


def psum_xla(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_reduce`` into a copy (``x`` is left as it was)."""
    if axis_size(group) == 1:
        return x
    return collective(x, "psum", lambda t: _native_sum(t, group), WHOLE)


def psum_stat(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_reduce`` into a copy, as :func:`psum_xla`, of a statistic
    that every rank computes over its own slice (a norm's sum of squares
    over the channels it holds) and then reads only over that slice: each
    rank's gradient of the sum is then partial, so the backward sums them
    with the native all-reduce (:func:`sum_back`), where
    :func:`psum_xla`'s is the identity."""
    if axis_size(group) == 1:
        return x
    return collective(x, "psum", lambda t: _native_sum(t, group),
                      sum_back(group))


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """The native all-reduce of ``t`` in place (no autograd), counted in
    :data:`CALLS`: the gradient reductions of a sharded train step."""
    CALLS["all_reduce"] += 1
    if not _on_span(group, "all-reduce", t):
        dist.all_reduce(t, group=group)
    return t


def all_gather_into_(out: torch.Tensor, x: torch.Tensor,
                     group) -> torch.Tensor:
    """``dist.all_gather_into_tensor``: the ranks' ``x`` into ``out``, rank
    after rank (no autograd), counted in :data:`CALLS`: the FSDP gather of
    a train step on the rank mesh."""
    CALLS["all_gather"] += 1
    if not _on_span(group, "all-gather", out, x):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_(out: torch.Tensor, x: torch.Tensor,
                    group) -> torch.Tensor:
    """``dist.reduce_scatter_tensor``: ``out`` is this rank's chunk of the
    ranks' summed ``x`` (no autograd), counted in :data:`CALLS`: the FSDP
    gradient reduction of a train step on the rank mesh."""
    CALLS["reduce_scatter"] += 1
    if not _on_span(group, "reduce-scatter", out, x):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


# --------------------------------------------------------------------------- #
# Simulated-mesh cost bridge (the port's copy of the NoC cost model).
# --------------------------------------------------------------------------- #
def mesh_psum_costs(p: int, nbytes: int):
    """Simulated mesh allreduce cost per PsumMode (latency cycles, pJ)."""
    from repro_torch.core.noc.collective.cost import psum_mode_costs
    return psum_mode_costs(p, nbytes)


def choose_psum_mode(p: int, nbytes: int,
                     objective: str = "latency") -> PsumMode:
    """Best PsumMode for a ``p``-rank group by simulated mesh cost."""
    from repro_torch.core.noc.collective.cost import choose_psum_mode as _choose
    return _choose(p, nbytes, objective=objective)


# --------------------------------------------------------------------------- #
# ExecutionPlan bridge: how ``mode="auto"`` call sites resolve.
#
# Three regimes, in priority order (as the reference's):
#   1. *Recording*: inside :func:`record_psum_sites` the site's shape is
#      appended to the active list and the stand-in mode ``"ina"`` returned
#      without touching the simulator; the plan builder resolves the
#      deduplicated sites afterwards, once each.
#   2. *Plan-driven*: a :class:`repro_torch.plan.ExecutionPlan` handed down
#      from ``ParallelCtx`` answers from its precomputed per-site table.
#   3. *Planless*: the NoC cost model simulates the candidate strategies for
#      this (span, payload), behind a process-wide memo, so one site shape
#      costs one resolution a process.  The port runs eagerly, so every call
#      resolves, and after the first a resolution is a memo lookup.
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class PsumSite:
    """One ``mode="auto"`` call site."""

    op: str                 # "psum" | "reduce_scatter"
    p: int                  # group span
    nbytes: int             # per-rank partial-sum payload


_TRACE_SITES: Optional[list] = None


@contextmanager
def record_psum_sites():
    """Collect ``mode="auto"`` sites instead of resolving them.

    Inside the context every auto site appends a :class:`PsumSite` to the
    yielded list and runs under a fixed stand-in strategy (``"ina"``; every
    strategy gives the same shapes).  Reentrant.
    """
    global _TRACE_SITES
    prev, sites = _TRACE_SITES, []
    _TRACE_SITES = sites
    try:
        yield sites
    finally:
        _TRACE_SITES = prev


@functools.lru_cache(maxsize=None)
def _fallback_choice(p: int, nbytes: int,
                     objective: str = "latency") -> str:
    """Per-process memo of the cost model's resolution."""
    return choose_psum_mode(p, nbytes, objective=objective)


def resolve_auto_mode(op: str, p: int, nbytes: int,
                      plan: Optional[object] = None) -> str:
    """Resolve one ``mode="auto"`` site (see the regimes above).

    ``plan`` is duck-typed: anything with a ``psum_mode(p, nbytes) ->
    Optional[str]`` method (a :class:`repro_torch.plan.ExecutionPlan`).  A
    plan miss, a site the plan never saw (a prefill chunk is not the
    planned phase's whole sequence), resolves through the cost model under
    the plan's objective, so one run never mixes criteria.  As in the
    reference, a miss costs under the default ``NocConfig``."""
    if _TRACE_SITES is not None:
        _TRACE_SITES.append(PsumSite(op=op, p=p, nbytes=int(nbytes)))
        return "ina"
    if plan is not None:
        mode = plan.psum_mode(p, int(nbytes))
        if mode is not None:
            return mode
        return _fallback_choice(p, int(nbytes),
                                getattr(plan, "objective", "latency"))
    return _fallback_choice(p, int(nbytes))


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# --------------------------------------------------------------------------- #
# Mode dispatch used by the tensor-parallel layers.
# --------------------------------------------------------------------------- #
def psum_with_mode(x: torch.Tensor, group, mode: PsumMode,
                   scatter_axis: int = 0,
                   plan: Optional[object] = None) -> torch.Tensor:
    """Fully-reduced psum under the selected accumulation strategy.

    ``mode="auto"`` resolves for this tensor size and group span from
    ``plan`` where it holds the site, else from the NoC cost model
    (:func:`resolve_auto_mode`).
    """
    if mode == "auto":
        p = axis_size(group)
        mode = resolve_auto_mode("psum", p, nbytes(x), plan)
        if mode == "ina_ring" and x.shape[scatter_axis] % p != 0:
            # The chunked ring needs the scatter axis to divide; fall back
            # to the native in-network reduce, which does not.
            mode = "ina"
    if mode == "eject_inject":
        return ring_psum_eject_inject(x, group)
    if mode == "ina_ring":
        return psum_ina(x, group, scatter_axis)
    if mode in ("ina", "xla"):
        return psum_xla(x, group)
    raise ValueError(f"unknown psum mode: {mode}")


def _reduce_scatter(x: torch.Tensor, group, mode: str,
                    scatter_axis: int) -> torch.Tensor:
    """The reduce-scatter of a resolved ``mode`` on ``p > 1`` ranks."""
    p = axis_size(group)
    if mode == "eject_inject":
        # The baseline has no in-network reduction: full all-reduce, then the
        # caller's shard is sliced out locally (the ejected copy).
        c = x.shape[scatter_axis] // p
        return _chunk(_eject_inject(x, group), axis_index(group), c,
                      scatter_axis)
    if mode == "ina_ring":
        _divides(x, p, scatter_axis)
        return _rs_ina(x, group, scatter_axis)
    if mode in ("ina", "xla"):
        return _native_scatter(x, group, scatter_axis)
    raise ValueError(f"unknown psum mode: {mode}")


def reduce_scatter_with_mode(x: torch.Tensor, group, mode: PsumMode,
                             scatter_axis: int = 0,
                             plan: Optional[object] = None) -> torch.Tensor:
    """Reduce-scattered psum (output stays sharded on ``scatter_axis``).
    The backward gathers the gradient's shards: by the ring under the ring
    modes, by the native all-gather under ``ina`` and ``xla``."""
    p = axis_size(group)
    if mode == "auto":
        mode = resolve_auto_mode("reduce_scatter", p, nbytes(x), plan)
    if mode not in ("eject_inject", "ina_ring", "ina", "xla"):
        raise ValueError(f"unknown psum mode: {mode}")
    if p == 1:
        return x
    scatter_axis %= x.dim()
    return collective(
        x, "reduce_scatter",
        lambda t: _reduce_scatter(t, group, mode, scatter_axis),
        gather_back(group, scatter_axis, ring=mode in RING_MODES))


# --------------------------------------------------------------------------- #
# Analytic per-link traffic (bytes).
# --------------------------------------------------------------------------- #
def per_link_bytes(mode: PsumMode, p: int, nbytes: int,
                   need_full: bool = True) -> float:
    """Bytes crossing each ring link per psum of an ``nbytes`` tensor."""
    if p == 1:
        return 0.0
    if mode == "eject_inject":
        return (p - 1) * nbytes
    if mode in ("ina", "ina_ring", "xla", "auto"):
        rs = (p - 1) / p * nbytes
        return rs * 2 if need_full else rs
    raise ValueError(mode)
