"""Serve, prefill and forward steps (counterpart of ``repro.parallel.steps``).

The reference builds jitted, sharded artifacts; PyTorch runs eagerly, so
each builder here returns the plain callable in the same kind of record.
Tensor parallelism reaches the model through ``pctx``: its process group
and psum mode (:class:`repro_torch.parallel.tp.ParallelCtx`), with the
parameters a rank's shards.  Greedy decoding takes the first maximal
logit, as ``jnp.argmax``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.api import Model, cache_batch_axes
from repro_torch.parallel.tp import ParallelCtx


@dataclasses.dataclass
class ServeStep:
    """``fn(params, batch, cache) -> (next_tok [B], cache, logits [B, V])``
    with ``batch = {"tokens": [B, 1], "pos": int}``: one batch, one
    position.  The logits of the last position are returned as well, for
    the comparisons the legacy loop reports."""
    fn: Callable


def build_serve_step(model: Model,
                     pctx: Optional[ParallelCtx] = None) -> ServeStep:
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
    and mask are per row, and every projection treats rows independently."""
    fn: Callable
    cache_batch_axes: dict


def build_paged_serve_step(model: Model,
                           pctx: Optional[ParallelCtx] = None
                           ) -> PagedServeStep:
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
                       pctx: Optional[ParallelCtx] = None) -> PrefillStep:
    if not model.has_prefill:
        raise NotImplementedError(
            f"family {model.cfg.family!r} has no batched prefill")

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


def build_prefill(model: Model, pctx: Optional[ParallelCtx] = None) -> Prefill:
    def fwd(params, batch):
        return model.forward(params, batch, pctx)
    return Prefill(fn=fwd)
