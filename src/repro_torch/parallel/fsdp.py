"""The FSDP gather, layer by layer (the part of the reference's step that
GSPMD writes inside its scanned, checkpointed layer body).

A rank at data rank ``d`` of ``D`` holds its model shard cut into ``D``
pieces on :func:`~repro_torch.parallel.sharding.data_cut`'s dim.  A
stacked leaf's pieces are split into per-layer tensors
(:func:`layer_pieces`; a list over each of
:data:`~repro_torch.models.layers.STACK_AXES`), and each tensor with a
data dim is named in the running step's :class:`Gatherer`.  Then:

  * in training, :func:`repro_torch.models.transformer.remat` gathers a
    layer's pieces inside the function it checkpoints (:func:`in_layer`):
    the recompute gathers them again, so nothing whole outlives its layer,
    and the gather's backward reduce-scatters the layer's gradient over
    ``data`` (:class:`Gather`);
  * in serving, :func:`repro_torch.models.transformer.layer` gathers the
    slices it returns (:func:`at_slice`), as every decode loop takes its
    layers through it;
  * the leaves outside the layers (the embedding, the head, ``ln_f``,
    zamba2's shared block, whisper's positional tables), and a stacked
    leaf that ``data`` cuts on its stacked dim (zamba2's ``inv_norms``
    at the reduced config: each row lives on one data rank, and the
    gather brings every owner's rows), are gathered once a step by
    :func:`gather_tree`, through the same Function.

Each gather is one native all-gather over ``data`` a dtype among the
pieces (the psum modes are the model axis's; GSPMD's data-axis collectives
are native in the reference too), counted in
:data:`repro_torch.core.collectives.CALLS`; :data:`GATHERED` keeps the
bytes of whole tensors this rank holds at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core import collectives as C
from repro_torch.models.layers import STACK_AXES
from repro_torch.parallel import sharding

#: bytes of the gathered whole tensors' storage alive on this rank at the
#: last gather, and the most alive at once since :func:`reset_gathered`
#: (a storage lives as long as any alias of it: a checkpoint's recompute
#: keeps detached aliases of the tensors a layer's backward reads)
GATHERED = {"live": 0, "peak": 0}
_STORAGES: list = []


def _live() -> int:
    _STORAGES[:] = [(ref, n) for ref, n in _STORAGES if not ref.expired()]
    return sum(n for _, n in _STORAGES)


def reset_gathered() -> None:
    GATHERED["live"] = GATHERED["peak"] = _live()


def _track(tensors: list) -> list:
    _live()
    known = {ref.cdata for ref, _ in _STORAGES}
    for t in tensors:
        ref = StorageWeakRef(t.untyped_storage())
        if ref.cdata not in known:
            known.add(ref.cdata)
            _STORAGES.append((ref, t.untyped_storage().nbytes()))
    GATHERED["live"] = _live()
    GATHERED["peak"] = max(GATHERED["peak"], GATHERED["live"])
    return tensors


def _buckets(items: list) -> list:
    """``items`` (tuples whose first entry is a tensor) in buckets of one
    dtype each, in order of first appearance."""
    out = {}
    for item in items:
        out.setdefault(item[0].dtype, []).append(item)
    return list(out.values())


def _rows(g: torch.Tensor, dim: int, dd: int) -> torch.Tensor:
    """``g`` cut into ``dd`` pieces on ``dim``, piece i flattened in row
    i: the input of a reduce-scatter that gives rank i piece i."""
    shape = (*g.shape[:dim], dd, g.shape[dim] // dd, *g.shape[dim + 1:])
    return g.reshape(shape).movedim(dim, 0).reshape(dd, -1)


def _all_gather(pieces: tuple, dims: tuple, group) -> list:
    dd = C.axis_size(group)
    whole = [None] * len(pieces)
    for bucket in _buckets([(p, dim, i) for i, (p, dim)
                            in enumerate(zip(pieces, dims))]):
        flat = torch.cat([p.reshape(-1) for p, _, _ in bucket])
        rows = C.all_gather_into_(flat.new_empty(dd * flat.numel()), flat,
                                  group).view(dd, -1)
        for (p, dim, i), part in zip(bucket, rows.split(
                [p.numel() for p, _, _ in bucket], dim=1)):
            shape = list(p.shape)
            shape[dim] *= dd
            w = part.reshape(dd, *p.shape).movedim(0, dim).reshape(shape)
            # a view of the bucket's buffer would keep all of it alive
            whole[i] = w.clone() if len(bucket) > 1 and w._base is not None \
                else w
    return _track(whole)


def _reduce_scatter(grads: list, dims: tuple, group) -> list:
    dd = C.axis_size(group)
    out = [None] * len(grads)
    for bucket in _buckets([(g, dim, i) for i, (g, dim)
                            in enumerate(zip(grads, dims))]):
        rows = torch.cat([_rows(g, dim, dd) for g, dim, _ in bucket], dim=1)
        mine = C.reduce_scatter_(rows.new_empty(rows.shape[1]),
                                 rows.reshape(-1), group)
        for (g, dim, i), part in zip(bucket, mine.split(
                [g.numel() // dd for g, _, _ in bucket])):
            shape = list(g.shape)
            shape[dim] //= dd
            out[i] = part.view(shape)
    return out


class Gather(torch.autograd.Function):
    """``apply(group, dims, *pieces)``: each piece gathered whole over the
    ``data`` ``group`` on its dim (one all-gather a dtype); the backward
    reduce-scatters each whole gradient back to this rank's piece, summed
    over ``data`` (one reduce-scatter a dtype)."""

    @staticmethod
    def forward(ctx, group, dims: tuple, *pieces):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [(p.shape, p.dtype, p.device) for p in pieces]
        return tuple(_all_gather(pieces, dims, group))

    @staticmethod
    def backward(ctx, *grads):
        dd = C.axis_size(ctx.group)
        full = []
        for g, dim, (shape, dtype, device) in zip(grads, ctx.dims,
                                                  ctx.shapes):
            if g is None:                   # a piece the loss never read
                shape = list(shape)
                shape[dim] *= dd
                g = torch.zeros(shape, dtype=dtype, device=device)
            full.append(g.contiguous())
        return (None, None) + tuple(_reduce_scatter(full, ctx.dims,
                                                    ctx.group))


def gather(pieces: list, dims: list, group) -> list:
    """The whole tensors of ``pieces`` (cut on ``dims``) over ``group``,
    through :class:`Gather` where autograd records."""
    if not pieces:
        return []
    if torch.is_grad_enabled() and any(p.requires_grad for p in pieces):
        return list(Gather.apply(group, tuple(dims), *pieces))
    return _all_gather(tuple(pieces), tuple(dims), group)


# --------------------------------------------------------------------------- #
# a step's pieces
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Gatherer:
    """The running step's FSDP pieces: ``dims`` maps each piece (by
    ``id``) to the dim its data cut is on; ``group`` is the ``data``
    axis's.  ``eager`` (serving) gathers each layer's slices where
    :func:`~repro_torch.models.transformer.layer` takes them; else
    (training) :func:`in_layer` gathers them inside the checkpointed
    body."""
    group: object
    dims: dict
    eager: bool = False


_ACTIVE: list = []


@contextlib.contextmanager
def gathering(g: Optional[Gatherer]):
    """Run a step's model calls with ``g``'s pieces gathered layer by
    layer (``None``: nothing is cut over ``data``)."""
    if g is None or not g.dims:
        yield
        return
    _ACTIVE.append(g)
    try:
        yield
    finally:
        _ACTIVE.pop()


def _find(node, dims: dict, lists: bool, found: list) -> None:
    if isinstance(node, dict):
        for v in node.values():
            _find(v, dims, lists, found)
    elif isinstance(node, list):
        for v in node if lists else ():
            _find(v, dims, lists, found)
    elif id(node) in dims:
        found.append(node)


def _swap(node, whole: dict):
    if isinstance(node, dict):
        return {k: _swap(v, whole) for k, v in node.items()}
    if isinstance(node, list):
        return [_swap(v, whole) for v in node]
    return whole.get(id(node), node)


def _gathered(tree, g: Gatherer, lists: bool = True):
    """``tree`` (dicts and lists) with every piece ``g`` names replaced by
    its whole tensor (none inside a list where ``lists`` is false): one
    :func:`gather` for all of them.  (Module-level walks: a recursive
    closure would keep the whole tensors in a reference cycle past their
    layer.)"""
    found = []
    _find(tree, g.dims, lists, found)
    if not found:
        return tree
    return _swap(tree, dict(zip(map(id, found), gather(
        found, [g.dims[id(p)] for p in found], g.group))))


def at_slice(lp: dict) -> dict:
    """A layer's slices as :func:`~repro_torch.models.transformer.layer`
    returns them: gathered whole under a serving step's :class:`Gatherer`,
    else as they are."""
    if _ACTIVE and _ACTIVE[-1].eager:
        return _gathered(lp, _ACTIVE[-1])
    return lp


def in_layer(fn: Callable) -> Callable:
    """``fn(lp, x, *args)`` with ``lp``'s pieces gathered first, under a
    training step's :class:`Gatherer`; ``fn`` itself elsewhere."""
    if not _ACTIVE or _ACTIVE[-1].eager:
        return fn
    g = _ACTIVE[-1]

    def body(lp, x, *args):
        return fn(_gathered(lp, g), x, *args)
    return body


def _lead(key: str) -> int:
    return STACK_AXES.get(key, 0)


def layer_pieces(params: dict, cfg, world, leaf: Callable = lambda p: p
                 ) -> tuple[dict, dict]:
    """``(tree, dims)``: ``params`` (this rank's pieces of ``world = (D,
    M)``) with each stacked leaf split into its layer slices (a list over
    each of :data:`~repro_torch.models.layers.STACK_AXES`; ``groups`` [G,
    per, ...] a list of G lists of ``per``) and every tensor passed
    through ``leaf``; ``dims`` maps each resulting tensor that ``data``
    cuts (by ``id``) to its dim.  A leaf that ``data`` cuts on a stacked
    dim (zamba2's ``inv_norms`` [G, D] where D divides the groups: each
    group's row lives on one data rank) stays whole: :func:`gather_tree`
    gathers it with the leaves outside the layers, every owner's rows at
    once."""
    dims = {}
    return _split_tree(params, (), cfg, tuple(world), leaf, dims), dims


def _split_tree(node, names: tuple, cfg, world: tuple, leaf, dims: dict):
    if isinstance(node, dict):
        return {k: _split_tree(v, names + (k,), cfg, world, leaf, dims)
                for k, v in node.items()}
    lead = _lead(names[0])
    dim = sharding.data_cut(names, cfg, world)
    if dim is not None and dim < lead:
        lead = 0
    return _split(node, lead, None if dim is None else dim - lead, leaf,
                  dims)


def _split(p, axes: int, dim, leaf, dims: dict):
    if axes:
        return [_split(q, axes - 1, dim, leaf, dims) for q in p]
    t = leaf(p)
    if dim is not None:
        dims[id(t)] = dim
    return t


def gather_tree(tree: dict, dims: dict, group) -> dict:
    """``tree`` (:func:`layer_pieces`' form) with its pieces outside the
    per-layer lists (the leaves outside the layers, and a stacked leaf cut
    on its stacked dim) gathered whole: one :func:`gather` a step."""
    if not dims:
        return tree
    return _gathered(tree, Gatherer(group, dims), lists=False)


def _named(tree: dict, names: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, names + (k,))
        else:
            yield names + (k,), v


def gather_shard(params: dict, cfg, world, group) -> dict:
    """The model shard from this rank's pieces of ``world = (D, M)``: every
    leaf that ``data`` cuts gathered whole at once (one all-gather a
    dtype), the stacked leaves as they are stacked."""
    cut = ((p, sharding.data_cut(names, cfg, tuple(world)))
           for names, p in _named(params))
    return _gathered(params, Gatherer(group, {id(p): d for p, d in cut
                                              if d is not None}))


# --------------------------------------------------------------------------- #
# serving on the rank mesh
# --------------------------------------------------------------------------- #
def serving_params(params: dict, cfg, pctx, data_group) -> tuple[dict, dict]:
    """``(weights, dims)`` a serving rank holds: its FSDP pieces of the
    full ``params`` at ``(data rank, model rank)`` with each stacked leaf
    split into its layers (:func:`layer_pieces`; ``dims`` names the pieces
    :func:`serving` gathers), or, under ``pctx.serve_replicated_params``
    (the reference strips the data axes from the params' specs), the
    model shard, gathered once here, and no dims."""
    dd = C.axis_size(data_group)
    world = (dd, pctx.world)
    pieces = sharding.shard_params(params, cfg, (C.axis_index(data_group),
                                                 pctx.rank), world)
    if dd == 1:
        return pieces, {}
    if pctx.serve_replicated_params:
        return gather_shard(pieces, cfg, world, data_group), {}
    return layer_pieces(pieces, cfg, world)


@contextlib.contextmanager
def serving(params: dict, dims: dict, group):
    """A serving step's weights: the leaves outside the layers gathered
    whole, each layer's where the step takes it
    (:func:`~repro_torch.models.transformer.layer`)."""
    g = Gatherer(group, dims, eager=True)
    with torch.no_grad(), gathering(g):
        yield gather_tree(params, dims, group)
