"""Parameter sharding for tensor parallelism (the port's copy of the
reference's leaf rule, ``repro.models.api._leaf_spec``).

A spec is a tuple with one entry a dim: ``None``, a mesh axis name, or a
tuple of names, as a ``jax.sharding.PartitionSpec`` holds them.  The
reference hands its specs to GSPMD; the port cuts each rank's slice itself
(:func:`shard_params`), and so differs from the name rules in three places:

* attention shards whole heads.  The name rule would cut qwen2-1.5b's
  ``wk`` [1536, 256] into half-heads at world 4, which GSPMD repairs by
  moving data and explicit shards cannot.  Rank ``r`` of ``world`` takes
  query heads ``[r H/world, (r+1) H/world)`` and the KV heads they read:
  ``K/world`` of them where ``world`` divides ``K``, else the one KV head
  its query heads share (:func:`head_split`);
* the biases of column-parallel weights are cut with their output dim (the
  reference keeps every vector replicated and lets GSPMD slice the sum);
* the ``data`` (FSDP) axis is span 1: serving and training cut the
  weights over the ``model`` axis only (data parallelism and FSDP are
  ROADMAP.md Queue 1).

The tied embedding follows the rule, ``model`` on V: each rank holds V/world
rows (a vocab-parallel lookup), and the head read from it gives the rank's
V/world logits.

Training also needs the way back: :func:`unshard_params` rebuilds the
logical tree from the ranks' shards (a checkpoint holds it, so a job
resumes at another world size), :func:`leaf_holding` says which leaves a
global gradient norm sums over the ranks and which it counts once, and
:func:`kv_groups` which ranks share a KV head and so sum its gradient.
:func:`fit_spec` is the reference's repair of a spec to a shape.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_COL_NAMES = ("wq", "wk", "wv", "w_up", "w_gate", "w_in", "wr", "wg",
              "lm_head", "w_uk", "w_uv", "w_dkv")
_ROW_NAMES = ("wo", "w_down", "w_out")
_STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers", "xlayers")


# --------------------------------------------------------------------------- #
# the reference's rule
# --------------------------------------------------------------------------- #
def leaf_spec(names: tuple, shape: tuple, mesh_shape: dict | None) -> tuple:
    """Spec of one leaf from its key path ``names`` (``_leaf_spec``)."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    lead = 0
    for n in names:
        if n in _STACKED:
            lead += 1
        elif n == "groups":
            lead += 2
    pre = (None,) * lead
    nd = len(shape) - lead

    def guard(spec_tail: tuple) -> tuple:
        """Drop axes that do not evenly divide the dimension."""
        out = []
        for size, ax in zip(shape[lead:], spec_tail):
            if ax is None or mesh_shape is None:
                out.append(ax)
            else:
                span = mesh_shape.get(ax, 1)
                out.append(ax if size % span == 0 and size >= span else None)
        return pre + tuple(out)

    if nd < 2:
        return pre                                          # norms, biases
    if name == "embed":
        return guard(("model", "data"))                     # [V, D]
    if name in ("w_gate", "w_up", "w_down") and nd == 3:
        return guard(("model", "data", None))               # MoE [E, ., .]
    if parent == "cmix" and name == "wv":
        return guard(("model", "data"))                     # row-parallel
    if name in _ROW_NAMES:
        return guard(("model", "data"))
    if name in _COL_NAMES or nd == 2:
        return guard(("data", "model"))                     # col-parallel
    return pre


# --------------------------------------------------------------------------- #
# explicit shards
# --------------------------------------------------------------------------- #
def head_split(cfg: ModelConfig, rank: int, world: int
               ) -> tuple[range, range]:
    """(query heads, KV heads) of ``rank``: whole heads only."""
    h, k = cfg.n_heads, cfg.n_kv_heads
    if h % world:
        raise ValueError(f"{cfg.name}: {world} ranks do not divide "
                         f"{h} query heads")
    hl = h // world
    q = range(rank * hl, (rank + 1) * hl)
    if k % world == 0:
        kl = k // world
        return q, range(rank * kl, (rank + 1) * kl)
    group = h // k                          # query heads a KV head serves
    if group % hl:
        raise ValueError(f"{cfg.name}: at {world} ranks a rank's {hl} query "
                         f"heads read more than one of {k} KV heads")
    first = q.start // group
    return q, range(first, first + 1)


def local_heads(cfg: ModelConfig, world: int) -> tuple[int, int]:
    """(query heads, KV heads) each rank holds."""
    q, kv = head_split(cfg, 0, world)
    return len(q), len(kv)


def _kv_piece(cfg: ModelConfig, rank: int, world: int) -> tuple[int, int]:
    kv = head_split(cfg, rank, world)[1]
    return kv.start // len(kv), cfg.n_kv_heads // len(kv)


def _cut(names: tuple, ndim: int, cfg: ModelConfig, world: int):
    """How ``world`` ranks hold the leaf at ``names`` (``ndim`` dims):
    ``None`` where each holds it whole, else ``(dim, piece)``: the leaf is
    cut on ``dim`` into ``count`` equal pieces, and ``piece(rank) ->
    (index, count)`` names the rank's.  ``count < world`` where ranks
    share a piece (a KV head read by several ranks' query heads)."""
    if world == 1:
        return None
    name = names[-1]
    own = lambda rank: (rank, world)          # noqa: E731
    if names[-2:-1] == ("attn",):
        if name in ("wq", "bq"):
            return ndim - 1, own
        if name in ("wk", "bk", "wv", "bv"):
            return ndim - 1, lambda rank: _kv_piece(cfg, rank, world)
        if name == "wo":
            return ndim - 2, own
    intent = leaf_spec(names, (1,) * ndim, None)
    if "model" not in intent:
        return None
    if name in ("embed", "lm_head") and (cfg.vocab % world
                                         or cfg.vocab < world):
        # a replicated table serves a whole-vocabulary lookup
        return None
    return intent.index("model"), own


def _walk(fn, tree: dict, names: tuple = ()) -> dict:
    """``fn(names, leaf)`` over a nested dict of leaves."""
    return {k: _walk(fn, v, names + (k,)) if isinstance(v, dict)
            else fn(names + (k,), v) for k, v in tree.items()}


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} runs on one rank in this port; its "
            f"tensor-parallel shards are ROADMAP.md Queue 1")


def shard_params(params: dict, cfg: ModelConfig, rank: int,
                 world: int) -> dict:
    """Cut each full leaf of ``params`` to ``rank``'s slice.

    Column-parallel weights and their biases are cut on the output dim,
    row-parallel weights on the contraction dim, attention by whole heads
    (:func:`head_split`), the embedding (and a tied head) on V.  Each cut
    leaf is a contiguous copy, so the full tree can be freed; every other
    leaf is the same tensor on every rank.  ``world == 1`` returns
    ``params``.  :func:`unshard_params` is the inverse.
    """
    if world == 1:
        return params
    _dense_only(cfg)

    def cut(names, leaf):
        how = _cut(names, leaf.dim(), cfg, world)
        if how is None:
            return leaf
        dim, piece = how
        index, count = piece(rank)
        if leaf.shape[dim] % count or leaf.shape[dim] < count:
            # any weight the rule cuts must be cut, or the row psum would
            # sum ``world`` copies
            raise ValueError(f"{cfg.name}: {world} ranks do not divide "
                             f"{'/'.join(names)} {tuple(leaf.shape)}")
        n = leaf.shape[dim] // count
        return leaf.narrow(dim, index * n, n).clone(
            memory_format=torch.contiguous_format)
    return _walk(cut, params)


def _concat(parts: list, dim: int):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=dim)
    return torch.cat(parts, dim)


def unshard_params(shards: list, cfg: ModelConfig, world: int) -> dict:
    """The full tree from every rank's shard (``shards[rank]``), the inverse
    of :func:`shard_params`: each cut leaf concatenated along its dim, a
    piece that several ranks share (a KV head) taken from the first rank
    that holds it, every whole leaf from rank 0.  Leaves are numpy arrays
    or tensors (a gather to rank 0 can feed it)."""
    if len(shards) != world:
        raise ValueError(f"{len(shards)} shards for {world} ranks")
    if world == 1:
        return shards[0]
    _dense_only(cfg)

    def join(names, leaf):
        how = _cut(names, leaf.ndim, cfg, world)
        if how is None:
            return leaf
        dim, piece = how
        parts = {}
        for rank, tree in enumerate(shards):
            index, count = piece(rank)
            if index not in parts:
                for k in names:
                    tree = tree[k]
                parts[index] = tree
        return _concat([parts[i] for i in range(count)], dim)
    return _walk(join, shards[0])


def map_state(fn, state, path: tuple = ()):
    """``fn(tree, path)`` over each parameter tree of a train state: a dict
    of leaves, or tuples (``AdamWState``'s m and v among them) of such
    dicts and of leaves kept as they are (the step count); ``path`` is the
    tree's indices in the tuples."""
    if isinstance(state, dict):
        return fn(state, path)
    if isinstance(state, tuple):
        parts = [map_state(fn, v, path + (i,)) for i, v in enumerate(state)]
        return type(state)(*parts) if hasattr(state, "_fields") \
            else type(state)(parts)
    return state


def shard_state(state, cfg: ModelConfig, rank: int, world: int):
    """:func:`shard_params` over each parameter tree of ``state`` (params,
    ``AdamWState(step, m, v)``); the step stays whole."""
    return map_state(lambda t, _: shard_params(t, cfg, rank, world), state)


def unshard_state(states: list, cfg: ModelConfig, world: int):
    """The inverse of :func:`shard_state`: ``states[rank]`` each rank's."""
    def join(_, path):
        trees = []
        for st in states:
            for i in path:
                st = st[i]
            trees.append(st)
        return unshard_params(trees, cfg, world)
    return map_state(join, states[0])


def leaf_holding(params: dict, cfg: ModelConfig, rank: int,
                 world: int) -> dict:
    """How this rank holds each leaf of its shard ``params``, for a sum over
    the logical arrays: ``"cut"`` (its piece, summed over the ranks: a KV
    head's too, on the first rank of those that share it), ``"copy"`` (a
    piece another rank of its KV group counts) or ``"whole"`` (the same
    on every rank: counted once)."""
    def kind(names, leaf):
        how = _cut(names, leaf.ndim, cfg, world)
        if how is None:
            return "whole"
        index, _ = how[1](rank)
        first = next(r for r in range(world) if how[1](r)[0] == index)
        return "cut" if first == rank else "copy"
    return _walk(kind, params)


def kv_groups(cfg: ModelConfig, world: int) -> list:
    """The groups of ranks that share one KV head (each holds a copy), in
    KV-head order; empty where every rank holds its own KV heads."""
    if world == 1 or cfg.n_kv_heads % world == 0:
        return []
    groups = {}
    for rank in range(world):
        groups.setdefault(_kv_piece(cfg, rank, world)[0], []).append(rank)
    return [groups[k] for k in sorted(groups)]


# --------------------------------------------------------------------------- #
# fitting specs to shapes (the port's copy of ``repro.parallel.sharding``)
# --------------------------------------------------------------------------- #
def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def fit_spec(spec: tuple, shape: tuple, mesh: dict) -> tuple:
    """Repair one spec against a concrete shape on a mesh ``{name: size}``:
    an axis absent from the mesh, or already placed, is dropped; one that
    does not divide its dim is moved to the largest free dim it divides,
    or dropped.  Trailing ``None`` entries are trimmed, as
    ``PartitionSpec`` holds them."""
    ndim = len(shape)
    entries = (list(spec) + [None] * ndim)[:ndim]
    placed: list[list] = [[] for _ in range(ndim)]
    used: set = set()
    homeless: list = []

    def span(d, ax):
        return math.prod([mesh[a] for a in placed[d]] + [mesh[ax]])

    for d, entry in enumerate(entries):
        for ax in _axes_of(entry):
            if ax not in mesh or ax in used:
                continue                       # absent from mesh / duplicate
            if shape[d] % span(d, ax) == 0 and shape[d] >= span(d, ax):
                placed[d].append(ax)
                used.add(ax)
            else:
                homeless.append(ax)
    for ax in homeless:
        if ax in used:
            continue
        for d in sorted(range(ndim), key=lambda d: -shape[d]):
            if shape[d] % span(d, ax) == 0 and shape[d] >= span(d, ax) \
                    and shape[d] > 1:
                placed[d].append(ax)
                used.add(ax)
                break
    out = [None if not p else p[0] if len(p) == 1 else tuple(p)
           for p in placed]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def fit_specs(specs, shapes, mesh: dict):
    """:func:`fit_spec` over nested dicts: ``specs``' leaves are spec tuples,
    ``shapes``' tensors, arrays or shape tuples of the same structure."""
    if isinstance(specs, dict):
        return {k: fit_specs(v, shapes[k], mesh) for k, v in specs.items()}
    return fit_spec(specs, tuple(getattr(shapes, "shape", shapes)), mesh)
