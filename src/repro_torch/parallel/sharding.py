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
* the ``data`` (FSDP) axis is span 1: serving keeps whole weights a rank.

The tied embedding follows the rule, ``model`` on V: each rank holds V/world
rows (a vocab-parallel lookup), and the head read from it gives the rank's
V/world logits.
"""
from __future__ import annotations

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


def shard_params(params: dict, cfg: ModelConfig, rank: int,
                 world: int) -> dict:
    """Cut each full leaf of ``params`` to ``rank``'s slice.

    Column-parallel weights and their biases are cut on the output dim,
    row-parallel weights on the contraction dim, attention by whole heads
    (:func:`head_split`), the embedding (and a tied head) on V.  Each cut
    leaf is a contiguous copy, so the full tree can be freed; every other
    leaf is the same tensor on every rank.  ``world == 1`` returns
    ``params``.
    """
    if world == 1:
        return params
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} runs on one rank in this port; its "
            f"tensor-parallel shards are ROADMAP.md Queue 1")
    hd = cfg.resolved_head_dim
    q, kv = head_split(cfg, rank, world)
    cols = {"wq": q, "bq": q, "wk": kv, "bk": kv, "wv": kv, "bv": kv}

    def piece(leaf, dim, start, length):
        return leaf.narrow(dim, start, length).clone(
            memory_format=torch.contiguous_format)

    def cut(names, leaf):
        name = names[-1]
        if names[-2:-1] == ("attn",) and name in cols:
            r = cols[name]
            return piece(leaf, leaf.dim() - 1, r.start * hd, len(r) * hd)
        if names[-2:-1] == ("attn",) and name == "wo":
            return piece(leaf, leaf.dim() - 2, q.start * hd, len(q) * hd)
        spec = leaf_spec(names, tuple(leaf.shape), {"data": 1, "model": world})
        if "model" not in spec:
            # A replicated table serves a whole-vocabulary lookup; any other
            # weight the rule cuts must be cut, or the row psum would sum
            # ``world`` copies.
            if name not in ("embed", "lm_head") and \
                    "model" in leaf_spec(names, tuple(leaf.shape), None):
                raise ValueError(f"{cfg.name}: {world} ranks do not divide "
                                 f"{'/'.join(names)} {tuple(leaf.shape)}")
            return leaf
        dim = spec.index("model")
        n = leaf.shape[dim] // world
        return piece(leaf, dim, rank * n, n)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        return cut(names, node)
    return walk(params, ())

