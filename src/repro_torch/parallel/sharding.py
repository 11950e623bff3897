"""Parameter sharding for tensor parallelism (the port's copy of the
reference's leaf rule, ``repro.models.api._leaf_spec``).

A spec is a tuple with one entry a dim: ``None``, a mesh axis name, or a
tuple of names, as a ``jax.sharding.PartitionSpec`` holds them.  The
reference hands its specs to GSPMD, which repairs a layout the computation
cannot use by moving data; the port cuts each rank's slice itself
(:func:`shard_params`), and so differs from the name rules where a rank
could not compute with the rule's shard:

* attention shards whole heads.  The name rule would cut qwen2-1.5b's
  ``wk`` [1536, 256] into half-heads at world 4.  Rank ``r`` of ``world``
  takes query heads ``[r H/world, (r+1) H/world)`` and the KV heads they
  read: ``K/world`` of them where ``world`` divides ``K``, else the one KV
  head its query heads share (:func:`head_split`).  The dense and moe
  families (:data:`UNEVEN_HEAD_FAMILIES`) also take a world that does not
  divide the query heads, or whose ranks' query heads straddle KV heads,
  where the reference's ``fit_specs`` would drop or move the ``model``
  axis: each rank gets ``ceil(H/world)`` query-head slots and holds the
  real heads ``[r hl, min(H, (r+1) hl))`` of them (the last ranks may hold
  none) and every KV head they read, its parameters those heads only.  A
  rank whose query heads read their KV heads in other than the even GQA
  map expands its K/V to one head a query head after the projection
  (:func:`kv_index`), so its cache holds that many (:func:`cache_heads`);
  a rank with no head launches no attention and adds zero to the row
  psum.  Any other family raises ValueError naming it.  MLA (deepseek) cuts
  ``wq``, ``w_uk`` and ``w_uv`` on their output dim and ``wo`` on its
  input dim by whole heads;
* RWKV6's time mix shards whole heads too (:data:`_HEAD_CUTS`): ``wr``,
  ``wk``, ``wv``, ``wg`` and the decay LoRA's ``w_lora_b`` on their output
  dim, the base decay ``w0`` and the output norm ``ln_x`` on d_model, the
  bonus ``u`` [H, hd] on H (the rule would cut hd), ``wo`` on its input
  dim;
* zamba2's Mamba2 cuts whole heads (80 heads of 64 for zamba2-2.7b) through
  its packed leaves, whose last dim holds segments (:func:`_segments`):
  ``w_in`` [D, 2 d_inner + 2N + H] is z | x | B | C | dt, and rank ``r``
  takes z, x and dt of its heads and B and C whole (ngroups is 1: every
  head reads them); ``conv_w`` [K, d_inner + 2N] and ``conv_b`` are x |
  B | C alike.  A rank's ``w_in`` is stored as a view of a buffer whose
  rows are padded to a multiple of 8 elements (zamba2's at world 4 is
  2708 wide), so that TMA can step over them and the product keeps its
  TMA launch.  ``A_log``, ``D``, ``dt_bias`` [H] and ``gate_norm``
  [d_inner] are cut by heads (:data:`_HEAD_CUTS`; the rule leaves vectors
  whole), ``w_out`` on its input dim by the rule;
* zamba2's shared block cuts its own heads (``shared_attn_heads``, the
  same count for queries and KV), by the attention rule above; vlm's and
  whisper's cross-attention (``xattn``) goes through the attention rule
  too, so at 4 ranks of the reduced 4:2 heads a KV head is shared, as in
  self-attention;
* some leaves are held whole on every rank although the rule cuts them
  (:data:`_WHOLE`): the MoE ``router`` [D, E] (every rank routes every
  token alike), RWKV6's token-shift ``mu`` of both mixes and the decay
  LoRA's ``w_lora_a`` (each needs the whole of x), the channel mix's
  ``wr`` (its gate multiplies the whole summed row), MLA's ``w_dkv``
  (the latent's RMS norm needs the whole latent, which every rank expands
  into its own heads), zamba2's ``inv_norms`` [G, 2D] (a norm's weights,
  which the rule reads as a 2-d column leaf) and its shared block's
  ``wo_down`` and ``mlp_down`` [2D, D] (each multiplies a row that the
  psum before it made whole), and whisper's ``pos_dec`` [max_seq, D] (a
  table added to the whole residual stream);
* the biases of column-parallel weights are cut with their output dim (the
  reference keeps every vector replicated and lets GSPMD slice the sum);
* serving cuts the weights over the ``model`` axis only.

Routed experts ``w_gate``/``w_up``/``w_down`` [E, ., .] follow the rule:
cut on E, expert parallelism.  The embedding follows the rule, ``model``
on V: each rank holds V/world rows (a vocab-parallel lookup), and a tied
head read from it gives the rank's V/world logits; a vocabulary the world
does not divide (whisper's 51865) keeps the table whole.  Every family
shards (:data:`SHARDED_FAMILIES`).

Training adds the ``data`` axis (FSDP).  A rank at ``(data d, model m)`` of
``(D, M)`` holds its model shard cut once more into D equal pieces, piece
d, on the dim where the reference places ``data``
(:func:`data_cut`: ``fit_spec`` of the name rule on the logical shape,
as ``build_train_step`` fits ``param_specs(shapes, mesh)``): ``wq``,
``w_up``, ``lm_head`` on their input dim, ``wo``, ``w_down``, ``embed`` on
d_model, a stacked ``[L, ...]`` leaf never on L.  A leaf the rule gives no
``data`` entry (norms, biases), or whose model shard D does not divide,
is held whole over ``data``.  ``pod`` cuts no parameter.  Every function
here takes a rank and world of the ``model`` axis alone (an int), or the
pair ``(data, model)`` of the rank mesh, whose flat rank is
``d * M + m``; data span 1 is the model axis alone.

Training also needs the way back: :func:`unshard_params` rebuilds the
logical tree from the ranks' shards (a checkpoint holds it, so a job
resumes at another world size), :func:`leaf_holding` says which leaves a
global gradient norm sums over the ranks and which it counts once, and
:func:`kv_groups` which ranks share a KV head and so sum its gradient.
:func:`fit_spec` is the reference's repair of a spec to a shape.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_COL_NAMES = ("wq", "wk", "wv", "w_up", "w_gate", "w_in", "wr", "wg",
              "lm_head", "w_uk", "w_uv", "w_dkv")
_ROW_NAMES = ("wo", "w_down", "w_out")
_STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers", "xlayers")
# (parent, name) of the leaves every rank holds whole, although the name
# rule cuts them (the module docstring says why)
_WHOLE = {("mlp", "router"), ("tmix", "mu"), ("tmix", "w_lora_a"),
          ("cmix", "mu"), ("cmix", "wr"), ("attn", "w_dkv"),
          ("", "inv_norms"), ("shared", "wo_down"), ("shared", "mlp_down"),
          ("", "pos_dec")}
# (parent, name) -> the dim, counted from the last, of the leaves cut by
# whole heads outside the GQA attention: RWKV6's time mix, MLA's heads and
# Mamba2's per-head vectors
_HEAD_CUTS = {("tmix", "wr"): 1, ("tmix", "wk"): 1, ("tmix", "wv"): 1,
              ("tmix", "wg"): 1, ("tmix", "w_lora_b"): 1, ("tmix", "w0"): 1,
              ("tmix", "ln_x"): 1, ("tmix", "u"): 2, ("tmix", "wo"): 2,
              ("attn", "w_uk"): 1, ("attn", "w_uv"): 1,
              ("mamba", "A_log"): 1, ("mamba", "D"): 1,
              ("mamba", "dt_bias"): 1, ("mamba", "gate_norm"): 1}
# (parent, name) -> the segments of the last dim of Mamba2's packed leaves
# (:func:`_segments`): z, x and dt cut by heads, B and C whole
_SEGMENTED = {("mamba", "w_in"): "zxBCt", ("mamba", "conv_w"): "xBC",
              ("mamba", "conv_b"): "xBC"}
# the attention parents the head rule cuts
_ATTN = ("attn", "xattn")
# the families whose weights this module cuts over ``model``
SHARDED_FAMILIES = ("dense", "ssm", "moe", "mla_moe", "hybrid", "encdec",
                    "vlm")
# the families whose attention takes the uneven head cut (the module
# docstring); every other raises where the cut is not even
UNEVEN_HEAD_FAMILIES = ("dense", "moe")


# --------------------------------------------------------------------------- #
# the reference's rule
# --------------------------------------------------------------------------- #
def _lead(names: tuple) -> int:
    """The stacked leading dims of the leaf at ``names``."""
    return sum(1 if n in _STACKED else 2 if n == "groups" else 0
               for n in names)


def leaf_spec(names: tuple, shape: tuple, mesh_shape: dict | None) -> tuple:
    """Spec of one leaf from its key path ``names`` (``_leaf_spec``)."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    lead = _lead(names)
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
def attn_heads(cfg: ModelConfig, names: tuple = ()) -> tuple[int, int]:
    """(query heads, KV heads) of the attention whose leaves sit at
    ``names``: zamba2's shared block (under ``shared``) has
    ``shared_attn_heads`` of both, every other attention the config's."""
    if names[:1] == ("shared",):
        return cfg.shared_attn_heads, cfg.shared_attn_heads
    return cfg.n_heads, cfg.n_kv_heads


def _uneven_refused(cfg: ModelConfig, why: str) -> ValueError:
    return ValueError(f"{cfg.name}: {why}; the {cfg.family} family takes "
                      f"no uneven head cut (sharding.UNEVEN_HEAD_FAMILIES)")


def head_split(cfg: ModelConfig, rank: int, world: int,
               heads: tuple[int, int] | None = None) -> tuple[range, range]:
    """(query heads, KV heads) of ``rank``: whole heads only.  ``heads``
    is the attention's (query, KV) head count (:func:`attn_heads`), the
    config's by default.  Where ``world`` divides the query heads and
    each rank's read one KV head (or ``K/world`` of them), the ranks' cuts
    are equal; otherwise, in :data:`UNEVEN_HEAD_FAMILIES`, rank ``r``
    holds the query heads ``[r hl, min(H, (r+1) hl))`` of ``hl =
    ceil(H/world)`` slots (none past the last head) and every KV head they
    read, and any other family raises."""
    h, k = heads or attn_heads(cfg)
    if h % world == 0 and k % world == 0:
        hl, kl = h // world, k // world
        return (range(rank * hl, (rank + 1) * hl),
                range(rank * kl, (rank + 1) * kl))
    hl = -(-h // world)
    q = range(min(h, rank * hl), min(h, (rank + 1) * hl))
    group = h // k                          # query heads a KV head serves
    uneven = cfg.family in UNEVEN_HEAD_FAMILIES
    if h % world and not uneven:
        raise _uneven_refused(cfg, f"{world} ranks do not divide {h} query "
                                   f"heads")
    if h % world == 0 and group % hl and not uneven:
        raise _uneven_refused(cfg, f"at {world} ranks a rank's {hl} query "
                                   f"heads read more than one of {k} KV "
                                   f"heads")
    if not q:
        return q, range(0)
    return q, range(q.start // group, (q.stop - 1) // group + 1)


def kv_index(cfg: ModelConfig, rank: int, world: int,
             heads: tuple[int, int] | None = None) -> tuple | None:
    """The local KV head each of ``rank``'s query heads reads, where the
    rank's query heads read its KV heads in other than the even GQA map
    (``len(q) / len(kv)`` consecutive query heads a KV head): a rank of
    the uneven cut whose query heads straddle KV heads unevenly
    (qwen3-14b's rank 1 at 16 reads KV heads 0, 0 and 1).  Its K/V are
    expanded to one head a query head through this index.  ``None``
    where the even map holds."""
    h, k = heads or attn_heads(cfg)
    q, kv = head_split(cfg, rank, world, heads)
    if not q:
        return None
    group = h // k
    idx = tuple(i // group - kv.start for i in q)
    n, rest = divmod(len(q), len(kv))
    if rest == 0 and idx == tuple(j // n for j in range(len(q))):
        return None
    return idx


def cache_heads(cfg: ModelConfig, rank: int, world: int,
                heads: tuple[int, int] | None = None) -> int:
    """The KV heads ``rank``'s decode cache holds: its KV heads, or one a
    query head where they are expanded (:func:`kv_index`); none on a rank
    with no head."""
    q, kv = head_split(cfg, rank, world, heads)
    return len(q) if kv_index(cfg, rank, world, heads) is not None \
        else len(kv)


def local_heads(cfg: ModelConfig, world: int,
                heads: tuple[int, int] | None = None,
                rank: int = 0) -> tuple[int, int]:
    """(query heads, the KV heads of its cache, :func:`cache_heads`) that
    ``rank`` holds; under an even cut every rank's are rank 0's."""
    q, _ = head_split(cfg, rank, world, heads)
    return len(q), cache_heads(cfg, rank, world, heads)


def _ssm_heads(cfg: ModelConfig) -> int:
    """The recurrent heads: RWKV6's over d_model, Mamba2's over d_inner."""
    width = cfg.ssm.expand * cfg.d_model if cfg.family == "hybrid" \
        else cfg.d_model
    return width // cfg.ssm.head_dim


def local_ssm_heads(cfg: ModelConfig, world: int) -> int:
    """The RWKV6 time-mix or Mamba2 heads each rank of ``world`` holds."""
    check_heads(cfg, world)
    return _ssm_heads(cfg) // world


def _q_piece(cfg: ModelConfig, rank: int, world: int,
             heads: tuple[int, int] | None = None) -> tuple[int, int, int]:
    """``(start, stop, units)``: ``rank``'s query heads of all of them."""
    q = head_split(cfg, rank, world, heads)[0]
    return q.start, q.stop, (heads or attn_heads(cfg))[0]


def _kv_piece(cfg: ModelConfig, rank: int, world: int,
              heads: tuple[int, int] | None = None) -> tuple[int, int, int]:
    """``(start, stop, units)``: ``rank``'s KV heads of all of them."""
    kv = head_split(cfg, rank, world, heads)[1]
    return kv.start, kv.stop, (heads or attn_heads(cfg))[1]


def check_heads(cfg: ModelConfig, world: int) -> None:
    """Raise unless ``world`` divides every head count a head cut splits:
    the recurrent heads (ssm; hybrid's Mamba2) and the attention's (hybrid:
    the shared block's).  The attention of :data:`UNEVEN_HEAD_FAMILIES`
    takes any world (:func:`head_split`)."""
    if cfg.family in UNEVEN_HEAD_FAMILIES:
        return
    counts = {"ssm": (_ssm_heads,),
              "hybrid": (_ssm_heads, lambda c: c.shared_attn_heads)}.get(
        cfg.family, (lambda c: c.n_heads,))
    for count in counts:
        if count(cfg) % world:
            raise _uneven_refused(cfg, f"{world} ranks do not divide "
                                       f"{count(cfg)} heads")


def _segments(names: tuple, cfg: ModelConfig, world: int):
    """``((size, cut), ...)`` along the last dim of a Mamba2 packed leaf
    at ``names`` (z | x | B | C | dt of ``w_in``, x | B | C of the conv)
    at more than one rank, each segment cut into ``world`` equal pieces
    (rank r's is piece r) or held whole; ``None`` for any other leaf."""
    order = _SEGMENTED.get(tuple(names[-2:]))
    if world == 1 or order is None:
        return None
    check_heads(cfg, world)
    d_inner = cfg.ssm.expand * cfg.d_model
    size = {"z": (d_inner, True), "x": (d_inner, True),
            "B": (cfg.ssm.d_state, False), "C": (cfg.ssm.d_state, False),
            "t": (_ssm_heads(cfg), True)}
    return tuple(size[c] for c in order)


def _take_segments(leaf, segs: tuple, rank: int, world: int):
    """Rank ``rank``'s shard of a segmented leaf (:func:`_segments`): its
    piece of each cut segment and each whole one, in order, stored as a
    view of a buffer whose rows are padded to a multiple of 8 elements."""
    parts, at = [], 0
    for size, cut in segs:
        n = size // world if cut else size
        parts.append(leaf.narrow(-1, at + (rank * n if cut else 0), n))
        at += size
    if at != leaf.shape[-1]:
        raise ValueError(f"segments {segs} of a leaf {tuple(leaf.shape)}")
    width = sum(p.shape[-1] for p in parts)
    buf = leaf.new_empty(*leaf.shape[:-1], -(-width // 8) * 8)
    piece = buf.narrow(-1, 0, width)
    piece.copy_(torch.cat(parts, -1))
    return piece


def _join_segments(pieces: list, segs: tuple, world: int):
    """The logical leaf from every rank's segmented shard (``pieces[r]``):
    each cut segment's pieces in rank order, each whole one from rank 0."""
    parts, at = [], 0
    for size, cut in segs:
        n = size // world if cut else size
        parts += [p[..., at:at + n] for p in (pieces if cut else pieces[:1])]
        at += n
    return _concat(parts, -1)


def segment_runs(names: tuple, cfg: ModelConfig, world: int):
    """``((cut, start, size), ...)``: the runs of a rank's shard of the
    segmented leaf at ``names`` (:func:`_segments`) along its last dim,
    each its piece of a cut segment (``cut`` True) or a whole segment that
    every rank holds (Mamba2's B and C); ``None`` for any other leaf or at
    one rank."""
    segs = _segments(names, cfg, world)
    if segs is None:
        return None
    runs, at = [], 0
    for size, cut in segs:
        n = size // world if cut else size
        runs.append((cut, at, n))
        at += n
    return tuple(runs)


def _cut(names: tuple, ndim: int, cfg: ModelConfig, world: int):
    """How ``world`` ranks hold the leaf at ``names`` (``ndim`` dims):
    ``None`` where each holds it whole, else ``(dim, piece)``: the leaf is
    cut on ``dim`` into ``units`` equal units, and ``piece(rank) ->
    (start, stop, units)`` names the rank's run of them.  Ranks share a
    unit where several read one KV head; under the uneven head cut the
    runs differ in length (a rank's KV heads, or none).  A segmented leaf
    (:func:`_segments`) has no such form and raises."""
    if world == 1:
        return None
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    own = lambda rank: (rank, rank + 1, world)          # noqa: E731
    if (parent, name) in _WHOLE:
        return None
    if (parent, name) in _SEGMENTED:
        raise NotImplementedError(f"{'/'.join(names)} is cut in segments "
                                  f"(sharding._segments)")
    if (parent, name) in _HEAD_CUTS:
        check_heads(cfg, world)
        return ndim - _HEAD_CUTS[parent, name], own
    if parent in _ATTN:
        heads = attn_heads(cfg, names)
        if name in ("wq", "bq", "wo"):
            dim = ndim - 2 if name == "wo" else ndim - 1
            if cfg.family in UNEVEN_HEAD_FAMILIES:
                return dim, lambda rank: _q_piece(cfg, rank, world, heads)
            if name != "wo":
                check_heads(cfg, world)
            return dim, own
        if name in ("wk", "bk", "wv", "bv"):
            return ndim - 1, lambda rank: _kv_piece(cfg, rank, world, heads)
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


def _coord(rank, world) -> tuple[int, int, int, int]:
    """``(d, m, D, M)``: data and model rank and span of ``rank`` of
    ``world``.  An int ``world`` is the model axis alone (``D = 1``); a
    pair ``(D, M)`` is the rank mesh, with ``rank`` the pair ``(d, m)`` or
    the flat rank ``d * M + m``."""
    if isinstance(world, (tuple, list)):
        dd, mm = world
        d, m = rank if isinstance(rank, (tuple, list)) else divmod(rank, mm)
        return d, m, dd, mm
    if isinstance(rank, (tuple, list)):
        raise ValueError(f"rank {rank} of a model axis of {world}")
    return 0, rank, 1, world


@functools.cache
def _logical_shapes(cfg: ModelConfig) -> dict:
    """``{names: shape}`` of the config's parameter tree (on ``meta``)."""
    from repro_torch.models.api import get_model
    shapes = {}

    def keep(names, leaf):
        shapes[names] = tuple(leaf.shape)
    _walk(keep, get_model(cfg).init(device="meta", masters=True))
    return shapes


@functools.cache
def data_cut(names: tuple, cfg: ModelConfig, world) -> int | None:
    """The dim on which the ``data`` axis of ``world = (D, M)`` cuts the
    leaf at ``names`` (the same dim of the logical leaf and of its model
    shard), or ``None`` where the leaf is whole over ``data``: the dim
    where the reference places ``data`` (the name rule, guarded by the
    mesh, then ``fit_spec``, as its ``build_train_step`` fits
    ``param_specs(shapes, mesh)``), where D divides the model shard."""
    _, _, dd, mm = _coord(0, world)
    if dd == 1:
        return None
    shape = _logical_shapes(cfg)[names]
    mesh = {"data": dd, "model": mm}
    spec = fit_spec(leaf_spec(names, shape, mesh), shape, mesh)
    dim = next((i for i, e in enumerate(spec) if "data" in _axes_of(e)),
               None)
    if dim is None:
        return None
    size = shape[dim]
    if _segments(names, cfg, mm) is not None:
        if dim == len(shape) - 1:
            raise NotImplementedError(f"{'/'.join(names)}: the data axis on "
                                      f"the segmented dim")
    else:
        how = _cut(names, len(shape), cfg, mm)
        if how is not None and how[0] == dim:
            runs = {stop - start for start, stop, _ in
                    map(how[1], range(mm))}
            if len(runs) > 1:
                raise NotImplementedError(f"{'/'.join(names)}: the data axis "
                                          f"on a dim the model axis cuts "
                                          f"unevenly")
            size = size // how[1](0)[2] * runs.pop()
    return dim if size % dd == 0 and size >= dd else None


def shard_params(params: dict, cfg: ModelConfig, rank, world) -> dict:
    """Cut each full leaf of ``params`` to ``rank``'s slice of ``world``
    (an int: the model axis; ``(D, M)``: the rank mesh, see the module
    docstring).

    Over ``model``: column-parallel weights and their biases are cut on
    the output dim, row-parallel weights on the contraction dim, attention
    by whole heads (:func:`head_split`), Mamba2's packed leaves in
    segments (:func:`_segments`), the embedding (and a tied head) on V.
    Over ``data``: the model shard is cut into D pieces on
    :func:`data_cut`'s dim.  Each cut leaf is a contiguous copy (a
    segmented one a view of a copy with padded rows), so the full tree
    can be freed; every other leaf is the same tensor on every rank.  One
    rank returns ``params``.  :func:`unshard_params` is the inverse.
    """
    d, m, dd, mm = _coord(rank, world)
    if dd * mm == 1:
        return params

    def cut(names, leaf):
        segs = _segments(names, cfg, mm)
        if segs is not None:
            dim = data_cut(names, cfg, (dd, mm))
            if dim is not None:
                n = leaf.shape[dim] // dd
                leaf = leaf.narrow(dim, d * n, n)
            return _take_segments(leaf, segs, m, mm)
        piece = leaf
        how = _cut(names, leaf.dim(), cfg, mm)
        if how is not None:
            dim, at = how
            start, stop, units = at(m)
            if leaf.shape[dim] % units or leaf.shape[dim] < units:
                # any weight the rule cuts must be cut, or the row psum
                # would sum ``world`` copies
                raise ValueError(f"{cfg.name}: {mm} ranks do not divide "
                                 f"{'/'.join(names)} {tuple(leaf.shape)}")
            n = leaf.shape[dim] // units
            piece = piece.narrow(dim, start * n, (stop - start) * n)
        dim = data_cut(names, cfg, (dd, mm))
        if dim is not None:
            n = piece.shape[dim] // dd
            piece = piece.narrow(dim, d * n, n)
        if piece is leaf:
            return leaf
        return piece.clone(memory_format=torch.contiguous_format)
    return _walk(cut, params)


def _concat(parts: list, dim: int):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=dim)
    return torch.cat(parts, dim)


def _at(tree: dict, names: tuple):
    for k in names:
        tree = tree[k]
    return tree


def _narrow(x, dim: int, start: int, size: int):
    if isinstance(x, np.ndarray):
        return x[(slice(None),) * dim + (slice(start, start + size),)]
    return x.narrow(dim, start, size)


def _first_holders(at, world: int) -> dict:
    """``{unit: the first rank whose run holds it}`` of a cut's pieces."""
    first = {}
    for rank in range(world):
        start, stop, _ = at(rank)
        for u in range(start, stop):
            first.setdefault(u, rank)
    return first


def unshard_params(shards: list, cfg: ModelConfig, world) -> dict:
    """The full tree from every rank's shard (``shards[r]``, ``r`` the flat
    rank), the inverse of :func:`shard_params`: the data pieces of each
    model shard concatenated along :func:`data_cut`'s dim, then each
    model-cut leaf along its dim, a piece that several ranks share (a KV
    head) taken from the first rank that holds it, a segmented leaf's
    segments joined (:func:`_join_segments`), every whole leaf from rank
    0.  Leaves are numpy arrays or tensors (a gather to rank 0 can
    feed it)."""
    _, _, dd, mm = _coord(0, world)
    if len(shards) != dd * mm:
        raise ValueError(f"{len(shards)} shards for {dd * mm} ranks")
    if dd * mm == 1:
        return shards[0]
    if dd > 1:
        def join_data(m):
            def join(names, leaf):
                dim = data_cut(names, cfg, (dd, mm))
                if dim is None:
                    return leaf
                return _concat([_at(shards[d * mm + m], names)
                                for d in range(dd)], dim)
            return _walk(join, shards[m])
        shards = [join_data(m) for m in range(mm)]
    if mm == 1:
        return shards[0]

    def join(names, leaf):
        segs = _segments(names, cfg, mm)
        if segs is not None:
            return _join_segments([_at(t, names) for t in shards], segs, mm)
        how = _cut(names, leaf.ndim, cfg, mm)
        if how is None:
            return leaf
        dim, at = how
        parts = {}
        for rank, tree in enumerate(shards):
            start, stop, units = at(rank)
            piece = _at(tree, names)
            n = piece.shape[dim] // max(stop - start, 1)
            for u in range(start, stop):
                if u not in parts:
                    parts[u] = _narrow(piece, dim, (u - start) * n, n)
        return _concat([parts[u] for u in range(units)], dim)
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


def shard_state(state, cfg: ModelConfig, rank, world):
    """:func:`shard_params` over each parameter tree of ``state`` (params,
    ``AdamWState(step, m, v)``); the step stays whole."""
    return map_state(lambda t, _: shard_params(t, cfg, rank, world), state)


def unshard_state(states: list, cfg: ModelConfig, world):
    """The inverse of :func:`shard_state`: ``states[r]`` flat rank r's."""
    def join(_, path):
        trees = []
        for st in states:
            for i in path:
                st = st[i]
            trees.append(st)
        return unshard_params(trees, cfg, world)
    return map_state(join, states[0])


def leaf_holding(params: dict, cfg: ModelConfig, rank, world) -> dict:
    """How this rank holds each leaf of its shard ``params``, for a sum over
    the logical arrays: ``"whole"`` (neither axis cuts it: the same on
    every rank, counted once), ``"cut"`` (its piece, summed over the ranks
    of both axes: on the first rank, in mesh order, of those that hold the
    same piece) or ``"copy"`` (a piece another rank counts: a KV head
    another rank of its KV group holds, a model shard another data rank
    holds whole, a data piece of a leaf another model rank holds
    whole).  A segmented leaf (:func:`segment_runs`) gets ``((kind,
    start, size), ...)``, a kind for each run of its last dim: its cut
    segments' pieces ``"cut"``, its whole ones as a leaf the model axis
    does not cut; so does a KV leaf of the uneven head cut whose heads
    some other rank counts and some this one (a rank straddling two KV
    heads), a kind a head."""
    d, m, dd, mm = _coord(rank, world)

    def kind(names, leaf):
        dim = data_cut(names, cfg, (dd, mm)) if dd > 1 else None
        runs = segment_runs(names, cfg, mm)
        if runs is not None:
            # a cut run as a leaf cut over model, a whole one as a leaf not
            piece = "cut" if dim is not None or d == 0 else "copy"
            whole = "whole" if dim is None else "cut" if m == 0 else "copy"
            return tuple((piece if cut else whole, start, size)
                         for cut, start, size in runs)
        how = _cut(names, leaf.ndim, cfg, mm)
        if how is None and dim is None:
            return "whole"
        first_d = d if dim is not None else 0
        if how is None:
            return "cut" if (first_d, 0) == (d, m) else "copy"
        start, stop, _ = how[1](m)
        first = _first_holders(how[1], mm)
        kinds = ["cut" if (first_d, first[u]) == (d, m) else "copy"
                 for u in range(start, stop)]
        if len(set(kinds)) < 2:
            return kinds[0] if kinds else "copy"
        if how[0] != leaf.ndim - 1:
            raise NotImplementedError(f"{'/'.join(names)}: mixed holding "
                                      f"off the last dim")
        n = leaf.shape[-1] // len(kinds)
        return tuple((k, j * n, n) for j, k in enumerate(kinds))
    return _walk(kind, params)


def kv_holders(cfg: ModelConfig, world: int) -> list:
    """``[(KV head, the model ranks that hold it), ...]`` of the KV heads
    that more than one rank of the model axis of ``world`` holds, in KV
    head order.  Under the uneven head cut a rank can be in two of them
    (qwen3-14b at 16: KV head 0 on ranks 0 and 1, head 1 on ranks 1, 2
    and 3).  The hybrid family's one attention is its shared block's,
    with its own head counts."""
    heads = attn_heads(cfg, ("shared",) if cfg.family == "hybrid" else ())
    if world == 1 or heads[1] % world == 0:
        return []
    holders = {}
    for rank in range(world):
        start, stop, _ = _kv_piece(cfg, rank, world, heads)
        for u in range(start, stop):
            holders.setdefault(u, []).append(rank)
    return [(u, holders[u]) for u in sorted(holders) if len(holders[u]) > 1]


def kv_groups(cfg: ModelConfig, world) -> list:
    """The groups of flat ranks that share one KV head (each holds a copy,
    the same piece over ``data``), in order of data rank, then KV head
    (:func:`kv_holders` on each model line); empty where every rank holds
    its own KV heads."""
    _, _, dd, mm = _coord(0, world)
    return [[d * mm + r for r in ranks] for d in range(dd)
            for _, ranks in kv_holders(cfg, mm)]


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
