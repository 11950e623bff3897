"""Dense decoder-only transformer (counterpart of ``repro.models.transformer``).

Parameters are a nested dict with the reference's names and layouts; layer
weights are stacked ``[L, ...]`` and a Python loop over the layers takes the
place of ``lax.scan``.  For serving, matrices are stored in the compute
dtype (``cfg.dtype``) and vectors (norm weights, biases) in float32
(:func:`repro_torch.models.layers.to_storage`); for training they are the
float32 masters of ``cfg.param_dtype``, cast to the compute dtype at every
call, as the reference does.

``prefill`` and ``decode_step`` write the new K/V into ``cache`` in place
and return it.

Under tensor parallelism the parameters are a rank's shards
(:func:`repro_torch.parallel.sharding.shard_params`): the head counts are
read from the shards (under the uneven head cut a rank may hold none, or
expand its K/V to one head a query head, :func:`head_layout`), the cache
holds the rank's KV heads, the embedding
and the head are vocab-parallel, and under ``pctx.rs_seq`` the residual
stream between layers holds the rank's slice of the sequence, gathered back
before each column-parallel projection (:func:`repro_torch.parallel.tp.
gather_seq`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import Tape
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.remat import remat_policy
from repro_torch.parallel import fsdp
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import kv_index, local_heads
from repro_torch.parallel.tp import ParallelCtx


# Decode-cache layout (read by ``models.api``): each leaf's batch axis, and
# the leaves with a sequence axis, which the serving pool pages by position.
CACHE_BATCH_AXES = {"k": 1, "v": 1}
PAGED_CACHE_LEAVES = ("k", "v")
# The whole leaves applied to the residual stream between the blocks (read
# by ``models.api.stream_leaves``), by path, each to the batch input whose
# sequence (axis 1) that stream follows.  Under rs_seq they act on this
# rank's slice of it, so each rank's gradient covers its own rows only:
# the block norms and ``ln_f``.
STREAM_LEAVES = {"layers/ln1": "tokens", "layers/ln2": "tokens",
                 "ln_f": "tokens"}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` tree
    (or item ``i`` of each leaf's list of per-layer tensors, the form the
    train step differentiates and an FSDP serving rank holds).  Under a
    serving step's FSDP pieces they come gathered whole
    (:func:`~repro_torch.parallel.fsdp.at_slice`)."""
    return fsdp.at_slice(_slice(stacked, i))


def _slice(stacked: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_layer(generator, cfg: ModelConfig, device) -> dict:
    """One layer's weights in float32."""
    hd = cfg.resolved_head_dim
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "attn": L.init_attn(generator, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, hd, cfg.qk_norm, cfg.qkv_bias,
                            device=device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device=device),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro``'s ``dense_init``
    (the draws themselves differ: torch and JAX generators differ).

    Stored by :func:`~repro_torch.models.layers.to_storage` (each layer as
    it is drawn), or with ``masters`` by the reference's ``Model.init`` rule
    (:func:`~repro_torch.models.layers.to_masters`): float32 masters for
    training, the same draws."""
    dt = _dtype(cfg)
    per_layer = (lambda t: t) if masters else (lambda t: L.to_storage(t, dt))
    stacked = _stack([per_layer(init_layer(generator, cfg, device))
                      for _ in range(cfg.n_layers)])
    params = {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model),
                              device=device),
        "layers": stacked,
        "ln_f": torch.ones(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                         in_dim=cfg.d_model, device=device)
    return L.to_masters(params, cfg.param_dtype) if masters \
        else L.to_storage(params, dt)


def _head(params: dict) -> torch.Tensor:
    """The untied head, or the embedding table read in place as [D, V]."""
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def _heads(ap: dict, hd: int) -> tuple[int, int]:
    """(query heads, KV heads) this rank's attention shard holds."""
    return ap["wq"].shape[-1] // hd, ap["wk"].shape[-1] // hd


def head_layout(ap: dict, cfg: ModelConfig,
                pctx: Optional[ParallelCtx]) -> tuple:
    """(query heads, KV heads, the KV index of
    :func:`~repro_torch.parallel.sharding.kv_index`) of this rank's
    attention shard: the index where the rank's query heads straddle its
    KV heads under the uneven head cut, else ``None``.  The plan
    builder's trace runs the unsharded model under a span
    (``plan.builder.collect_psum_sites``), whose heads are no rank's: it
    takes no index."""
    nh, nkv = _heads(ap, cfg.resolved_head_dim)
    if pctx is None or not pctx.manual or not nh:
        return nh, nkv, None
    idx = kv_index(cfg, pctx.rank, pctx.world)
    return nh, nkv, idx if idx is not None and len(idx) == nh else None


def embed_stream(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """Embedded tokens, this rank's slice of the sequence under rs_seq."""
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    return tp.scatter_seq(x, pctx)


def block_input(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, seq: int,
                pctx: Optional[ParallelCtx], cut: bool = True) -> torch.Tensor:
    """A block's input: the stream ``x`` (this rank's slice of the ``seq``
    positions under rs_seq) normed by ``w``, then gathered whole
    (:func:`~repro_torch.parallel.tp.gather_seq`; ``cut=False`` where the
    block keeps its own ``f``s)."""
    return tp.gather_seq(L.rms_norm(x, w, cfg.norm_eps), pctx, seq, cut=cut)


def head_logits(params: dict, cfg: ModelConfig, x: torch.Tensor, seq: int,
                pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """The whole vocabulary's logits [B, S, V] on every rank from the
    final stream ``x`` (this rank's slice of the ``seq`` positions under
    rs_seq): ``ln_f``, then the untied head or the tied ``embed.T``.  The
    head's input is gathered whole (:func:`block_input`): where the head
    holds this rank's slice of V, its gradient is the ranks' partials,
    summed by the gather's backward (Megatron's ``f`` without rs_seq)."""
    head = _head(params)
    x = block_input(x, params["ln_f"], cfg, seq, pctx,
                    cut=head.shape[-1] != cfg.vocab)
    return L.logits_head(x, head, pctx, cfg.vocab)


# --------------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------------- #
def layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
              pctx: Optional[ParallelCtx], seq: int) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    nh, nkv, idx = head_layout(lp["attn"], cfg, pctx)
    h = block_input(x, lp["ln1"], cfg, seq, pctx)
    x = x + L.attn_block(lp["attn"], h, n_heads=nh, n_kv=nkv, head_dim=hd,
                         cos=cos, sin=sin, causal=True, eps=cfg.norm_eps,
                         pctx=pctx, kv_index=idx)
    return x + L.mlp_block(lp["mlp"], block_input(x, lp["ln2"], cfg, seq,
                                                  pctx), pctx)


def _leaves(tree):
    """The tensors of nested dicts and lists (a train step's per-layer
    lists, ``steps._grad_leaves``)."""
    for v in tree.values() if isinstance(tree, dict) else tree:
        yield from (_leaves(v) if isinstance(v, (dict, list)) else (v,))


def remat(fn, cfg: ModelConfig, lp: dict, x: torch.Tensor, *args):
    """``fn(lp, x, *args)``: one layer (or a group of them: zamba2's, the
    vlm's).  Where autograd records it, the layer is checkpointed
    (``use_reentrant=False``) under ``cfg.remat_policy``
    (:func:`~repro_torch.models.remat.remat_policy`): the activations are
    dropped and recomputed in the backward, as the reference's
    ``jax.checkpoint(body, policy=remat_policy(cfg))`` does, except the
    outputs of the products the policy keeps, which the recompute reuses
    (:class:`~repro_torch.core.remat.Tape`); whatever ``fn`` returns (an
    MoE layer's aux loss too) comes through.  Under an FSDP step the
    layer's pieces are gathered inside the checkpointed body
    (:func:`~repro_torch.parallel.fsdp.in_layer`), so its recompute
    gathers them again.  Elsewhere, as in serving, ``fn`` runs as it is."""
    if ops.needs_grad(x, *_leaves(lp)):
        tape = Tape(remat_policy(cfg))
        return checkpoint(fsdp.in_layer(fn), lp, x, *args,
                          use_reentrant=False, context_fn=tape.contexts)
    return fn(lp, x, *args)


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Logits [B, S, V].  Where autograd records the layers, each is
    checkpointed (:func:`remat`).  The head stays outside."""
    tokens = batch["tokens"]
    seq = tokens.shape[1]
    x = embed_stream(params, cfg, tokens, pctx)
    pos = torch.arange(seq, device=tokens.device)
    cos, sin = L.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = remat(layer_fwd, cfg, layer(params["layers"], i), x, cfg, cos,
                  sin, pctx, seq)
    return head_logits(params, cfg, x, seq, pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    return L.xent_loss(forward(params, cfg, batch, pctx), batch["labels"])


# --------------------------------------------------------------------------- #
# prefill: batched forward that also populates the KV cache
# --------------------------------------------------------------------------- #
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
            pctx: Optional[ParallelCtx] = None, pos_offset: int = 0):
    """Causal forward over a token chunk that writes K/V into the cache.

    ``batch["tokens"]``: [B, C] chunk starting at absolute position
    ``pos_offset``.  Each layer's attention runs the flash kernel over the
    cache prefix ``[0, pos_offset + C)`` with query row ``i`` at position
    ``pos_offset + i``: the reference attends over the whole cache with the
    mask anchored at ``pos_offset``, and every position past the prefix is
    masked for every row, so the two agree.  Returns (logits [B, C, V],
    cache).
    """
    tokens = batch["tokens"]
    b, c = tokens.shape
    pos_offset = int(pos_offset)
    end = pos_offset + c
    if end > cache["k"].shape[2]:
        raise ValueError(f"chunk [{pos_offset}, {end}) past the cache length "
                         f"{cache['k'].shape[2]}")
    hd = cfg.resolved_head_dim
    x = embed_stream(params, cfg, tokens, pctx)
    pos = torch.arange(c, device=tokens.device) + pos_offset
    cos, sin = L.rope_cos_sin(pos, hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        nh, nkv, idx = head_layout(lp["attn"], cfg, pctx)
        ck, cv = cache["k"][i], cache["v"][i]
        h = block_input(x, lp["ln1"], cfg, c, pctx)
        if nh == 0:
            x = x + L.no_heads(h, lp["attn"], pctx)
        else:
            q, k, v = L.attn_qkv(lp["attn"], h, nh, nkv, hd, cos, sin,
                                 cfg.norm_eps, pctx, idx)
            ck[:, pos_offset:end] = k.to(ck.dtype)
            cv[:, pos_offset:end] = v.to(cv.dtype)
            o = L.attention(q, ck[:, :end].to(q.dtype),
                            cv[:, :end].to(q.dtype), causal=True,
                            q_offset=pos_offset)
            x = x + L.row_linear(o.reshape(b, c, nh * hd), lp["attn"]["wo"],
                                 pctx)
        x = x + L.mlp_block(lp["mlp"], block_input(x, lp["ln2"], cfg, c,
                                                   pctx), pctx)
    return head_logits(params, cfg, x, c, pctx), cache


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                 world: int = 1, rank: int = 0) -> dict:
    """K/V of the KV heads rank ``rank`` of ``world`` holds (under the
    uneven head cut each rank's own count,
    :func:`~repro_torch.parallel.sharding.cache_heads`)."""
    shape = (cfg.n_layers, batch, max_seq,
             local_heads(cfg, world, rank=rank)[1], cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1, rank: int = 0) -> dict:
    return {name: torch.zeros(shape, dtype=_dtype(cfg), device=device)
            for name, shape in cache_shapes(cfg, batch, max_seq,
                                            world, rank).items()}


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode.  batch: {tokens: [B, 1], pos: int or [B] tensor};
    returns (logits [B, 1, V], cache).

    A [B] ``pos`` gives every row its own position (RoPE angle, cache column
    and mask): row ``i`` computes what a B=1 decode at ``pos[i]`` would,
    which is the reference's vmap over cache slots written out as a batch.
    """
    tokens, pos = batch["tokens"], batch["pos"]
    hd = cfg.resolved_head_dim
    x = embed_stream(params, cfg, tokens, pctx)
    pos, cos, sin = L.decode_positions(pos, tokens.device, hd, cfg.rope_theta)
    seq = tokens.shape[1]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        nh, nkv, idx = head_layout(lp["attn"], cfg, pctx)
        y, _, _ = L.attn_block_decode(
            lp["attn"], block_input(x, lp["ln1"], cfg, seq, pctx),
            cache["k"][i], cache["v"][i], pos, n_heads=nh, n_kv=nkv,
            head_dim=hd, cos=cos, sin=sin, eps=cfg.norm_eps, pctx=pctx,
            kv_index=idx)
        x = x + y
        x = x + L.mlp_block(lp["mlp"], block_input(x, lp["ln2"], cfg, seq,
                                                   pctx), pctx)
    return head_logits(params, cfg, x, seq, pctx), cache
