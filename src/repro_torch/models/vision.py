"""Llama-3.2-Vision backbone: a dense decoder with gated cross-attention
layers (counterpart of ``repro.models.vision``).

The ViT frontend is a stub, as in the reference: ``batch["media"]`` holds
precomputed patch embeddings [B, num_media_tokens, d_model].  Every
``cross_attn_every``-th layer is a tanh-gated cross-attention block with
qk-norm over the media; the others are the dense family's layers
(:func:`repro_torch.models.transformer.layer_fwd`).  A Python loop over
the groups takes the place of the reference's nested ``lax.scan``; where
autograd records it, each group (its ``per - 1`` self layers and its
cross layer, the reference's ``jax.checkpoint`` unit) is checkpointed
(:func:`~repro_torch.models.transformer.remat`), the media an argument.

Attention over more than one query runs the flash kernel: causal in the
self layers, non-causal over the media in the cross-attention layers
(1601 media rows at GQA 32:8 for llama-3.2-vision-11b).  A decode step's
single query runs :func:`repro_torch.models.layers.attn_full`, as the
reference's does.  Every projection runs the INA matmul.

The weights follow the reference's names and layouts: ``groups`` holds the
self layers stacked ``[G, per - 1, ...]``, ``xlayers`` the cross-attention
layers ``[G, ...]``; the 0-d gates stay float32
(:func:`repro_torch.models.layers.to_storage`).

The decode cache holds the self layers' K/V ``k``/``v`` [G, per - 1, B, S,
KVH, hd] and the cross-attention K/V over the media ``mk``/``mv`` [G, B,
M, KVH, hd], computed once by :func:`prefill_media_kv`.  The serving
engine takes no media, so this family serves through ``launch/serve.py``'s
legacy loop, as in the reference.

Under tensor parallelism the parameters are a rank's shards
(:mod:`repro_torch.parallel.sharding`): the self layers shard as the dense
family's; a cross-attention layer runs the rank's query heads and the KV
heads they read (cut by the attention's head rule), its ``wo`` and its
MLP's ``w_down`` two row psums, its norms and gates whole; the embedding
and the head are vocab-parallel.  The decode cache holds the rank's KV
heads, over the media too.  Under ``rs_seq`` the stream between the
layers is this rank's slice of the sequence: the self layers gather and
reduce-scatter as the dense family's, and a cross layer gathers its
normed inputs (``lnx``'s and ``ln2``'s, on the slice) whole
(:func:`repro_torch.parallel.tp.gather_seq`), its ``wo`` and ``w_down``
reduce-scatter over S, and the tanh gates scale those slices.  The media
K/V stay whole: no row site produces the media.  In training the cross
layer's normed inputs enter its cut query heads and MLP columns through
Megatron's ``f`` (the gathers' backwards under rs_seq); the media are
data with no gradient, so ``wk``/``wv`` over them take none, and the self
layers take theirs as the dense family's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import stack_drawn
from repro_torch.models.transformer import (_dtype, _heads, block_input,
                                            embed_stream, head_logits, layer,
                                            remat)
from repro_torch.parallel.sharding import local_heads
from repro_torch.parallel.tp import ParallelCtx, col_linear, row_linear

CACHE_BATCH_AXES = {"k": 2, "v": 2, "mk": 1, "mv": 1}
# as ``transformer.STREAM_LEAVES``: the self and cross layers' norms,
# ``ln_f``, and the cross layers' tanh gates (scaling the slices that
# ``wo`` and ``w_down`` reduce-scatter); the media are no stream
STREAM_LEAVES = {"groups/ln1": "tokens", "groups/ln2": "tokens",
                 "xlayers/lnx": "tokens", "xlayers/ln2": "tokens",
                 "xlayers/gate_attn": "tokens", "xlayers/gate_mlp": "tokens",
                 "ln_f": "tokens"}
PAGED_CACHE_LEAVES = ("k", "v")


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, layers a group: per - 1 self layers and one cross)."""
    per = cfg.cross_attn_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {per} does not divide {cfg.n_layers} "
                         f"layers")
    return cfg.n_layers // per, per


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_xattn_layer(generator, cfg: ModelConfig, device) -> dict:
    """One cross-attention layer's weights in float32 (gates at 0, as the
    reference's)."""
    return {
        "lnx": torch.ones(cfg.d_model, device=device),
        "xattn": L.init_attn(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.resolved_head_dim,
                             qk_norm=True, device=device),
        "gate_attn": torch.zeros((), device=device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device=device),
        "gate_mlp": torch.zeros((), device=device),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro.models.vision.init``
    (the draws themselves differ: torch and JAX generators differ), stored
    as :func:`repro_torch.models.transformer.init` stores them."""
    dt = _dtype(cfg)
    g, per = _groups(cfg)
    per_layer = (lambda t: t) if masters else (lambda t: L.to_storage(t, dt))
    stacked = stack_drawn(lambda: per_layer(T.init_layer(generator, cfg,
                                                         device)),
                          cfg.n_layers - g)

    def regroup(t):
        return {k: regroup(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.view(g, per - 1, *t.shape[1:])
    params = {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model),
                              device=device),
        "groups": regroup(stacked),
        "xlayers": stack_drawn(lambda: per_layer(init_xattn_layer(
            generator, cfg, device)), g),
        "ln_f": torch.ones(cfg.d_model, device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                in_dim=cfg.d_model, device=device),
    }
    return L.to_masters(params, cfg.param_dtype) if masters \
        else L.to_storage(params, dt)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def media_kv(xp: dict, media: torch.Tensor, cfg: ModelConfig,
             pctx: Optional[ParallelCtx]):
    """A cross-attention layer's K (k-normed) and V over the media:
    [B, M, KVH, hd] each, KVH the shard's heads."""
    b, m, _ = media.shape
    hd = cfg.resolved_head_dim
    k = col_linear(media, xp["xattn"]["wk"], pctx).reshape(b, m, -1, hd)
    k = L.rms_norm(k, xp["xattn"]["k_norm"], cfg.norm_eps)
    v = col_linear(media, xp["xattn"]["wv"], pctx).reshape(b, m, -1, hd)
    return k, v


def xattn_fwd(xp: dict, x: torch.Tensor, media: Optional[torch.Tensor],
              cfg: ModelConfig, pctx: Optional[ParallelCtx], seq: int,
              kv: Optional[tuple] = None) -> torch.Tensor:
    """Gated cross-attention + MLP over the media (``media`` [B, M, D], or
    its K/V ``kv`` from the cache) for ``seq`` positions, ``x`` this
    rank's slice of them under rs_seq."""
    hd = cfg.resolved_head_dim
    h = block_input(x, xp["lnx"], cfg, seq, pctx)
    b, s, _ = h.shape
    q = col_linear(h, xp["xattn"]["wq"], pctx).reshape(b, s, -1, hd)
    q = L.rms_norm(q, xp["xattn"]["q_norm"], cfg.norm_eps)
    k, v = media_kv(xp, media, cfg, pctx) if kv is None else kv
    o = L.attention(q, k, v, causal=False)
    o = row_linear(o.reshape(b, s, -1), xp["xattn"]["wo"], pctx)
    x = x + torch.tanh(xp["gate_attn"]).to(x.dtype) * o
    y = L.mlp_block(xp["mlp"], block_input(x, xp["ln2"], cfg, seq, pctx),
                    pctx)
    return x + torch.tanh(xp["gate_mlp"]).to(x.dtype) * y


def group_fwd(gp: dict, x: torch.Tensor, media: torch.Tensor,
              cfg: ModelConfig, cos, sin, pctx: Optional[ParallelCtx],
              seq: int) -> torch.Tensor:
    """One group: its self layers ``gp["self"]``, then its cross layer
    ``gp["cross"]`` over ``media``."""
    for li in range(cfg.cross_attn_every - 1):
        x = T.layer_fwd(layer(gp["self"], li), x, cfg, cos, sin, pctx, seq)
    return xattn_fwd(gp["cross"], x, media, cfg, pctx, seq)


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  media: torch.Tensor,
                  pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """The final stream, before ``ln_f`` (this rank's slice of the
    sequence under rs_seq); where autograd records it, each group
    checkpointed (:func:`~repro_torch.models.transformer.remat`)."""
    g, _ = _groups(cfg)
    seq = tokens.shape[1]
    x = embed_stream(params, cfg, tokens, pctx)
    media = media.to(x.dtype)
    pos = torch.arange(seq, device=tokens.device)
    cos, sin = L.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    for gi in range(g):
        gp = {"self": layer(params["groups"], gi),
              "cross": layer(params["xlayers"], gi)}
        x = remat(group_fwd, cfg, gp, x, media, cfg, cos, sin, pctx, seq)
    return x


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    tokens = batch["tokens"]
    x = hidden_states(params, cfg, tokens, batch["media"], pctx)
    return head_logits(params, cfg, x, tokens.shape[1], pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    return L.xent_loss(forward(params, cfg, batch, pctx), batch["labels"])


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1) -> dict:
    """The decode cache of one rank of ``world``: its KV heads of the self
    layers and of the cross-attention over the media."""
    g, per = _groups(cfg)
    hd, dt = cfg.resolved_head_dim, _dtype(cfg)
    kvh = local_heads(cfg, world)[1]
    kv = (g, per - 1, batch, max_seq, kvh, hd)
    mkv = (g, batch, cfg.num_media_tokens, kvh, hd)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, shape in (("k", kv), ("v", kv), ("mk", mkv),
                                ("mv", mkv))}


def prefill_media_kv(params: dict, cfg: ModelConfig, media: torch.Tensor,
                     cache: dict, pctx: Optional[ParallelCtx] = None) -> dict:
    """Write every cross-attention layer's K/V over ``media`` [B, M, D]
    into the cache's ``mk``/``mv`` (in place), the heads of the shard
    ``params`` holds; returns the cache."""
    media = media.to(_dtype(cfg))
    for gi in range(_groups(cfg)[0]):
        k, v = media_kv(layer(params["xlayers"], gi), media, cfg, pctx)
        cache["mk"][gi] = k
        cache["mv"][gi] = v
    return cache


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode over the cache's media K/V (:func:`
    prefill_media_kv`).  batch: {tokens: [B, 1], pos: int or [B] tensor};
    returns (logits [B, 1, V], cache), the self layers' K/V written in
    place."""
    g, per = _groups(cfg)
    tokens = batch["tokens"]
    hd = cfg.resolved_head_dim
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    pos, cos, sin = L.decode_positions(batch["pos"], tokens.device, hd,
                                       cfg.rope_theta)
    for gi in range(g):
        gp = layer(params["groups"], gi)
        for li in range(per - 1):
            lp = layer(gp, li)
            nh, nkv = _heads(lp["attn"], hd)
            y, _, _ = L.attn_block_decode(
                lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                cache["k"][gi, li], cache["v"][gi, li], pos,
                n_heads=nh, n_kv=nkv, head_dim=hd,
                cos=cos, sin=sin, eps=cfg.norm_eps, pctx=pctx)
            x = x + y
            x = x + L.mlp_block(lp["mlp"],
                                L.rms_norm(x, lp["ln2"], cfg.norm_eps), pctx)
        x = xattn_fwd(layer(params["xlayers"], gi), x, None, cfg, pctx, 1,
                      kv=(cache["mk"][gi].to(x.dtype),
                          cache["mv"][gi].to(x.dtype)))
    return head_logits(params, cfg, x, 1, pctx), cache
