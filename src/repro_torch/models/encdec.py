"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The conv frontend is a stub, as in the reference: ``batch["media"]`` holds
precomputed frame embeddings [B, n_frames, d_model].  The encoder is a
non-causal transformer over the frames with an ungated GELU MLP; the
decoder a causal transformer with a learned position table (``pos_dec``,
added to the embedded tokens, RoPE in its self-attention as the
reference's) and cross-attention over the encoder's output.  The head is
the tied ``embed.T``, read in place by the INA matmul: a k-major operand
whose row stride is d_model, so the odd vocabulary (51865) keeps the TMA
launches.

Attention over more than one query runs the flash kernel: non-causal over
the frames in the encoder (1500 for whisper-medium) and in the decoder's
cross-attention, causal in its self-attention.  A decode step's single
query runs :func:`repro_torch.models.layers.attn_full`.  Every projection
runs the INA matmul.

``decode_step`` encodes ``batch["media"]`` again at every step, as the
reference does; the decode cache holds the decoder's self-attention K/V
only, ``k``/``v`` [L, B, S, KVH, hd].  The serving engine takes no media,
so this family serves through ``launch/serve.py``'s legacy loop, as in the
reference.

Under tensor parallelism the parameters are a rank's shards
(:mod:`repro_torch.parallel.sharding`): the encoder, the decoder's
self-attention and its cross-attention run the rank's heads (the head
counts are read from the shards), each attention's ``wo`` and each MLP's
``w_down`` a row psum; ``pos_dec`` is whole on every rank, and the
embedding and the tied head are vocab-parallel where the world divides
the vocabulary (whisper-medium's 51865 it does not: the table stays
whole).  The decode cache holds the rank's KV heads.

Under ``rs_seq`` each stream is this rank's slice of its sequence between
the layers: the encoder's over the frames (1500 for whisper-medium, cut
from the media), the decoder's over the tokens (cut after ``pos_dec`` is
added).  Each attention's and MLP's normed input is gathered whole at its
entry (:func:`repro_torch.parallel.tp.gather_seq`) and each row site
reduce-scatters over its S; ``ln_enc``'s output is gathered whole once,
for every decoder layer's cross-attention.

In training each encoder and decoder layer is checkpointed
(:func:`~repro_torch.models.transformer.remat`), as the reference's
scans are, and every whole tensor that enters cut work does so through
Megatron's ``f`` (:func:`~repro_torch.parallel.tp.enter_cut`, or the
gather's backward under rs_seq): the normed input of each attention and
MLP, the cross-attention's query input, and the encoder's output, once
before the decoder's loop (the ``f`` is linear: its one sum covers the
``wk``/``wv`` of every layer).  A head over a vocabulary the world does
not divide is whole on every rank and takes no ``f``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import stack_drawn
from repro_torch.models.transformer import (_dtype, _heads, block_input,
                                            head_logits, layer, remat)
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import local_heads
from repro_torch.parallel.tp import ParallelCtx, col_linear, row_linear

CACHE_BATCH_AXES = {"k": 1, "v": 1}
PAGED_CACHE_LEAVES = ("k", "v")
# as ``transformer.STREAM_LEAVES``: the encoder's norms and ``ln_enc`` on
# the frames' stream, the decoder's norms and ``ln_f`` on the tokens'
STREAM_LEAVES = {"enc_layers/ln1": "media", "enc_layers/ln2": "media",
                 "ln_enc": "media", "dec_layers/ln1": "tokens",
                 "dec_layers/lnx": "tokens", "dec_layers/ln2": "tokens",
                 "ln_f": "tokens"}


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def _attn(generator, cfg: ModelConfig, device) -> dict:
    return L.init_attn(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, device=device)


def init_enc_layer(generator, cfg: ModelConfig, device) -> dict:
    """One encoder layer's weights in float32."""
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "attn": _attn(generator, cfg, device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, gated=False,
                          device=device),
    }


def init_dec_layer(generator, cfg: ModelConfig, device) -> dict:
    """One decoder layer's weights in float32."""
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "attn": _attn(generator, cfg, device),
        "lnx": torch.ones(cfg.d_model, device=device),
        "xattn": _attn(generator, cfg, device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, gated=False,
                          device=device),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro.models.encdec.init``
    (the draws themselves differ: torch and JAX generators differ), stored
    as :func:`repro_torch.models.transformer.init` stores them."""
    dt = _dtype(cfg)
    per_layer = (lambda t: t) if masters else (lambda t: L.to_storage(t, dt))

    def stack(draw, n):
        return stack_drawn(lambda: per_layer(draw(generator, cfg, device)), n)
    params = {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model),
                              device=device),
        "pos_dec": L.dense_init(generator, (cfg.max_seq, cfg.d_model),
                                device=device) * 0.02,
        "enc_layers": stack(init_enc_layer, cfg.encoder_layers),
        "ln_enc": torch.ones(cfg.d_model, device=device),
        "dec_layers": stack(init_dec_layer, cfg.n_layers),
        "ln_f": torch.ones(cfg.d_model, device=device),
    }
    return L.to_masters(params, cfg.param_dtype) if masters \
        else L.to_storage(params, dt)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def _attn_kw(p: dict, cfg: ModelConfig) -> dict:
    """The head counts of the attention shard ``p``, its head dim, eps."""
    hd = cfg.resolved_head_dim
    nh, nkv = _heads(p, hd)
    return dict(n_heads=nh, n_kv=nkv, head_dim=hd, eps=cfg.norm_eps)


def enc_layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                  pctx: Optional[ParallelCtx], seq: int) -> torch.Tensor:
    """One encoder layer over ``seq`` frames: non-causal self-attention
    (no RoPE) and an ungated MLP."""
    x = x + L.attn_block(lp["attn"], block_input(x, lp["ln1"], cfg, seq,
                                                 pctx),
                         cos=None, sin=None, causal=False, pctx=pctx,
                         **_attn_kw(lp["attn"], cfg))
    return x + L.mlp_block(lp["mlp"], block_input(x, lp["ln2"], cfg, seq,
                                                  pctx), pctx)


def encode(params: dict, cfg: ModelConfig, media: torch.Tensor,
           pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """media: [B, F, D] frame embeddings -> the encoder's output [B, F,
    D], whole on every rank; where autograd records the layers, each is
    checkpointed.  Under rs_seq the layers run on this rank's slice of
    the frames, and the normed output is gathered whole at the end: in
    training it enters every decoder layer's cut ``wk``/``wv`` through
    that gather's ``f``."""
    f = media.shape[1]
    x = tp.scatter_seq(media.to(_dtype(cfg)), pctx)
    for i in range(cfg.encoder_layers):
        x = remat(enc_layer_fwd, cfg, layer(params["enc_layers"], i), x, cfg,
                  pctx, f)
    return block_input(x, params["ln_enc"], cfg, f, pctx)


def cross_attn(p: dict, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
               pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """Queries from the decoder's ``x``, keys and values from ``enc``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    f = enc.shape[1]
    q = col_linear(x, p["wq"], pctx).reshape(b, s, -1, hd)
    k = col_linear(enc, p["wk"], pctx).reshape(b, f, -1, hd)
    v = col_linear(enc, p["wv"], pctx).reshape(b, f, -1, hd)
    o = L.attention(q, k, v, causal=False)
    return row_linear(o.reshape(b, s, -1), p["wo"], pctx)


def dec_layer_fwd(lp: dict, x: torch.Tensor, enc: torch.Tensor,
                  cfg: ModelConfig, cos, sin, pctx: Optional[ParallelCtx],
                  seq: int, kv: Optional[tuple] = None,
                  pos=None) -> torch.Tensor:
    """One decoder layer over the whole sequence of ``seq`` positions
    (``x`` this rank's slice of them under rs_seq), or with ``kv`` (the
    layer's cache K/V) one decode step at ``pos``, written in place."""
    h = block_input(x, lp["ln1"], cfg, seq, pctx)
    if kv is None:
        x = x + L.attn_block(lp["attn"], h, cos=cos, sin=sin, causal=True,
                             pctx=pctx, **_attn_kw(lp["attn"], cfg))
    else:
        y, _, _ = L.attn_block_decode(lp["attn"], h, kv[0], kv[1], pos,
                                      cos=cos, sin=sin, pctx=pctx,
                                      **_attn_kw(lp["attn"], cfg))
        x = x + y
    x = x + cross_attn(lp["xattn"], block_input(x, lp["lnx"], cfg, seq,
                                                pctx), enc, cfg, pctx)
    return x + L.mlp_block(lp["mlp"], block_input(x, lp["ln2"], cfg, seq,
                                                  pctx), pctx)


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Logits [B, S, V]; where autograd records the layers, each encoder
    and decoder layer is checkpointed, the head outside."""
    tokens = batch["tokens"]
    enc = encode(params, cfg, batch["media"], pctx)
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    x = tp.scatter_seq(x + params["pos_dec"][:s][None].to(x.dtype), pctx)
    cos, sin = L.rope_cos_sin(torch.arange(s, device=tokens.device),
                              cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = remat(dec_layer_fwd, cfg, layer(params["dec_layers"], i), x, enc,
                  cfg, cos, sin, pctx, s)
    return head_logits(params, cfg, x, s, pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    return L.xent_loss(forward(params, cfg, batch, pctx), batch["labels"])


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1) -> dict:
    """The decoder's self-attention K/V of one rank of ``world``'s KV
    heads."""
    shape = (cfg.n_layers, batch, max_seq, local_heads(cfg, world)[1],
             cfg.resolved_head_dim)
    return {name: torch.zeros(shape, dtype=_dtype(cfg), device=device)
            for name in ("k", "v")}


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode; ``batch["media"]`` is encoded again at every step,
    as the reference does.  batch: {tokens: [B, 1], pos: int or [B]
    tensor, media: [B, F, D]}; returns (logits [B, 1, V], cache), the K/V
    written in place."""
    tokens = batch["tokens"]
    enc = encode(params, cfg, batch["media"], pctx)
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    pos, cos, sin = L.decode_positions(batch["pos"], tokens.device,
                                       cfg.resolved_head_dim, cfg.rope_theta)
    rows = params["pos_dec"][pos][:, None] if torch.is_tensor(pos) \
        else params["pos_dec"][pos:pos + 1][None]
    x = x + rows.to(x.dtype)
    for i in range(cfg.n_layers):
        x = dec_layer_fwd(layer(params["dec_layers"], i), x, enc, cfg, cos,
                          sin, pctx, 1, kv=(cache["k"][i], cache["v"][i]),
                          pos=pos)
    return head_logits(params, cfg, x, 1, pctx), cache
