"""DeepSeek-V2-Lite: Multi-head Latent Attention + MoE FFN (counterpart of
``repro.models.mla``).

MLA compresses K/V through a low-rank latent (``kv_lora_rank``) with a
split nope/rope head layout: q/k heads of ``qk_nope + qk_rope`` (192 in
V2-Lite) against v heads of ``v_head_dim`` (128).  The flash kernel takes
one head dim for q, k and v, so attention runs the reference's own rule
(:func:`repro_torch.models.layers.attention_by_chunk`), plain PyTorch as it
is plain JAX there.  Every projection (``wq``, ``w_dkv``, ``w_uk``,
``w_uv``, ``wo``) runs the INA matmul; the FFN layers are
:mod:`repro_torch.models.moe`'s.

The decode cache stores the normed latent and the shared rope key,
``{"dense": {"latent", "k_rope"}, "moe": {...}}``, each ``[L, B, S, R]``,
the reference's tree.  Decode keeps the reference's arithmetic: the whole
cached latent is expanded through ``w_uk``/``w_uv`` at every step (M = B x
cache length).  ``decode_step`` writes the cache in place and returns it.
There is no ``prefill``, as in the reference.

Under tensor parallelism (:mod:`repro_torch.parallel.sharding`) a rank
holds its H/P heads of ``wq``, ``w_uk``, ``w_uv`` and ``wo``, and the whole
of ``w_dkv`` and ``kv_norm``: every rank computes the whole normed latent
(its RMS norm needs all of it), caches it whole, and expands its own heads
from it; ``wo``'s row psum sums the heads.  The FFN is expert-parallel as
:mod:`repro_torch.models.moe`'s.  Under ``rs_seq`` the stream between the
blocks is this rank's slice of the sequence, as in
:mod:`repro_torch.models.moe`: the attention's normed input is gathered
whole, its ``f``s stay on ``wq``'s input and the latent (so the gather's
backward is the rank's slice), and ``wo`` reduce-scatters over S.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import (_dtype, block_input,
                                            embed_stream, head_logits, layer)
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import check_heads
from repro_torch.parallel.tp import ParallelCtx, col_linear, row_linear

# Decode-cache layout (read by ``models.api``), by leaf path: ``dense/...``
# exists where the config has leading dense layers.  Every leaf is paged by
# position.
CACHE_BATCH_AXES = {"moe/latent": 1, "moe/k_rope": 1, "dense/latent": 1,
                    "dense/k_rope": 1}
PAGED_CACHE_LEAVES = tuple(CACHE_BATCH_AXES)
# as ``transformer.STREAM_LEAVES``: both stacks' block norms and ``ln_f``
STREAM_LEAVES = {f"{stack}/{norm}": "tokens"
                 for stack in ("dense_layers", "layers")
                 for norm in ("ln1", "ln2")} | {"ln_f": "tokens"}
# the profiler range of the full-sequence attention (plain PyTorch)
ATTENTION_SPAN = "mla_attention"


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_mla_attn(generator, cfg: ModelConfig, device) -> dict:
    a = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
    return {
        # Q path (V2-Lite: no q compression)
        "wq": L.dense_init(generator, (d, h * qk_dim), device=device),
        # KV latent compression + shared rope key
        "w_dkv": L.dense_init(generator,
                              (d, a.kv_lora_rank + a.qk_rope_head_dim),
                              device=device),
        "kv_norm": torch.ones(a.kv_lora_rank, device=device),
        # up-projections from the latent
        "w_uk": L.dense_init(generator, (a.kv_lora_rank,
                                         h * a.qk_nope_head_dim),
                             device=device),
        "w_uv": L.dense_init(generator, (a.kv_lora_rank, h * a.v_head_dim),
                             device=device),
        "wo": L.dense_init(generator, (h * a.v_head_dim, d), device=device),
    }


def init_layer(generator, cfg: ModelConfig, device, dense: bool = False
               ) -> dict:
    """One layer's weights in float32."""
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "attn": init_mla_attn(generator, cfg, device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": (L.init_mlp(generator, cfg.d_model, cfg.d_ff, device=device)
                if dense else MOE.init_moe_mlp(generator, cfg, device)),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro.models.mla.init``
    (the draws themselves differ: torch and JAX generators differ)."""
    return MOE.init_stacks(cfg, generator, device, masters, init_layer)


# --------------------------------------------------------------------------- #
# MLA attention
# --------------------------------------------------------------------------- #
def _project(p: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
             pctx: Optional[ParallelCtx]):
    """(q [B, S, H, qk_dim] with RoPE on its rope part, the normed latent
    [B, S, rank], the shared rope key [B, S, rope] with RoPE); H the heads
    ``wq`` holds.  In training ``x`` enters the head-cut ``wq`` through
    Megatron's ``f`` (:func:`~repro_torch.parallel.tp.enter_cut`), and
    the whole ``w_dkv`` as it is."""
    a = cfg.mla
    b, s, _ = x.shape
    nope, rank = a.qk_nope_head_dim, a.kv_lora_rank
    q = col_linear(tp.enter_cut(x, pctx), p["wq"], pctx).reshape(
        b, s, -1, nope + a.qk_rope_head_dim)
    q = torch.cat([q[..., :nope], L.apply_rope(q[..., nope:], cos, sin)], -1)
    ckv = col_linear(x, p["w_dkv"], pctx)                 # [B, S, rank+rope]
    latent = L.rms_norm(ckv[..., :rank], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(ckv[:, :, None, rank:], cos, sin)[:, :, 0]
    return q, latent, k_rope


def _expand(p: dict, latent: torch.Tensor, k_rope: torch.Tensor,
            cfg: ModelConfig, pctx: Optional[ParallelCtx]):
    """k [B, S, H, qk_dim] and v [B, S, H, v_dim] from the latent
    [B, S, rank] and the shared rope key [B, S, rope]; H the heads
    ``w_uk`` holds.  In training the whole latent and rope key enter those
    heads through Megatron's ``f``."""
    a = cfg.mla
    b, s, _ = latent.shape
    latent, k_rope = tp.enter_cut(latent, pctx), tp.enter_cut(k_rope, pctx)
    h = p["w_uk"].shape[-1] // a.qk_nope_head_dim
    k_nope = col_linear(latent, p["w_uk"], pctx).reshape(
        b, s, h, a.qk_nope_head_dim)
    v = col_linear(latent, p["w_uv"], pctx).reshape(b, s, h, a.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, a.qk_rope_head_dim)], -1)
    return k, v


def mla_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
            pctx: Optional[ParallelCtx]):
    """Returns q, k [B, S, H, qk_dim] and v [B, S, H, v_dim]."""
    q, latent, k_rope = _project(p, x, cfg, cos, sin, pctx)
    return (q,) + _expand(p, latent, k_rope, cfg, pctx)


def mla_block(p: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
              pctx: Optional[ParallelCtx]) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = mla_qkv(p, x, cfg, cos, sin, pctx)
    with torch.profiler.record_function(ATTENTION_SPAN):
        o = L.attention_by_chunk(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return row_linear(o.reshape(b, s, -1), p["wo"], pctx)


def layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
              pctx: Optional[ParallelCtx], seq: int, dense: bool = False):
    """One layer over the whole sequence of ``seq`` positions (``x`` this
    rank's slice of them under rs_seq); returns (x, aux loss)."""
    # MLA keeps its own ``f``s (the whole latent): no ``f`` at the gather
    h = block_input(x, lp["ln1"], cfg, seq, pctx, cut=False)
    x = x + mla_block(lp["attn"], h, cfg, cos, sin, pctx)
    return MOE.ffn(lp, x, cfg, pctx, dense, seq)


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  pctx: Optional[ParallelCtx] = None):
    """(the final stream, before ``ln_f``: this rank's slice of the
    sequence under rs_seq; aux loss)."""
    seq = tokens.shape[1]
    x = embed_stream(params, cfg, tokens, pctx)
    pos = torch.arange(seq, device=tokens.device)
    cos, sin = L.rope_cos_sin(pos, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    return MOE.run_layers(params, cfg, x, lambda lp, x, dense: layer_fwd(
        lp, x, cfg, cos, sin, pctx, seq, dense))


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    tokens = batch["tokens"]
    x, _ = hidden_states(params, cfg, tokens, pctx)
    return head_logits(params, cfg, x, tokens.shape[1], pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    tokens = batch["tokens"]
    x, aux = hidden_states(params, cfg, tokens, pctx)
    return L.xent_loss(head_logits(params, cfg, x, tokens.shape[1], pctx),
                       batch["labels"]) + aux


# --------------------------------------------------------------------------- #
# decode: cache the compressed latent + shared rope key (MLA's memory win)
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1) -> dict:
    """The latent and the rope key, whole on every rank of ``world`` (each
    expands its own heads from the whole latent)."""
    check_heads(cfg, world)
    a = cfg.mla
    nd = cfg.moe.first_dense_layers

    def leaves(n):
        return {name: torch.zeros((n, batch, max_seq, r), dtype=_dtype(cfg),
                                  device=device)
                for name, r in (("latent", a.kv_lora_rank),
                                ("k_rope", a.qk_rope_head_dim))}
    cache = {"moe": leaves(cfg.n_layers - nd)}
    if nd:
        cache["dense"] = leaves(nd)
    return cache


def _decode_attn(p: dict, x: torch.Tensor, lat_c: torch.Tensor,
                 kr_c: torch.Tensor, pos, cfg: ModelConfig, cos, sin,
                 pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """One token's attention: its latent and rope key written into the
    caches [B, S, .] at ``pos`` (an int or one a row), then the whole cache
    expanded and attended up to ``pos``."""
    b = x.shape[0]
    q, latent, k_rope = _project(p, x, cfg, cos, sin, pctx)
    L.write_at(lat_c, pos, latent[:, 0])
    L.write_at(kr_c, pos, k_rope[:, 0])
    k, v = _expand(p, lat_c.to(x.dtype), kr_c.to(x.dtype), cfg, pctx)
    # mask the zero-initialised cache tail (positions > pos)
    o = L.attn_full(q, k, v, causal=True, q_offset=pos)
    return row_linear(o.reshape(b, 1, -1), p["wo"], pctx)


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode.  batch: {tokens: [B, 1], pos: int or [B] tensor};
    returns (logits [B, 1, V], cache), the cache written in place."""
    tokens = batch["tokens"]
    groups = MOE.decode_groups(tokens, batch["pos"])
    pos, cos, sin = L.decode_positions(batch["pos"], tokens.device,
                                       cfg.mla.qk_rope_head_dim,
                                       cfg.rope_theta)
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    for dense, stack, n in MOE.stacks(params, cfg):
        c = cache["dense" if dense else "moe"]
        for i in range(n):
            lp = layer(stack, i)
            y = _decode_attn(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                             c["latent"][i], c["k_rope"][i], pos, cfg, cos,
                             sin, pctx)
            x, _ = MOE.ffn(lp, x + y, cfg, pctx, dense, 1, groups)
    return head_logits(params, cfg, x, 1, pctx), cache
