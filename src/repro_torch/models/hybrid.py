"""Zamba2: a Mamba2 backbone with one weight-shared attention + MLP block
(counterpart of ``repro.models.hybrid``).

The shared block (one set of weights) runs before every group of
``shared_attn_every`` Mamba2 layers, on concat(hidden, the embedded tokens)
(2 x d_model wide) normed by that invocation's own weights
(``inv_norms`` [G, 2D]); its 32 heads are 2 x d_model / 32 wide (160 for
zamba2-2.7b), and its causal attention over several queries runs the flash
kernel.  Every projection runs the INA matmul, the reference's bare ``@
wo_down`` and ``@ mlp_down`` too (:func:`repro_torch.kernels.ops.matmul`).
A Python loop over the groups and their layers takes the place of the
reference's nested ``lax.scan``; where autograd records it, each group
(its shared-block invocation and its Mamba2 layers, the reference's
``jax.checkpoint`` unit) is checkpointed
(:func:`~repro_torch.models.transformer.remat`).

The weights follow the reference's names and layouts: ``groups`` holds the
Mamba2 layers stacked ``[G, per, ...]``, stored by
:func:`repro_torch.models.layers.to_storage` (which counts both leading
axes, so every per-layer vector stays float32).

The decode cache holds each Mamba2 layer's SSD state ``ssm`` [G, per, B,
H, hd, N] (float32) and conv tail ``conv`` [G, per, B, K-1, C], both stored
whole per request by the serving pool, and the shared block's K/V of each
invocation ``k``/``v`` [G, B, S, heads, hd], paged by position.
``decode_step`` takes ``pos`` an int or a [B] tensor (a position a row,
the paged step's form), writes the cache in place and returns it.  There
is no ``prefill``, as in the reference: the serving engine seats prompts
through the per-token decode loop.

Under tensor parallelism the parameters are a rank's shards
(:mod:`repro_torch.parallel.sharding`): each Mamba2 layer runs the rank's
heads (``w_in`` cut in segments: z, x and dt of those heads, B and C
whole) and sums them in ``w_out``'s row psum, its gate norm taking its
statistic over the group; the shared block runs the rank's heads of its
attention and its MLP's columns, whose ``wo`` and ``w_down`` row psums
make the 2 x d_model row whole before ``wo_down`` and ``mlp_down``, which
every rank holds whole; the embedding and the tied head are
vocab-parallel.  The decode cache holds the rank's Mamba2 heads, conv
channels (its x channels, B and C whole) and shared-block KV heads.

Under ``rs_seq`` the stream between the blocks, ``x`` and the embedded
``x0`` both, is this rank's slice of the sequence (cut once after the
embedding): the shared block norms ``cat([x, x0])`` on the slice and
gathers it whole (:func:`repro_torch.parallel.tp.gather_seq`), its
``wo`` and ``w_down`` reduce-scatter over S, and the whole ``wo_down`` and
``mlp_down`` then run on those slices; a Mamba2 layer's normed input is
gathered whole before the conv and the SSD, which run along the whole
sequence, and its ``w_out`` reduce-scatters.  In training the shared
block's normed input enters its cut heads and columns through one
Megatron ``f`` after the norm (the gather's backward under rs_seq), so
that ``inv_norms``' gradient comes out whole; a Mamba2 layer's enters at
the block (:func:`repro_torch.models.ssm.mamba2_block`), so its gather
takes none.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import stack_drawn
from repro_torch.models.transformer import (_dtype, _heads, block_input,
                                            embed_stream, head_logits, layer,
                                            remat)
from repro_torch.parallel.sharding import local_heads, local_ssm_heads
from repro_torch.parallel.tp import ParallelCtx

CACHE_BATCH_AXES = {"ssm": 2, "conv": 2, "k": 1, "v": 1}
# as ``transformer.STREAM_LEAVES``: the Mamba2 layers' norms, ``ln_f``, the
# shared block's ``inv_norms`` (``cat([x, x0])`` normed on the slice) and
# its ``wo_down`` and ``mlp_down`` (whole products on the slices that
# ``wo`` and ``w_down`` reduce-scatter)
STREAM_LEAVES = {"groups/ln": "tokens", "inv_norms": "tokens",
                 "shared/wo_down": "tokens", "shared/mlp_down": "tokens",
                 "ln_f": "tokens"}
PAGED_CACHE_LEAVES = ("k", "v")


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, Mamba2 layers a group)."""
    per = cfg.shared_attn_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {per} does not divide {cfg.n_layers} "
                         f"layers")
    return cfg.n_layers // per, per


def shared_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head dim) of the shared block's attention over 2 x d_model."""
    heads = cfg.shared_attn_heads
    return heads, 2 * cfg.d_model // heads


def _plan(pctx: Optional[ParallelCtx]):
    return None if pctx is None else pctx.plan


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_layer(generator, cfg: ModelConfig, device) -> dict:
    """One Mamba2 layer's weights in float32."""
    return {"ln": torch.ones(cfg.d_model, device=device),
            "mamba": S.init_mamba2(generator, cfg, device)}


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro.models.hybrid.init``
    (the draws themselves differ: torch and JAX generators differ), stored
    as :func:`repro_torch.models.transformer.init` stores them."""
    dt = _dtype(cfg)
    g, per = _groups(cfg)
    per_layer = (lambda t: t) if masters else (lambda t: L.to_storage(t, dt))
    stacked = stack_drawn(lambda: per_layer(init_layer(generator, cfg,
                                                       device)), cfg.n_layers)

    def regroup(t):
        return {k: regroup(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.view(g, per, *t.shape[1:])
    d2 = 2 * cfg.d_model
    heads, hd = shared_dims(cfg)
    shared = {
        "attn": L.init_attn(generator, d2, heads, heads, hd, device=device),
        "wo_down": L.dense_init(generator, (d2, cfg.d_model), device=device),
        "mlp": L.init_mlp(generator, d2, cfg.shared_attn_d_ff,
                          device=device),
        "mlp_down": L.dense_init(generator, (d2, cfg.d_model), device=device),
    }
    params = {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model),
                              device=device),
        "groups": regroup(stacked),
        "inv_norms": torch.ones(g, d2, device=device),
        "shared": shared,
        "ln_f": torch.ones(cfg.d_model, device=device),
    }
    return L.to_masters(params, cfg.param_dtype) if masters \
        else L.to_storage(params, dt)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def shared_block(sp: dict, x: torch.Tensor, x0: torch.Tensor,
                 inv_norm: torch.Tensor, cfg: ModelConfig, cos, sin,
                 pctx: Optional[ParallelCtx], seq: int,
                 cache: Optional[dict] = None, pos=None) -> torch.Tensor:
    """x, x0: [B, S, D] (this rank's slice of the ``seq`` positions under
    rs_seq) -> the block's delta, the same rows.  With ``cache`` (this
    invocation's ``k``/``v`` [B, S_max, heads, hd]) one decode step at
    ``pos``, the new K/V written in place.  The heads are those of the
    shard ``sp`` holds; the normed input enters them and the MLP's cut
    columns through one ``f`` (``wo_down`` and ``mlp_down`` are whole, on
    rows the psums made whole, or the slices the reduce-scatters
    left)."""
    h2 = block_input(torch.cat([x, x0], dim=-1), inv_norm, cfg, seq, pctx)
    hd = shared_dims(cfg)[1]
    nh, nkv = _heads(sp["attn"], hd)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, cos=cos, sin=sin,
              eps=cfg.norm_eps, pctx=pctx)
    if cache is None:
        o = L.attn_block(sp["attn"], h2, causal=True, **kw)
    else:
        o, _, _ = L.attn_block_decode(sp["attn"], h2, cache["k"], cache["v"],
                                      pos, **kw)
    attn_out = ops.matmul(o, sp["wo_down"].to(o.dtype), _plan(pctx))
    mlp_out = ops.matmul(L.mlp_block(sp["mlp"], h2, pctx),
                         sp["mlp_down"].to(x.dtype), _plan(pctx))
    return attn_out + mlp_out


def group_fwd(gp: dict, x: torch.Tensor, x0: torch.Tensor, sp: dict,
              cfg: ModelConfig, cos, sin, pctx: Optional[ParallelCtx],
              seq: int) -> torch.Tensor:
    """One group: the shared block (weights ``sp``, this group's
    ``gp["inv_norm"]``), then the group's Mamba2 layers ``gp["layers"]``,
    over ``seq`` positions (``x`` and ``x0`` this rank's slice of them
    under rs_seq)."""
    x = x + shared_block(sp, x, x0, gp["inv_norm"], cfg, cos, sin, pctx, seq)
    for li in range(cfg.shared_attn_every):
        lp = layer(gp["layers"], li)
        # Mamba2 keeps its own ``f`` (its whole B and C): none at the gather
        h = block_input(x, lp["ln"], cfg, seq, pctx, cut=False)
        y, _, _ = S.mamba2_block(lp["mamba"], h, cfg, pctx)
        x = x + y
    return x


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """The final stream, before ``ln_f`` (this rank's slice of the
    sequence under rs_seq); where autograd records it, each group
    checkpointed (:func:`~repro_torch.models.transformer.remat`)."""
    g, _ = _groups(cfg)
    seq = tokens.shape[1]
    x = x0 = embed_stream(params, cfg, tokens, pctx)
    pos = torch.arange(seq, device=tokens.device)
    cos, sin = L.rope_cos_sin(pos, shared_dims(cfg)[1], cfg.rope_theta)
    for gi in range(g):
        gp = {"layers": layer(params["groups"], gi),
              "inv_norm": params["inv_norms"][gi]}
        x = remat(group_fwd, cfg, gp, x, x0, params["shared"], cfg, cos, sin,
                  pctx, seq)
    return x


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Logits [B, S, V] through the tied head (``embed.T`` read in place),
    the whole vocabulary's on every rank."""
    tokens = batch["tokens"]
    return head_logits(params, cfg, hidden_states(params, cfg, tokens, pctx),
                       tokens.shape[1], pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    return L.xent_loss(forward(params, cfg, batch, pctx), batch["labels"])


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1) -> dict:
    """The decode cache of one rank of ``world``: its Mamba2 heads' states,
    its conv channels' tails and its shared-block KV heads."""
    g, per = _groups(cfg)
    _, _, n, hd, ck = S.mamba2_dims(cfg)
    h = local_ssm_heads(cfg, world)
    heads, shd = shared_dims(cfg)
    kvh = local_heads(cfg, world, (heads, heads))[1]
    dt = _dtype(cfg)
    kv = torch.zeros((g, batch, max_seq, kvh, shd), dtype=dt, device=device)
    return {
        "ssm": torch.zeros((g, per, batch, h, hd, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((g, per, batch, ck - 1, h * hd + 2 * n),
                            dtype=dt, device=device),
        "k": kv, "v": torch.zeros_like(kv),
    }


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode.  batch: {tokens: [B, 1], pos: int or [B] tensor};
    returns (logits [B, 1, V], cache), the cache written in place.  The
    Mamba2 states carry their own positions; ``pos`` places the shared
    block's K/V, its RoPE angle and its mask, row by row."""
    g, per = _groups(cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    x0 = x
    pos, cos, sin = L.decode_positions(batch["pos"], tokens.device,
                                       shared_dims(cfg)[1], cfg.rope_theta)
    for gi in range(g):
        gp = layer(params["groups"], gi)
        x = x + shared_block(params["shared"], x, x0, params["inv_norms"][gi],
                             cfg, cos, sin, pctx, 1,
                             cache={"k": cache["k"][gi], "v": cache["v"][gi]},
                             pos=pos)
        for li in range(per):
            lp = layer(gp, li)
            y, state, conv = S.mamba2_block(
                lp["mamba"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg, pctx,
                state=cache["ssm"][gi, li], conv_prev=cache["conv"][gi, li],
                single_step=True)
            cache["ssm"][gi, li] = state
            cache["conv"][gi, li] = conv
            x = x + y
    return head_logits(params, cfg, x, 1, pctx), cache
