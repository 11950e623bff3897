"""RWKV6 (Finch) language model: time-mix + channel-mix stacks (counterpart
of ``repro.models.rwkv``).

Parameters follow the reference's names and layouts, stacked ``[L, ...]``
and stored by :func:`repro_torch.models.layers.to_storage` (the bonus ``u``
stays float32).  The full-sequence forward runs the wkv6 kernel in every
layer; decode is a single-step state update that runs none.  There is no
``prefill``, as in the reference: the serving engine seats prompts through
the per-token decode loop.

The decode cache is the recurrent state ``[L, B, H, hd, hd]`` in float32
and the token-shift rows ``tprev``/``cprev`` ``[L, B, 1, D]`` in the compute
dtype.  None has a sequence axis, so the serving pool stores each whole per
request; ``decode_step`` writes them in place and returns the cache.

Under tensor parallelism the parameters are a rank's shards
(:mod:`repro_torch.parallel.sharding`): the time mix runs the rank's H/P
heads (the wkv6 kernel launches at H/P), its ``wo`` and the channel mix's
``wv`` reduce their partial sums (the two INA sites a layer), the channel
mix's gate and both token shifts stay whole, and the embedding and the
head are vocab-parallel.  The decode state holds the rank's heads, the
token-shift rows stay whole.  Under ``rs_seq`` the stream between the
blocks is this rank's slice of the sequence (cut after the embedding, so
``ln_in`` runs on the slice): each block's normed input is gathered whole
before the token shift, which reads the position before a slice's first,
as the wkv6 scan's state runs along the whole sequence; both mixes keep
their own ``f``s, so the gather's backward is the rank's slice; ``wo`` and
the channel mix's ``wv`` reduce-scatter over S, and the whole gate meets
``wv``'s slice through :func:`repro_torch.parallel.tp.scatter_seq`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (_dtype, _stack, block_input,
                                            embed_stream, head_logits, layer,
                                            remat)
from repro_torch.parallel.sharding import local_ssm_heads
from repro_torch.parallel.tp import ParallelCtx

CACHE_BATCH_AXES = {"state": 1, "tprev": 1, "cprev": 1}
PAGED_CACHE_LEAVES = ()
# as ``transformer.STREAM_LEAVES``: the block norms, ``ln_f``, and ``ln_in``
# on the embedding's slice
STREAM_LEAVES = {"ln_in": "tokens", "layers/ln1": "tokens",
                 "layers/ln2": "tokens", "ln_f": "tokens"}


def init_layer(generator, cfg: ModelConfig, device) -> dict:
    """One layer's weights in float32."""
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "tmix": S.init_rwkv_tmix(generator, cfg, device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "cmix": S.init_rwkv_cmix(generator, cfg, device),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro.models.rwkv.init``
    (the draws themselves differ: torch and JAX generators differ); stored
    as :func:`repro_torch.models.transformer.init` stores them."""
    dt = _dtype(cfg)
    per_layer = (lambda t: t) if masters else (lambda t: L.to_storage(t, dt))
    stacked = _stack([per_layer(init_layer(generator, cfg, device))
                      for _ in range(cfg.n_layers)])
    params = {
        "embed": L.dense_init(generator, (cfg.vocab, cfg.d_model),
                              device=device),
        "ln_in": torch.ones(cfg.d_model, device=device),
        "layers": stacked,
        "ln_f": torch.ones(cfg.d_model, device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                in_dim=cfg.d_model, device=device),
    }
    return L.to_masters(params, cfg.param_dtype) if masters \
        else L.to_storage(params, dt)


def layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig,
              pctx: Optional[ParallelCtx], seq: int,
              caches: Optional[dict] = None):
    """caches: None (``seq`` positions from a zero state; ``x`` this
    rank's slice of them under rs_seq) or the layer's decode caches;
    returns (x, new caches or None)."""
    if caches is None:
        # both mixes keep their own ``f``s: no ``f`` at the gather
        h = block_input(x, lp["ln1"], cfg, seq, pctx, cut=False)
        y, _, _ = S.rwkv_tmix(lp["tmix"], h, cfg, pctx)
        x = x + y
        h = block_input(x, lp["ln2"], cfg, seq, pctx, cut=False)
        y, _ = S.rwkv_cmix(lp["cmix"], h, cfg, pctx)
        return x + y, None
    y, state, tprev = S.rwkv_tmix(
        lp["tmix"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, pctx,
        state=caches["state"], prev=caches["tprev"], single_step=True)
    x = x + y
    y, cprev = S.rwkv_cmix(lp["cmix"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                           cfg, pctx, prev=caches["cprev"])
    return x + y, {"state": state, "tprev": tprev, "cprev": cprev}


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """The final stream, before ``ln_f``: this rank's slice of the
    sequence under rs_seq."""
    seq = tokens.shape[1]
    x = L.rms_norm(embed_stream(params, cfg, tokens, pctx), params["ln_in"],
                   cfg.norm_eps)
    for i in range(cfg.n_layers):
        x, _ = remat(layer_fwd, cfg, layer(params["layers"], i), x, cfg,
                     pctx, seq)
    return x


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Logits [B, S, V]; where autograd records the layers, each is
    checkpointed (:func:`~repro_torch.models.transformer.remat`)."""
    tokens = batch["tokens"]
    return head_logits(params, cfg, hidden_states(params, cfg, tokens, pctx),
                       tokens.shape[1], pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    return L.xent_loss(forward(params, cfg, batch, pctx), batch["labels"])


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                 world: int = 1) -> dict:
    """The state of the heads one rank of ``world`` holds; ``max_seq`` is
    not used: no leaf has a sequence axis."""
    hd = cfg.ssm.head_dim
    row = (cfg.n_layers, batch, 1, cfg.d_model)
    return {"state": (cfg.n_layers, batch, local_ssm_heads(cfg, world), hd,
                      hd), "tprev": row, "cprev": row}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1) -> dict:
    dtypes = {"state": torch.float32, "tprev": _dtype(cfg),
              "cprev": _dtype(cfg)}
    return {name: torch.zeros(shape, dtype=dtypes[name], device=device)
            for name, shape in cache_shapes(cfg, batch, max_seq,
                                            world).items()}


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode.  batch: {tokens: [B, 1], pos: ignored (the state
    carries the position)}; returns (logits [B, 1, V], cache), the cache
    updated in place."""
    x = L.embed(params["embed"], batch["tokens"], _dtype(cfg), pctx,
                cfg.vocab)
    x = L.rms_norm(x, params["ln_in"], cfg.norm_eps)
    for i in range(cfg.n_layers):
        x, new = layer_fwd(layer(params["layers"], i), x, cfg, pctx, 1,
                           caches={name: leaf[i] for name, leaf in cache.items()})
        for name, leaf in cache.items():
            leaf[i] = new[name]
    return head_logits(params, cfg, x, 1, pctx), cache
