"""Uniform model API (counterpart of ``repro.models.api``): the reference's
seven families, dense, ssm (RWKV6), moe, mla_moe, hybrid (zamba2), encdec
(whisper) and vlm (llama-3.2-vision).

Entry points default to ``device="cuda"`` and raise when no GPU is present;
the CPU runs only for a caller that passes ``device="cpu"``.  On
``device="meta"`` a model has shapes and no data: the plan builder traces
it there (:mod:`repro_torch.plan.builder`).

The reference's ``batch_specs`` (the inputs' ``PartitionSpec``s over the
data axes) has no counterpart: the port hands no sharding to a compiler.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Optional

import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import UNEVEN_HEAD_FAMILIES
from repro_torch.models import (encdec, hybrid, mla, moe, rwkv, transformer,
                                vision)

_FAMILIES: dict[str, ModuleType] = {"dense": transformer, "ssm": rwkv,
                                    "moe": moe, "mla_moe": mla,
                                    "hybrid": hybrid, "encdec": encdec,
                                    "vlm": vision}


# the families whose inputs carry the stub frontend's embeddings
MEDIA_FAMILIES = ("encdec", "vlm")


def media_ones(cfg: ModelConfig, rows: int, device) -> dict:
    """``{"media": ones [rows, M, D]}`` in the compute dtype, the stub
    frontend's embeddings the launchers feed the encdec and vlm families;
    ``{}`` for the others."""
    if cfg.family not in MEDIA_FAMILIES or not cfg.num_media_tokens:
        return {}
    return {"media": torch.ones(rows, cfg.num_media_tokens, cfg.d_model,
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: ModuleType

    def init(self, generator: Optional[torch.Generator] = None, *,
             device="cuda", masters: bool = False) -> dict:
        """Random weights on ``device``; ``generator`` (on that device)
        defaults to one seeded with 0.  Stored for serving (matrices in the
        compute dtype, :func:`~repro_torch.models.layers.to_storage`), or,
        with ``masters``, as the reference's ``Model.init`` stores them for
        training: rank >= 2 leaves in ``cfg.param_dtype`` (float32 by
        default), the rest float32.  The draws are the same."""
        dev = _device.resolve(device)
        if generator is None:
            # a meta tensor draws nothing: any generator serves its shapes
            gdev = "cpu" if dev.type == "meta" else dev
            generator = torch.Generator(device=gdev).manual_seed(0)
        return self.mod.init(self.cfg, generator, dev, masters=masters)

    def forward(self, params, batch, pctx=None):
        return self.mod.forward(params, self.cfg, batch, pctx)

    def loss(self, params, batch, pctx=None):
        return self.mod.loss(params, self.cfg, batch, pctx)

    def init_cache(self, batch: int, max_seq: int, *, device="cuda",
                   world: int = 1, rank: int = 0) -> dict:
        """The decode cache of rank ``rank`` of ``world``: the K/V hold
        that rank's KV heads (the media's too for vlm), the ssm family's
        state and hybrid's Mamba2 states its heads, hybrid's conv tails its
        channels; mla_moe's latent is whole on every rank.  Only the
        families of the uneven head cut
        (:data:`~repro_torch.parallel.sharding.UNEVEN_HEAD_FAMILIES`) size
        a rank's cache by its rank; every other family's cut is even, the
        same on every rank."""
        extra = {"rank": rank} \
            if self.cfg.family in UNEVEN_HEAD_FAMILIES else {}
        return self.mod.init_cache(self.cfg, batch, max_seq,
                                   _device.resolve(device), world, **extra)

    def decode_step(self, params, batch, cache, pctx=None):
        return self.mod.decode_step(params, self.cfg, batch, cache, pctx)

    @property
    def has_prefill(self) -> bool:
        return hasattr(self.mod, "prefill")

    def prefill(self, params, batch, cache, pctx=None, pos_offset=0):
        """Batched causal forward over a chunk that writes into ``cache`` at
        positions ``pos_offset..pos_offset+C-1``; returns (logits, cache)."""
        return self.mod.prefill(params, self.cfg, batch, cache, pctx,
                                pos_offset)

    def gemm_layers(self, tokens: int = 256):
        """One decoder block's GEMMs (:func:`repro_torch.core.ops.
        transformer_gemms`): the unit the plan builder's mapper search and
        tile planning run over.  Whole-model totals scale linearly in depth,
        so per-block verdicts do not depend on it."""
        from repro_torch.core.ops import transformer_gemms
        return transformer_gemms(self.cfg, tokens)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """``meta`` tensors of one (arch x shape) cell's inputs, as the
        reference's ``ShapeDtypeStruct`` stand-ins: ``tokens`` [B, S] (and
        ``labels`` for train), or for decode one new token [B, 1] and
        ``pos``.  The port's decode takes a position a row, ``pos`` [B]
        (the paged step's form); the reference's scalar ``pos`` has no meta
        form, since a 0-d tensor is read with ``int()``.  The encdec and vlm
        families also take ``media`` [B, num_media_tokens, d_model] in the
        compute dtype (the frontends' precomputed embeddings)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = dict(dtype=torch.int32, device="meta")
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": torch.empty((b, s), **meta)}
            if shape.kind == "train":
                specs["labels"] = torch.empty((b, s), **meta)
        else:
            specs = {"tokens": torch.empty((b, 1), **meta),
                     "pos": torch.empty((b,), **meta)}
        if cfg.family in MEDIA_FAMILIES and cfg.num_media_tokens:
            specs["media"] = torch.empty(
                (b, cfg.num_media_tokens, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device="meta")
        return specs


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; "
                       f"have {sorted(_FAMILIES)}")
    return Model(cfg, _FAMILIES[cfg.family])


def cache_leaves(tree: dict, prefix: str = "") -> dict:
    """The leaves of a nested decode cache (or of a tree mirroring one) by
    path: ``"moe/latent"`` for ``cache["moe"]["latent"]``, the name alone
    for a top-level leaf."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(cache_leaves(node, f"{prefix}{name}/"))
        else:
            out[prefix + name] = node
    return out


def cache_batch_axes(cfg: ModelConfig) -> dict:
    """Each leaf of the config's decode cache, by path, to its batch-axis
    index, as the family states it (dense ``k``/``v`` ``[L, B, S, K,
    hd]``; ssm ``state`` ``[L, B, H, hd, hd]``, ``tprev``/``cprev`` ``[L,
    B, 1, D]``; moe ``k``/``v`` (and ``dk``/``dv``); mla_moe
    ``moe/latent``, ``moe/k_rope`` (and ``dense/...``) ``[L, B, S, R]``;
    hybrid ``ssm`` ``[G, per, B, H, hd, N]``, ``conv`` ``[G, per, B, K-1,
    C]``, ``k``/``v`` ``[G, B, S, heads, hd]``; encdec ``k``/``v`` as
    dense; vlm ``k``/``v`` ``[G, per - 1, B, S, K, hd]``, ``mk``/``mv``
    ``[G, B, M, K, hd]``)."""
    mod = get_model(cfg).mod
    tree = mod.init_cache(cfg, 1, 1, torch.device("meta"))
    return {path: mod.CACHE_BATCH_AXES[path] for path in cache_leaves(tree)}


def stream_leaves(cfg: ModelConfig) -> dict:
    """The whole leaves the family applies to its residual stream between
    the blocks, by path (``"layers/ln1"``), each to the batch input whose
    sequence (axis 1) that stream follows (``"tokens"``; whisper's
    encoder ``"media"``), as the family states it: under rs_seq each acts
    on a rank's slice of that sequence, so its gradient is partial."""
    return get_model(cfg).mod.STREAM_LEAVES


def paged_cache_leaves(cfg: ModelConfig) -> tuple:
    """The paths of the decode-cache leaves with a sequence axis, which the
    serving pool pages by position; every other leaf (a recurrent state) is
    stored whole per request.  Stated by the family, never guessed from
    extents."""
    paged = get_model(cfg).mod.PAGED_CACHE_LEAVES
    return tuple(path for path in cache_batch_axes(cfg) if path in paged)
