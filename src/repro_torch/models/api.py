"""Uniform model API (counterpart of ``repro.models.api``), dense family.

Entry points default to ``device="cuda"`` and raise when no GPU is present;
the CPU runs only for a caller that passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Optional

import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES: dict[str, ModuleType] = {"dense": transformer}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: ModuleType

    def init(self, generator: Optional[torch.Generator] = None, *,
             device="cuda") -> dict:
        """Random weights on ``device``; ``generator`` (on that device)
        defaults to one seeded with 0."""
        dev = _device.resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return self.mod.init(self.cfg, generator, dev)

    def forward(self, params, batch, pctx=None):
        return self.mod.forward(params, self.cfg, batch, pctx)

    def loss(self, params, batch, pctx=None):
        return self.mod.loss(params, self.cfg, batch, pctx)

    def cache_shapes(self, batch: int, max_seq: int) -> dict:
        return self.mod.cache_shapes(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int, *, device="cuda") -> dict:
        return self.mod.init_cache(self.cfg, batch, max_seq,
                                   _device.resolve(device))

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


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1, "
            f"item 8); the port has {sorted(_FAMILIES)}")
    return Model(cfg, _FAMILIES[cfg.family])


def cache_batch_axes(cfg: ModelConfig) -> dict:
    """Each decode-cache leaf's batch-axis index (``[L, B, S, K, hd]``)."""
    get_model(cfg)
    return {"k": 1, "v": 1}
