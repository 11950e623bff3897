"""Weights from the JAX package's parameter tree into the port's layout.

The tree is the one ``repro.models.api.Model.init`` returns, with its
leaves already turned into numpy arrays by the caller; this module never
imports JAX.  Names and layouts are kept; matrices go to the config's
compute dtype and vectors to float32, the port's storage rule
(:mod:`repro_torch.models.transformer`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig

_STACKED = ("layers",)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    dev = _device.resolve(device)
    matrix_dtype = getattr(torch, cfg.dtype)

    def convert(node, stacked: bool):
        if isinstance(node, dict):
            return {k: convert(v, stacked or k in _STACKED)
                    for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)   # a writable copy
        per_layer_ndim = arr.ndim - (1 if stacked else 0)
        dt = matrix_dtype if per_layer_ndim >= 2 else torch.float32
        return torch.from_numpy(arr).to(device=dev, dtype=dt)

    return convert(tree, False)
