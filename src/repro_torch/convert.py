"""Weights from the JAX package's parameter tree into the port's layout.

The tree is the one ``repro.models.api.Model.init`` returns, with its
leaves already turned into numpy arrays by the caller; this module never
imports JAX.  Names and layouts are kept, and dtypes follow the port's
storage rule (:func:`repro_torch.models.layers.to_storage`): matrices in the
config's compute dtype, vectors and the RWKV6 bonus ``u`` in float32; or,
for training, the reference's master rule.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import to_masters, to_storage


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    masters: bool = False) -> dict:
    """The port's tree of ``tree`` on ``device``, stored for serving, or
    with ``masters`` as training masters
    (:func:`repro_torch.models.layers.to_masters`, the rule the
    reference's ``Model.init`` applied to ``tree``)."""
    dev = _device.resolve(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)   # a writable copy
        return torch.from_numpy(arr).to(dev)

    if masters:
        return to_masters(convert(tree), cfg.param_dtype)
    return to_storage(convert(tree), getattr(torch, cfg.dtype))
