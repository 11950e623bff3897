"""Gradient compression for the cross-pod data-parallel all-reduce
(counterpart of ``repro.runtime.compression``).

Two codecs, both with error feedback (the residual of one step is added
back into the next step's gradient, so compression error does not bias the
optimizer in expectation):

  * int8 per-tensor quantization (~4x over fp32 on the wire);
  * top-k magnitude sparsification (k a fraction of the leaf).

:func:`compressed_psum` applies codec -> all-reduce over a process group
-> decode, with the reference's wire format: the int8 payload is summed as
``int32`` and the scales beside it, and the arithmetic runs in the
reference's order (``torch.round`` rounds half to even, as ``jnp.round``
does; the top-k threshold is the k-th largest magnitude, and every element
at or above it is kept, ties included).  Plain PyTorch on
``torch.distributed``: the reference's codec is no Pallas kernel.  As in
the reference, the train step does not call it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

from repro_torch.core.collectives import all_reduce_, axis_size
from repro_torch.optim.adamw import tree_map

Codec = Literal["none", "int8", "topk"]


# --------------------------------------------------------------------------- #
# int8 error-feedback quantization
# --------------------------------------------------------------------------- #
def int8_encode(g: torch.Tensor, err: torch.Tensor):
    """(int8 payload, float32 scale, float32 residual) of ``g + err``."""
    g32 = g.float() + err
    scale = g32.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.float() * scale
    return q, scale, new_err


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# --------------------------------------------------------------------------- #
# top-k error-feedback sparsification
# --------------------------------------------------------------------------- #
def topk_encode(g: torch.Tensor, err: torch.Tensor, frac: float = 0.05):
    """(``g + err`` where its magnitude is among the largest ``frac``, else
    0; the float32 residual)."""
    g32 = g.float() + err
    flat = g32.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    sparse = torch.where(g32.abs() >= thresh, g32, 0.0)
    return sparse, g32 - sparse


# --------------------------------------------------------------------------- #
# compressed all-reduce
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class CompressionState:
    """Error-feedback residuals, one float32 tensor per gradient leaf (the
    same nested dicts)."""
    err: dict

    @staticmethod
    def init(grads) -> "CompressionState":
        return CompressionState(err=tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads))


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The all-reduced sum of ``x`` over ``group``, into a copy."""
    if axis_size(group) == 1:
        return x
    return all_reduce_(x.clone(), group)


def compressed_psum(grads, state: CompressionState, group,
                    codec: Codec = "int8", topk_frac: float = 0.05):
    """The mean of ``grads`` over the ranks of ``group`` (``None``: one
    rank) under ``codec``; returns (reduced grads, each leaf in its own
    dtype, the new state).  ``"none"`` and 0-d leaves are summed as they
    are, with a zero residual."""
    n = axis_size(group)

    def leaf(g, e):
        if codec == "none" or g.dim() == 0:
            return _sum(g, group) / n, torch.zeros(
                g.shape, dtype=torch.float32, device=g.device)
        if codec == "int8":
            q, scale, err = int8_encode(g, e)
            # wire format: the int8 payload summed as int32, and the scales
            total = _sum(q.to(torch.int32), group)
            scale_sum = _sum(scale, group)
            return (total.float() * (scale_sum / n) / n).to(g.dtype), err
        if codec == "topk":
            sparse, err = topk_encode(g, e, topk_frac)
            return (_sum(sparse, group) / n).to(g.dtype), err
        raise ValueError(f"unknown codec {codec!r}")

    out = tree_map(leaf, grads, state.err)
    reduced = tree_map(lambda t: t[0], out)
    new_err = tree_map(lambda t: t[1], out)
    return reduced, CompressionState(err=new_err)
