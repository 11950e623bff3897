"""RWKV6 (Finch) blocks: time-mix and channel-mix (counterpart of the RWKV6
half of ``repro.models.ssm``; Mamba2 comes with the hybrid family).

Projections go through :mod:`repro_torch.parallel.tp`, and so through the
INA matmul kernel; the decay's LoRA product stays ``torch.matmul``, as it is
a plain ``@`` in the reference.  The multi-token time-mix runs the wkv6
kernel (:func:`repro_torch.kernels.ops.wkv`) where the reference scans
``_wkv_chunk``; the single-step update stays plain PyTorch, as it is plain
JAX in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel.tp import ParallelCtx, col_linear, row_linear

LORA = 64   # rank of the data-dependent decay's LoRA


def rwkv_dims(cfg: ModelConfig):
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def init_rwkv_tmix(generator, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    h, hd = rwkv_dims(cfg)

    def dense(shape):
        return L.dense_init(generator, shape, device=device)
    return {
        "mu": 0.5 * torch.ones(5, d, device=device),  # token shift for r,k,v,w,g
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "w0": torch.full((d,), -6.0, device=device),  # base log-decay
        "w_lora_a": dense((d, LORA)),
        "w_lora_b": dense((LORA, d)) * 0.1,
        "u": torch.zeros(h, hd, device=device),       # per-head bonus
        "ln_x": torch.ones(d, device=device),
        "wo": dense((d, d)),
    }


def init_rwkv_cmix(generator, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    return {
        "mu": 0.5 * torch.ones(2, d, device=device),
        "wk": L.dense_init(generator, (d, cfg.d_ff), device=device),
        "wv": L.dense_init(generator, (cfg.d_ff, d), device=device),
        "wr": L.dense_init(generator, (d, d), device=device),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Token shift: x[t-1]; ``prev`` is the last token of the previous
    segment.  Returns (shifted, new_prev)."""
    last = x[:, -1:, :]
    if prev is None:
        prev = torch.zeros_like(x[:, :1, :])
    return torch.cat([prev, x[:, :-1, :]], dim=1), last


def rwkv_tmix(p: dict, x: torch.Tensor, cfg: ModelConfig,
              pctx: Optional[ParallelCtx] = None, state=None, prev=None,
              single_step: bool = False):
    """x: [B, S, D].  Returns (y, state, new_prev).  ``single_step`` (S = 1)
    updates the decode ``state`` [B, H, hd, hd]; otherwise the wkv6 kernel
    runs the whole sequence from a zero state and, as the TPU kernel does,
    returns no final state (``None``: no caller reads it)."""
    b, s, d = x.shape
    h, hd = rwkv_dims(cfg)
    xs, new_prev = _shift(x, prev)
    mu = p["mu"].to(x.dtype)

    def lerp(i):
        return x + (xs - x) * mu[i]
    r = col_linear(lerp(0), p["wr"], pctx).reshape(b, s, h, hd)
    k = col_linear(lerp(1), p["wk"], pctx).reshape(b, s, h, hd)
    v = col_linear(lerp(2), p["wv"], pctx).reshape(b, s, h, hd)
    g = F.silu(col_linear(lerp(4), p["wg"], pctx))
    # data-dependent decay (LoRA)
    wx = torch.tanh(lerp(3) @ p["w_lora_a"].to(x.dtype)) \
        @ p["w_lora_b"].to(x.dtype)
    logw = -torch.exp(torch.clamp(p["w0"].float() + wx.float(), -10.0, 2.0))
    logw = logw.reshape(b, s, h, hd)
    u = p["u"].float()

    if single_step:
        if state is None:
            state = torch.zeros(b, h, hd, hd, dtype=torch.float32,
                                device=x.device)
        rf, kf, vf = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        y = (rf[..., None] * state).sum(-2) \
            + (rf * u * kf).sum(-1, keepdim=True) * vf
        state = state * torch.exp(logw[:, 0])[..., None] \
            + kf[..., None] * vf[..., None, :]
        y = y[:, None]
    else:
        if state is not None:
            raise ValueError("the multi-token time-mix starts from a zero "
                             "state; decode passes single_step=True")
        y = ops.wkv(r, k, v, logw, u)

    y = y.to(x.dtype).reshape(b, s, d)
    y = L.rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    return row_linear(y, p["wo"], pctx), state, new_prev


def rwkv_cmix(p: dict, x: torch.Tensor, cfg: ModelConfig,
              pctx: Optional[ParallelCtx] = None, prev=None):
    xs, new_prev = _shift(x, prev)
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(col_linear(xk, p["wk"], pctx)))
    out = row_linear(k, p["wv"], pctx)          # INA site (channel-mix)
    gate = torch.sigmoid(col_linear(xr, p["wr"], pctx))
    return out * gate, new_prev
