"""State-space blocks: Mamba2 (chunked SSD) and RWKV6 (Finch) time-mix and
channel-mix (counterpart of ``repro.models.ssm``).

Projections go through :mod:`repro_torch.parallel.tp`, and so through the
INA matmul kernel; RWKV6's decay LoRA product stays ``torch.matmul``, as it
is a plain ``@`` in the reference.  The multi-token time-mix runs the wkv6
kernel (:func:`repro_torch.kernels.ops.wkv`) where the reference scans
``_wkv_chunk``; the single-step updates stay plain PyTorch, as they are
plain JAX in the reference.  Mamba2's SSD scan is plain PyTorch, a Python
loop over the reference's chunks, as it is a ``lax.scan`` of plain JAX
there (no Pallas kernel computes it).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.core.remat import product
from repro_torch.parallel import tp
from repro_torch.parallel.tp import ParallelCtx, col_linear, row_linear

LORA = 64   # rank of the data-dependent decay's LoRA


def group_rms_norm(y: torch.Tensor, w: torch.Tensor, width: int,
                   cfg: ModelConfig,
                   pctx: Optional[ParallelCtx]) -> torch.Tensor:
    """An RMS norm over all ``width`` channels of a row (not a per-head
    group norm): RWKV6's output norm and Mamba2's gate norm.  Where ``y``
    holds this rank's heads only (and ``w`` their weights), the row's sum
    of squares is summed over the group by one native all-reduce of [B, S,
    1]: a norm's statistic, not a partial sum of the paper's, so it is no
    psum site and ``auto`` records nothing for it.  Each rank reads the
    sum over its own channels only, so in training its gradient of the sum
    is partial, and the backward sums it over the group
    (:func:`~repro_torch.core.collectives.psum_stat`)."""
    if y.shape[-1] == width:
        return L.rms_norm(y, w, cfg.norm_eps)
    y32 = y.float()
    ss = C.psum_stat(y32.square().sum(-1, keepdim=True), pctx.group)
    return (y32 * torch.rsqrt(ss / width + cfg.norm_eps)
            * w.float()).to(y.dtype)


# =========================================================================== #
# Mamba2
# =========================================================================== #
def mamba2_dims(cfg: ModelConfig):
    """(d_inner, heads, d_state, head dim, conv kernel)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.d_state, s.head_dim, \
        s.conv_kernel


def init_mamba2(generator, cfg: ModelConfig, device=None) -> dict:
    """One Mamba2 block's weights in float32 (``w_in``'s columns in the
    order z, x, B, C, dt)."""
    d = cfg.d_model
    d_inner, h, n, hd, ck = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n

    def dense(shape):
        return L.dense_init(generator, shape, device=device)
    return {
        "w_in": dense((d, 2 * d_inner + 2 * n + h)),
        "conv_w": dense((ck, conv_dim)) * 0.1,
        "conv_b": torch.zeros(conv_dim, device=device),
        "A_log": torch.zeros(h, device=device),
        "D": torch.ones(h, device=device),
        "dt_bias": torch.zeros(h, device=device),
        "gate_norm": torch.ones(d_inner, device=device),
        "w_out": dense((d_inner, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: [B, S, C], w: [K, C]; ``prev`` the last
    K-1 inputs before x (zeros where None).  Returns (y, the last K-1
    inputs), the taps summed in x's dtype in the reference's order."""
    k = w.shape[0]
    pad = prev if prev is not None else x.new_zeros(x.shape[0], k - 1,
                                                     x.shape[2])
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    return F.silu(y + b.to(x.dtype)), xp[:, -(k - 1):]


def _ssd(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """One of the SSD's einsums, batched over B and the chunks
    (:func:`repro_torch.core.remat.product`)."""
    return product("ssd", "batched", torch.einsum, eq, *operands)


def _ssd_chunks(state: torch.Tensor, xs: tuple, cfg: ModelConfig):
    """SSD over chunks side by side.  state: [B, H, hd, N] f32, entering
    the first chunk; xs = (x [B, nc, C, H, hd], Bm/Cm [B, nc, C, N],
    logdec/dt [B, nc, C, H]).  Each chunk's own terms (the causal
    intra-chunk product and its state update) are computed for every chunk
    at once; only the carried state steps from chunk to chunk, as it does
    through the reference's scan of ``_ssd_chunk``.  The intra-chunk decay
    matrix and scores are in ``cfg.ssm.scores_dtype``, the products in x's
    dtype, as the reference's.  Returns (the state after the last chunk,
    y [B, nc, C, H, hd])."""
    x, bm, cm, logdec, dt = xs
    sdt = getattr(torch, cfg.ssm.scores_dtype)
    # [B, nc, C, H], scanned along the last axis (an H100 scans an inner
    # axis serially, several times slower)
    cum = torch.cumsum(logdec.transpose(2, 3), dim=-1).transpose(2, 3)
    ratio = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, t, s, H]
    tpos = torch.arange(x.shape[2], device=x.device)
    mask = (tpos[:, None] >= tpos[None, :])[:, :, None]
    # exp of the causal ratios only: above the diagonal a ratio is a decay
    # read backwards, past exp's range at a 256-token chunk, and the
    # backward's 0 * exp(inf) would be NaN (the same values as the
    # reference's where(mask, exp(ratio), 0), whose gradient is NaN there)
    dec = torch.exp(torch.where(mask, ratio, float("-inf"))).to(sdt)
    scores = _ssd("bctn,bcsn->bcts", cm, bm).to(sdt)[..., None] \
        * dec * dt[:, :, None].to(sdt)                    # [B, nc, t, s, H]
    y = _ssd("bctsh,bcshd->bcthd", scores.to(x.dtype), x)
    tail = torch.exp(cum[:, :, -1:] - cum)                # [B, nc, C, H]
    upd = _ssd("bcsh,bcshd,bcsn->bchdn", (tail * dt).to(x.dtype), x,
               bm)                                        # [B, nc, H, hd, N]
    decay = torch.exp(cum[:, :, -1])[..., None, None]     # [B, nc, H, 1, 1]
    starts = []
    for c in range(x.shape[1]):
        starts.append(state)
        state = state * decay[:, c] + upd[:, c]
    # the carried state's contribution
    y = y + _ssd("bctn,bchdn,bcth->bcthd", cm,
                 torch.stack(starts, 1).to(x.dtype),
                 torch.exp(cum).to(x.dtype))
    return state, y


def _ssd_chunk(state: torch.Tensor, xs: tuple, cfg: ModelConfig):
    """One SSD chunk (the reference's ``_ssd_chunk``).  state: [B, H, hd,
    N] f32; xs = (x [B, C, H, hd], Bm/Cm [B, C, N], logdec [B, C, H], dt
    [B, C, H]).  Returns (new state, y [B, C, H, hd])."""
    state, y = _ssd_chunks(state, tuple(t[:, None] for t in xs), cfg)
    return state, y[:, 0]


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 pctx: Optional[ParallelCtx] = None, state=None,
                 conv_prev=None, single_step: bool = False):
    """x: [B, S, D] -> (y [B, S, D], state [B, H, hd, N] f32, the conv's
    last K-1 inputs).  ``single_step`` (S = 1) advances the decode caches
    ``state`` and ``conv_prev``; otherwise the sequence runs in chunks of
    ``cfg.ssm.chunk`` (:func:`_ssd_chunks`) from ``state`` (zeros where
    None), the last one zero-padded as the reference pads it.

    ``p`` may be a rank's shard (:mod:`repro_torch.parallel.sharding`): H
    and d_inner are then the rank's heads and channels, read from
    ``A_log`` and ``gate_norm``; ``w_in`` gives z, x and dt of those heads
    and B and C whole, ``w_out``'s row psum sums the heads, and the gate
    norm takes its statistic over the group (:func:`group_rms_norm`).  In
    training every path from ``x`` reaches the rank's heads (B and C meet
    them in the SSD), so one ``f`` at the entry
    (:func:`~repro_torch.parallel.tp.enter_cut`) sums ``x``'s gradient,
    and the one packed product stays; the whole B and C segments of
    ``w_in``, ``conv_w`` and ``conv_b`` it passes on the way get partial
    gradients, which the train step sums
    (:class:`~repro_torch.parallel.steps.GradSync`)."""
    b, s, _ = x.shape
    h, d_inner = p["A_log"].shape[-1], p["gate_norm"].shape[-1]
    n, hd = cfg.ssm.d_state, cfg.ssm.head_dim
    proj = col_linear(tp.enter_cut(x, pctx), p["w_in"], pctx)
    z, xin, bm, cm, dt = torch.split(proj, [d_inner, d_inner, n, n, h],
                                     dim=-1)
    conv_out, conv_prev = _causal_conv(torch.cat([xin, bm, cm], dim=-1),
                                       p["conv_w"], p["conv_b"], conv_prev)
    xin, bm, cm = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())     # [B, S, H]
    logdec = dt * -torch.exp(p["A_log"].float())
    xh = xin.reshape(b, s, h, hd)
    if state is None:
        state = torch.zeros(b, h, hd, n, dtype=torch.float32,
                            device=x.device)
    if single_step:
        upd = torch.einsum("bh,bhd,bn->bhdn", dt[:, 0], xh[:, 0].float(),
                           bm[:, 0].float())
        state = state * torch.exp(logdec[:, 0])[:, :, None, None] + upd
        y = torch.einsum("bn,bhdn->bhd", cm[:, 0].float(), state)[:, None]
    else:
        chunk = min(cfg.ssm.chunk, s)
        nc = -(-s // chunk)

        def chunks(t):
            pad = t.new_zeros(b, nc * chunk - s, *t.shape[2:])
            return torch.cat([t, pad], 1).reshape(b, nc, chunk, *t.shape[2:])
        state, y = _ssd_chunks(state, tuple(map(chunks, (xh, bm, cm, logdec,
                                                         dt))), cfg)
        y = y.reshape(b, nc * chunk, h, hd)[:, :s]
    y = y.to(x.dtype) + xh * p["D"].to(x.dtype)[:, None]
    y = y.reshape(b, s, d_inner) * F.silu(z)
    y = group_rms_norm(y, p["gate_norm"], mamba2_dims(cfg)[0], cfg, pctx)
    return row_linear(y, p["w_out"], pctx), state, conv_prev


# =========================================================================== #
# RWKV6 (Finch)
# =========================================================================== #


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
    returns no final state (``None``: no caller reads it).

    ``p`` may be a rank's shard (:mod:`repro_torch.parallel.sharding`): H
    is then the rank's heads, read from ``u`` [H, hd], the projections and
    the decay give their columns, ``wo``'s row psum sums the heads, and the
    output norm takes its statistic over the group
    (:func:`group_rms_norm`).  In training every path from ``x`` reaches
    the rank's heads, so one ``f`` at the entry
    (:func:`~repro_torch.parallel.tp.enter_cut`) sums ``x``'s gradient;
    the whole ``mu`` and ``w_lora_a`` it passes on the way get partial
    gradients, which the train step sums
    (:class:`~repro_torch.parallel.steps.GradSync`)."""
    b, s, _ = x.shape
    h, hd = p["u"].shape
    x = tp.enter_cut(x, pctx)
    xs, new_prev = _shift(x, prev)
    mu = p["mu"].to(x.dtype)

    def lerp(i):
        return x + (xs - x) * mu[i]
    r = col_linear(lerp(0), p["wr"], pctx).reshape(b, s, h, hd)
    k = col_linear(lerp(1), p["wk"], pctx).reshape(b, s, h, hd)
    v = col_linear(lerp(2), p["wv"], pctx).reshape(b, s, h, hd)
    g = F.silu(col_linear(lerp(4), p["wg"], pctx))
    # data-dependent decay (LoRA)
    wx = product("lora", "nb", torch.matmul, torch.tanh(
        product("lora", "nb", torch.matmul, lerp(3),
                      p["w_lora_a"].to(x.dtype))), p["w_lora_b"].to(x.dtype))
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

    y = group_rms_norm(y.to(x.dtype).reshape(b, s, h * hd), p["ln_x"],
                       cfg.d_model, cfg, pctx) * g
    return row_linear(y, p["wo"], pctx), state, new_prev


def rwkv_cmix(p: dict, x: torch.Tensor, cfg: ModelConfig,
              pctx: Optional[ParallelCtx] = None, prev=None):
    """Returns (y, new_prev).  Under tensor parallelism ``wk`` is cut on
    d_ff and ``wv`` on its input (the INA site), while the gate's ``wr``
    is whole: so only ``xk`` enters cut work, and in training the ``f``
    (:func:`~repro_torch.parallel.tp.enter_cut`) sits on it alone.  Under
    ``rs_seq`` ``wv`` reduce-scatters over S, and the gate, computed whole
    on every rank, is sliced to the rank's rows
    (:func:`~repro_torch.parallel.tp.scatter_seq`, whose backward gathers
    its gradient whole, so ``wr``'s stays whole): ``y`` is the rank's
    slice."""
    xs, new_prev = _shift(x, prev)
    mu = p["mu"].to(x.dtype)
    xk = tp.enter_cut(x + (xs - x) * mu[0], pctx)
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(col_linear(xk, p["wk"], pctx)))
    out = row_linear(k, p["wv"], pctx)          # INA site (channel-mix)
    gate = torch.sigmoid(col_linear(xr, p["wr"], pctx))
    return out * tp.scatter_seq(gate, pctx), new_prev
