"""RWKV6 WKV recurrence with the ``[hd, hd]`` state kept on chip.

Counterpart of ``repro.kernels.wkv6`` (the Pallas kernel that carries the
state in VMEM across sequence chunks).  The CUDA kernel is
``csrc/wkv6.cu``; its source says what bounds it and how.  Beside it,
:func:`wkv6_plain` is the same chunked arithmetic in plain PyTorch, blocked
like the kernel (chunk and sub-block from :func:`plan_wkv6`).

Both evaluate the recurrence in chunks of C positions: y is the carried
state read through each query's decay from the chunk start, plus the
causal scores inside the chunk times v, plus the u-bonus diagonal; the
state then steps a whole chunk at once.  The TPU kernel factorises the
decay inside a chunk and clamps it at 80 nats, so it equals the recurrence
only while a chunk's cumulative decay stays under 80 nats.  Here every
exponent is a sum of logw over a span that ends where it starts or later,
so it is <= 0 for any logw <= 0: nothing is clamped, nothing overflows,
and a factor that underflows stands for a term below float32's range.
Scores inside the chunk go through sub-blocks of ``sub`` positions: a
query anchors at its sub-block's start, a key at its sub-block's end, and
a per-channel decay joins the two sub-blocks; pairs inside one sub-block
take their decay directly.

Two fronts over one launch: :func:`wkv6` takes the JAX kernel's
``[BH, S, hd]`` with ``u`` ``[BH, hd]``; :func:`wkv6_heads` takes the
model's ``[B, S, H, hd]`` with ``u`` ``[H, hd]`` and reads it in place
through strides.  Each launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors; on ``meta`` tensors it checks what the
launch would and records :func:`cost` instead
(:func:`repro_torch.core.cost.record_kernel`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.cost import record_kernel
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel_strides

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations
SUB = 8                         # positions of a sub-block
WARPS = 16                      # warps a CTA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"wkv6": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4
               + [ctypes.c_void_p]}

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)


class Wkv6Plan(NamedTuple):
    chunk: int    # positions a CTA takes per step of its loop
    sub: int      # positions of a sub-block of the intra-chunk scores
    warps: int    # warps a CTA
    ctas: int     # one per (batch, head)


def chunk_size(hd: int) -> int:
    """C: 64 positions, 16 at hd 128, where the state's two copies take 128
    KB of the CTA's shared memory.  The same for both dtypes, so that bf16
    and float32 inputs of equal values give equal bits.  Compiled into
    ``csrc/wkv6.cu`` likewise."""
    return 16 if hd == 128 else 64


@functools.lru_cache(maxsize=256)
def plan_wkv6(b: int, h: int, hd: int) -> Wkv6Plan:
    """The launch for ``b`` sequences of ``h`` heads of ``hd``: one CTA of
    ``WARPS`` warps per (sequence, head) walks the chunks in order."""
    return Wkv6Plan(chunk_size(hd), SUB, WARPS, b * h)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/logw: [BH, S, hd]; u: [BH, hd].  The kernel's chunked form in
    f32 from a zero state (chunk and sub-block as :func:`plan_wkv6` gives
    them), vectorised over BH and the chunks; only the
    state's step from chunk to chunk is a loop.  The output in
    ``r.dtype``."""
    bh, s, hd = r.shape
    c, t = chunk_size(hd), SUB
    n = c // t
    nc = -(-s // c)

    def blocks(x):   # [BH, S, hd] -> [BH, chunks, sub-blocks, SUB, hd]
        return F.pad(x.float(), (0, 0, 0, nc * c - s)).reshape(
            bh, nc, n, t, hd)
    # padded positions: k = v = 0 adds nothing, logw = 0 decays nothing
    rf, kf, vf, lw = (blocks(x) for x in (r, k, v, logw))

    # Within each sub-block, added in order so that both fall with i:
    # cum[i] = logw summed from the sub-block's start to i, and
    # cum_prev[i] = cum[i - 1] (0 at the start).
    cum, cum_prev = torch.empty_like(lw), torch.empty_like(lw)
    run = torch.zeros_like(lw[..., 0, :])
    for m in range(t):
        cum_prev[..., m, :] = run
        run = run + lw[..., m, :]
        cum[..., m, :] = run
    # G[b] = logw summed from the chunk's start to the end of sub-block
    # b - 1 (G[0] = 0, G[n] the whole chunk), again in order.
    g = [torch.zeros_like(run[:, :, 0])]
    for b in range(n):
        g.append(g[-1] + run[:, :, b])
    G = torch.stack(g, 2)                                # [BH, nc, n+1, hd]

    # queries anchored at their sub-block's start, keys at its end
    q_sub = rf * torch.exp(cum_prev)                     # cum_prev <= 0
    k_sub = kf * torch.exp(run[..., None, :] - cum)      # run <= cum
    # ... and at the chunk's start (for the carried state) and end (for
    # the state's step)
    q_chunk = q_sub * torch.exp(G[:, :, :n, None])       # G <= 0
    k_chunk = k_sub * torch.exp(G[:, :, n:, None] - G[:, :, 1:, None])
    decay = torch.exp(G[:, :, n])                        # [BH, nc, hd]

    scores = rf.new_zeros(bh, nc, n, t, n, t)
    for qb in range(n):
        for kb in range(qb):
            # decay from the end of key sub-block kb to the start of qb
            d = torch.exp(G[:, :, qb] - G[:, :, kb + 1])
            scores[:, :, qb, :, kb] = torch.einsum(
                "bnic,bnjc->bnij", q_sub[:, :, qb] * d[:, :, None],
                k_sub[:, :, kb])
    # pairs inside a sub-block: key j < query i, decay cum_prev[i] - cum[j]
    # (<= 0: cum falls with i); the diagonal is the u bonus
    qi, kj = torch.tril_indices(t, t, -1)
    inner = (rf[..., qi, :] * kf[..., kj, :]
             * torch.exp(cum_prev[..., qi, :] - cum[..., kj, :])).sum(-1)
    diag = rf.new_zeros(bh, nc, n, t, t)
    diag[..., qi, kj] = inner
    ii = torch.arange(t)
    diag[..., ii, ii] = (rf * u.float()[:, None, None, None] * kf).sum(-1)
    for b in range(n):
        scores[:, :, b, :, b] = diag[:, :, b]

    y = scores.reshape(bh, nc, c, c) @ vf.reshape(bh, nc, c, hd)
    q_chunk, k_chunk, vc = (x.reshape(bh, nc, c, hd)
                            for x in (q_chunk, k_chunk, vf))
    state = rf.new_zeros(bh, hd, hd)
    for i in range(nc):
        y[:, i] += q_chunk[:, i] @ state
        state = decay[:, i, :, None] * state \
            + k_chunk[:, i].transpose(1, 2) @ vc[:, i]
    return y.reshape(bh, nc * c, hd)[:, :s].to(r.dtype)


def _check(r, k, v, logw, u) -> None:
    """r/k/v/logw: [B, S, H, hd] sharing one stride set, unit along hd;
    u: [B, H, hd] (a broadcast view is fine), unit stride along hd."""
    if not (r.device == k.device == v.device == logw.device == u.device):
        raise ValueError("r, k, v, logw and u must share a device")
    if r.dtype not in _DTYPE_CODE or not (r.dtype == k.dtype == v.dtype):
        raise TypeError(f"wkv6 takes r/k/v in float32 or bfloat16 of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv6 takes logw and u in float32, got {logw.dtype} "
                        f"and {u.dtype}")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logw {tuple(logw.shape)}")
    b, s, h, hd = r.shape
    if u.shape != (b, h, hd):
        raise ValueError(f"u {tuple(u.shape)} for r {tuple(r.shape)}")
    if min(b, s, h) == 0:
        raise ValueError(f"empty wkv6 {tuple(r.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not (r.stride() == k.stride() == v.stride() == logw.stride()) \
            or r.stride(3) != 1 or u.stride(2) != 1:
        raise ValueError(f"wkv6 needs r/k/v/logw on one stride set with unit "
                         f"stride along hd, got {r.stride()}, {k.stride()}, "
                         f"{v.stride()}, {logw.stride()}; u {u.stride()}")


def wkv6_heads_plain(r, k, v, logw, u) -> torch.Tensor:
    """:func:`wkv6_plain` on the model's layout: [B, S, H, hd] inputs, u
    [B, H, hd] -> contiguous [B, S, H, hd] in ``r.dtype``."""
    b, s, h, hd = r.shape

    def bh(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, hd)
    y = wkv6_plain(bh(r), bh(k), bh(v), bh(logw), u.reshape(b * h, hd))
    return y.reshape(b, h, s, hd).permute(0, 2, 1, 3).contiguous()


def cost(b: int, s: int, h: int, hd: int, elt: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch: 4 B S H hd^2 (the state's read and
    its step, 2 each a position); r, k, v read and y written at ``elt``
    bytes an element and logw at 4 (float32): the work the bound and the
    dry-run count."""
    return 4 * b * s * h * hd * hd, b * s * h * hd * (4 * elt + 4)


def _wkv(r, k, v, logw, u) -> torch.Tensor:
    """[B, S, H, hd] inputs, u [B, H, hd] -> contiguous [B, S, H, hd]."""
    _check(r, k, v, logw, u)
    b, s, h, hd = r.shape
    if r.device.type == "cpu":
        return wkv6_heads_plain(r, k, v, logw, u)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6 runs on cuda, cpu or meta, not {r.device}")
    global launches
    # the kernel's 16-byte copies: each base and stepped stride on the grid
    sb, st, sh = kernel_strides(r)
    for x in (k, v, logw):
        kernel_strides(x)
    plan = plan_wkv6(b, h, hd)
    if r.device.type == "meta":
        record_kernel("wkv6", *cost(b, s, h, hd, r.element_size()))
        return torch.empty(b, s, h, hd, dtype=r.dtype, device="meta")
    lib = _build.load("wkv6", _SIGNATURES)
    y = torch.empty(b, s, h, hd, dtype=r.dtype, device=r.device)
    err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                   u.data_ptr(), y.data_ptr(), b, s, h, hd, sb, st, sh,
                   u.stride(0), u.stride(1), _DTYPE_CODE[r.dtype], plan.chunk,
                   plan.sub, plan.warps,
                   torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError_t {err}")
    launches += 1
    return y


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/logw: [BH, S, hd]; u: [BH, hd].  Returns [BH, S, hd] in
    ``r.dtype`` (the JAX kernel's signature, without its chunk: the port's
    is fixed by :func:`plan_wkv6`)."""
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(f"wkv6 takes r [BH, S, hd] and u [BH, hd], got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    return _wkv(r[:, :, None], k[:, :, None], v[:, :, None],
                logw[:, :, None], u[:, None])[:, :, 0]


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/logw: [B, S, H, hd], read in place; u: [H, hd], shared by the
    batch.  Returns contiguous [B, S, H, hd] in ``r.dtype``."""
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError(f"wkv6_heads takes r [B, S, H, hd] and u [H, hd], "
                         f"got {tuple(r.shape)} and {tuple(u.shape)}")
    return _wkv(r, k, v, logw, u.expand(r.shape[0], *u.shape))


class Wkv6(torch.autograd.Function):
    """:func:`wkv6_heads` with a gradient: the forward is the kernel on
    CUDA tensors (the plain version on CPU tensors), and saves r, k, v,
    logw and u; the backward recomputes :func:`wkv6_plain` in float32 from
    them and takes its VJP, each gradient in its input's dtype (u's summed
    over the batch, which shares it).  No kernel launches in the
    backward.  ``kept`` (a 1-tuple): the recorded output a checkpointed
    layer's recompute returns without a launch
    (:func:`repro_torch.core.remat.kernel`)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, kept: tuple | None = None
                ) -> torch.Tensor:
        ctx.save_for_backward(r, k, v, logw, u)
        if kept is not None:
            return kept[0].detach()
        return _wkv(r, k, v, logw, u.expand(r.shape[0], *u.shape))

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        saved = ctx.saved_tensors
        with torch.enable_grad(), \
                torch.profiler.record_function("wkv6_backward"):
            r, k, v, logw, u = (t.detach().float().requires_grad_()
                                for t in saved)
            y = wkv6_heads_plain(r, k, v, logw,
                                 u.expand(r.shape[0], *u.shape))
            grads = torch.autograd.grad(y, (r, k, v, logw, u), dy.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved)) + (None,)
