"""Flash attention forward with a query offset and grouped KV heads.

Counterpart of ``repro.kernels.flash_attention``.  The CUDA kernel is
``csrc/flash_attention.cu``; its source says what bounds it and how.

Two fronts over one launch, as for ``wkv6``:

- :func:`flash_attention_heads` takes the model's layout, q ``[B, Sq, H,
  D]`` and k/v ``[B, Sk, KVH, D]`` with ``H % KVH == 0`` (GQA), and reads
  all three in place through their strides: q straight from the
  projection, k/v straight from a slice of the KV cache.  It returns a
  contiguous ``[B, Sq, H, D]``.
- :func:`flash_attention` keeps the JAX kernel's signature, q/k/v ``[BH,
  S, D]``: the case ``B = BH``, ``H = KVH = 1``.

Query row ``i`` sits at absolute position ``q_offset + i``; with
``q_offset=0`` and ``Sq == Sk`` the function is the TPU kernel's.  The
kernel packs the ``G = H / KVH`` query heads of one KV head with the
query positions into rows (row ``i * G + g`` is head ``g`` of the group at
position ``i``), so each K/V tile is read once for the whole group.
:func:`plan_attention` gives the launch's tiles and CTAs, and the plain
versions run the kernel's online softmax over the same KV tiles.  Each
front launches the kernel for CUDA tensors and runs the plain version only
for CPU tensors; on ``meta`` tensors it checks what the launch would and
records :func:`cost` instead (:func:`repro_torch.core.cost.record_kernel`).

:class:`FlashAttention` gives the model-layout front a gradient.  The JAX
package has no attention backward kernel (its models differentiate plain
``jnp`` attention, and the Pallas kernel has no VJP), so the backward here
is the VJP of :func:`gqa_attention_f32`, a plain differentiable GQA causal
attention in f32 math over the same layout: the counterpart of XLA's
autodiff of the reference's plain attention.  A hand-written backward
kernel is queued in ROADMAP.md as kernel work.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.cost import record_kernel
from repro_torch.kernels import _build

MAX_HEAD_DIM = 160   # zamba2's shared attention: 2 x 2560 / 32 heads
NEG_INF = -1e30
# packed rows of a CTA (two row tiles: of 16 rows in bf16, one mma.sync
# tile shared by two warps that split each KV tile's keys; of 8 in float32)
# and the KV tile; the kernel is compiled for these and checks them
BQ = {torch.bfloat16: 32, torch.float32: 16}
BKV = {torch.bfloat16: 64, torch.float32: 32}
# the kernel's cp.async moves 16 bytes: every stepped stride must be a
# multiple of this many elements; D must be a multiple of 16 (the mma depth
# in bf16; the kernels are instantiated for D = 16, 32, ..., 160)
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, o; B, Sq, Sk, H, KVH, D; the strides (batch, seq, head) of q, k
# and v; q_offset, scale, causal, dtype, bq, bkv; the stream
_SIGNATURES = {"flash_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
               + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float]
               + [ctypes.c_int] * 4 + [ctypes.c_void_p]}

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)


class AttentionPlan(NamedTuple):
    """One launch: packed rows per CTA (``bq``), KV rows per tile
    (``bkv``) and the grid's CTAs."""
    bq: int
    bkv: int
    ctas: int


@functools.lru_cache(maxsize=1024)
def plan_attention(b: int, sq: int, h: int, kvh: int,
                   dtype: torch.dtype) -> AttentionPlan:
    """The launch for ``b`` sequences of ``sq`` queries on ``h`` heads over
    ``kvh`` KV heads.  A CTA takes one (sequence, KV head, tile of ``bq``
    packed rows).  The tiles depend on the dtype alone: 32 rows (4 warps,
    which share every K/V tile the CTA loads) and KV tiles of 64 in bf16,
    16 rows and KV tiles of 32 in float32.  The kernel is compiled for
    them, which at every prefill shape timed (PERF.md) ran faster than
    tiles chosen per shape at run time."""
    rows = sq * (h // kvh)
    return AttentionPlan(BQ[dtype], BKV[dtype],
                         b * kvh * -(-rows // BQ[dtype]))


def flash_attention_heads_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D].  Online softmax over the
    kernel's KV tiles with m, l and acc in f32, p cast to v's dtype before
    the PV product, the G heads of a KV head grouped by reshape (no
    repeat).  Returns a contiguous [B, Sq, H, D] in q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bkv = BKV[q.dtype]
    scale = 1.0 / math.sqrt(d)
    # packed row i * G + g of KV head j: head j * G + g at position i
    qf = q.float().reshape(b, sq, kvh, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, kvh, sq * g, d)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)   # [B, KVH, Sk, D]
    m = torch.full((b, kvh, sq * g, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, sq * g, d), dtype=torch.float32,
                      device=q.device)
    qpos = torch.arange(sq * g, device=q.device) // g + q_offset
    kv_end = min(sk, q_offset + sq) if causal else sk
    for kv0 in range(0, kv_end, bkv):
        kb = kf[:, :, kv0:kv0 + bkv].float()
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(kv0, kv0 + kb.shape[2], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() \
            @ vf[:, :, kv0:kv0 + bkv].float()
        m = m_new
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return o.reshape(b, kvh, sq, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, sq, h, d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D]; k/v: [BH, Sk, D]: the one-head case of
    :func:`flash_attention_heads_plain`."""
    return flash_attention_heads_plain(
        q[:, :, None], k[:, :, None], v[:, :, None], causal=causal,
        q_offset=q_offset)[:, :, 0]


def _check(q, k, v, q_offset: int) -> None:
    """What any device takes: shapes, dtypes, D <= 160 and unit stride
    along D (the fronts read through strides and never copy)."""
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError("empty attention")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"flash_attention needs unit stride along the head "
                         f"dim, got q {q.stride()}, k {k.stride()}, "
                         f"v {v.stride()}")


def kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, seq, head) strides of a [B, S, H, D] operand as the kernel
    takes them: a dimension of size 1 is never stepped, so its stride is
    passed as 0.  Raises where the kernel cannot follow: a D that is not a
    multiple of 16, or (for its 16-byte loads) a base or a stepped stride
    off the 16-byte grid."""
    vec = _VEC[t.dtype]
    if t.shape[3] % 16:
        raise ValueError(f"the kernel takes D a multiple of 16, got "
                         f"{t.shape[3]}")
    strides = tuple(0 if t.shape[i] == 1 else t.stride(i) for i in range(3))
    if any(s % vec for s in strides) or t.data_ptr() % 16:
        raise ValueError(f"the kernel's 16-byte loads need a 16-byte aligned "
                         f"base and strides that are multiples of {vec} "
                         f"elements, got {tuple(t.stride())}")
    return strides


def causal_pairs(sq: int, sk: int, q_offset: int = 0) -> int:
    """The (query, key) pairs causal attention scores: query i (at
    position ``q_offset + i``) sees ``min(sk, q_offset + i + 1)`` keys."""
    a = q_offset + 1                    # the first query's keys
    n1 = max(0, min(sq, sk - a + 1))    # queries that see fewer than sk
    return n1 * a + n1 * (n1 - 1) // 2 + (sq - n1) * sk


def cost(b: int, sq: int, sk: int, h: int, kvh: int, d: int, elt: int,
         causal: bool = True, q_offset: int = 0) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch: 4 B H D a scored pair (QK^T and PV,
    2 each), over :func:`causal_pairs` (every pair without ``causal``);
    q, k and v read once and o written once, ``elt`` bytes an element:
    the work the bound and the dry-run count."""
    pairs = causal_pairs(sq, sk, q_offset) if causal else sq * sk
    return 4 * b * h * d * pairs, (2 * b * sq * h + 2 * b * sk * kvh) * d * elt


def _attention(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_heads_plain(q, k, v, causal=causal,
                                           q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    plan = plan_attention(b, sq, h, kvh, q.dtype)
    strides = kernel_strides(q) + kernel_strides(k) + kernel_strides(v)
    if b > 65535 or kvh > 65535:
        raise ValueError(f"batch {b} or KV heads {kvh} > 65535 grid rows")
    if q.device.type == "meta":
        record_kernel("flash_attention", *cost(
            b, sq, sk, h, kvh, d, q.element_size(), causal, q_offset))
        return torch.empty(b, sq, h, d, dtype=q.dtype, device="meta")
    global launches
    lib = _build.load("flash_attention", _SIGNATURES)
    o = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), b, sq, sk, h, kvh, d, *strides,
                              q_offset, 1.0 / math.sqrt(d), int(causal),
                              _DTYPE_CODE[q.dtype], plan.bq, plan.bkv,
                              torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    launches += 1
    return o


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D], H a multiple of KVH, each
    read in place through its strides (unit stride along D).  Returns a
    contiguous [B, Sq, H, D] in q's dtype."""
    return _attention(q, k, v, causal, q_offset)


def gqa_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D] -> [B, Sq, H, D] in float32:
    scores, softmax and the PV product in f32, the G query heads of a KV
    head grouped by reshape.  Differentiable; it materialises the scores,
    so it serves the backward, never the forward."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).reshape(b, sq, h, d)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_heads` with a gradient: the forward is the
    kernel on CUDA tensors (the plain version on CPU tensors), and saves q,
    k and v; the backward recomputes :func:`gqa_attention_f32` from them
    and takes its VJP, cast to the inputs' dtype.  No kernel launches in
    the backward.  ``kept`` (a 1-tuple): the recorded output a
    checkpointed layer's recompute returns without a launch
    (:func:`repro_torch.core.remat.kernel`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int,
                kept: tuple | None = None) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset = causal, int(q_offset)
        if kept is not None:
            return kept[0].detach()
        return _attention(q, k, v, causal, q_offset)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad(), \
                torch.profiler.record_function("flash_attention_backward"):
            qf, kf, vf = (t.detach().float().requires_grad_()
                          for t in (q, k, v))
            o = gqa_attention_f32(qf, kf, vf, ctx.causal, ctx.q_offset)
            dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), do.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D]; k/v: [BH, Sk, D] (the JAX kernel's signature: KV
    already one head per query head).  Returns [BH, Sq, D]."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention takes [BH, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _attention(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                      q_offset)[:, :, 0]
