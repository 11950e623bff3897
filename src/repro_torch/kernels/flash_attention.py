"""Flash attention forward with a query offset.

Counterpart of ``repro.kernels.flash_attention``.  The CUDA kernel is
``csrc/flash_attention.cu``; its source says what bounds it and how.
Beside it, :func:`flash_attention_plain` is the same online softmax over KV
tiles in plain PyTorch.

Query row ``i`` sits at absolute position ``q_offset + i``; with
``q_offset=0`` and ``Sq == Sk`` the function is the TPU kernel's.
:func:`flash_attention` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

BKV = 32         # the kernel's KV tile
MAX_HEAD_DIM = 128
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"flash_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]}

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """Online softmax over KV tiles of :data:`BKV` rows, m/l/acc in f32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kv_end = min(sk, q_offset + sq) if causal else sk
    for kv0 in range(0, kv_end, BKV):
        kb = k[:, kv0:kv0 + BKV].float()
        s = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            kpos = torch.arange(kv0, kv0 + kb.shape[1], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ v[:, kv0:kv0 + BKV].float()
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _check(q, k, v, q_offset: int) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError("empty attention")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[2]} > {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D]; k/v: [BH, Sk, D], KV already GQA-expanded."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.shape[0] > 65535:
        raise ValueError(f"batch*heads {q.shape[0]} > 65535 grid rows")
    global launches
    lib = _build.load("flash_attention", _SIGNATURES)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), bh, sq, k.shape[1], d, q_offset,
                              1.0 / math.sqrt(d), int(causal),
                              _DTYPE_CODE[q.dtype],
                              torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    launches += 1
    return o
