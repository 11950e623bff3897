"""RWKV6 WKV recurrence with the ``[hd, hd]`` state kept on chip.

Counterpart of ``repro.kernels.wkv6`` (the Pallas kernel that carries the
state in VMEM across sequence chunks).  The CUDA kernel is
``csrc/wkv6.cu``; its source says what bounds it and how.  Beside it,
:func:`wkv6_plain` is the same recurrence, step by step, in plain PyTorch.

The TPU kernel factorises the decay inside a chunk and clamps it at 80 nats,
so it equals the recurrence only while a chunk's cumulative decay stays
under 80 nats; the port computes the recurrence itself, exactly, for any
decay and any ``S >= 1``.

Two fronts over one launch: :func:`wkv6` takes the JAX kernel's
``[BH, S, hd]`` with ``u`` ``[BH, hd]``; :func:`wkv6_heads` takes the
model's ``[B, S, H, hd]`` with ``u`` ``[H, hd]`` and reads it in place
through strides.  Each launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations (one thread each)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"wkv6": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 5 + [ctypes.c_int, ctypes.c_void_p]}

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/logw: [BH, S, hd]; u: [BH, hd].  The recurrence step by step
    in f32 from a zero state, vectorised over BH and the state; the output
    in ``r.dtype``."""
    bh, s, hd = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()
    state = torch.zeros(bh, hd, hd, dtype=torch.float32, device=r.device)
    y = torch.empty(bh, s, hd, dtype=torch.float32, device=r.device)
    for t in range(s):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        y[:, t] = (rt[:, :, None] * state).sum(1) + bonus * vt
        state = state * w[:, t, :, None] + kt[:, :, None] * vt[:, None, :]
    return y.to(r.dtype)


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


def _wkv(r, k, v, logw, u) -> torch.Tensor:
    """[B, S, H, hd] inputs, u [B, H, hd] -> contiguous [B, S, H, hd]."""
    _check(r, k, v, logw, u)
    b, s, h, hd = r.shape
    if r.device.type == "cpu":
        def bh(t):
            return t.permute(0, 2, 1, 3).reshape(b * h, s, hd)
        y = wkv6_plain(bh(r), bh(k), bh(v), bh(logw), u.reshape(b * h, hd))
        return y.reshape(b, h, s, hd).permute(0, 2, 1, 3).contiguous()
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    global launches
    lib = _build.load("wkv6", _SIGNATURES)
    y = torch.empty(b, s, h, hd, dtype=r.dtype, device=r.device)
    err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                   u.data_ptr(), y.data_ptr(), b, s, h, hd, r.stride(0),
                   r.stride(1), r.stride(2), u.stride(0), u.stride(1),
                   _DTYPE_CODE[r.dtype],
                   torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError_t {err}")
    launches += 1
    return y


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/logw: [BH, S, hd]; u: [BH, hd].  Returns [BH, S, hd] in
    ``r.dtype`` (the JAX kernel's signature, without its chunk: the result
    does not depend on one)."""
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
