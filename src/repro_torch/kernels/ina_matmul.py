"""INA matmul: ``[M, K] @ [K, N]`` with the f32 partial sum kept on chip.

Counterpart of ``repro.kernels.ina_matmul`` (the Pallas kernel whose
accumulator stays in VMEM across the K grid axis).  The CUDA kernel is
``csrc/ina_matmul.cu``; its source says what bounds it and how.  Beside it,
:func:`ina_matmul_plain` is the same K-blocked function in plain PyTorch.

:func:`ina_matmul` launches the kernel for a CUDA tensor and runs the plain
version only for a CPU tensor.  ``w`` may be a strided view whose rows or
columns are contiguous, so the tied head reads ``embed.T`` in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BK = {torch.bfloat16: 128, torch.float32: 16}   # the kernel's K tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"ina_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]}

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)


def ina_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K-blocked product: an f32 sum over the kernel's K tiles in order,
    cast to ``x.dtype`` once at the end."""
    bk = BK[x.dtype]
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], bk):
        acc += x[:, k0:k0 + bk].float() @ w[k0:k0 + bk].float()
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"ina_matmul takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if min(*x.shape, w.shape[1]) == 0:
        raise ValueError(f"empty product {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.stride(1) != 1:
        raise ValueError("x needs contiguous rows")
    if w.stride(0) != 1 and w.stride(1) != 1:
        raise ValueError(f"w needs contiguous rows or columns, strides "
                         f"{w.stride()}")


def ina_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``x``: [M, K], ``w``: [K, N], output in ``x.dtype``."""
    _check(x, w)
    if x.device.type == "cpu":
        return ina_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"ina_matmul runs on cuda or cpu, not {x.device}")
    global launches
    lib = _build.load("ina_matmul", _SIGNATURES)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    err = lib.ina_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
                         x.stride(0), w.stride(0), w.stride(1),
                         _DTYPE_CODE[x.dtype],
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ina_matmul launch failed: cudaError_t {err}")
    launches += 1
    return y
