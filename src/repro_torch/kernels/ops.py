"""Kernel dispatch (counterpart of ``repro.kernels.ops``).

The device of the tensor decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version.  There is no switch and
no fallback from one to the other.  Where autograd needs a gradient, the
call goes through the kernel's ``autograd.Function`` (the same forward
launch, or, in the recompute of a checkpointed layer whose remat policy
keeps it, the recorded output: :func:`repro_torch.core.remat.kernel`);
elsewhere, as in serving, straight to the wrapper.

A ``meta`` tensor takes the path a CUDA tensor takes, through
:func:`repro_torch.core.remat.kernel` and the kernel's ``autograd.Function``
where autograd records; only the launch is replaced, by a shape-only output
and the kernel's work recorded (:func:`repro_torch.core.cost.record_kernel`),
so a backward on ``meta`` runs the code the card runs.  The plan builder
and the dry-run trace the models there (:mod:`repro_torch.plan.builder`,
:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, FlashAttention,
                                                 flash_attention_heads)
from repro_torch.kernels.ina_matmul import InaMatmul, ina_matmul
from repro_torch.kernels.wkv6 import Wkv6, wkv6_heads
from repro_torch.core import remat


def matmul(x: torch.Tensor, w: torch.Tensor, plan=None) -> torch.Tensor:
    """``x``: [..., K] @ ``w``: [K, N] -> [..., N] through the INA matmul.

    ``plan`` (an :class:`~repro_torch.plan.ExecutionPlan`) is asked for
    the launch of this problem shape and counted in
    :data:`~repro_torch.kernels.ina_matmul.plan_tiles`; the Hopper tile
    policy is :func:`~repro_torch.kernels.ina_matmul.plan_matmul` itself,
    so a planned launch is the one the planless call makes, and the output
    the same bits (:func:`~repro_torch.kernels.ina_matmul.ina_matmul`)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if needs_grad(x2, w):
        y = remat.kernel("ina", "nb", lambda kept: InaMatmul.apply(
            x2, w, None, plan, kept))
    else:
        y = ina_matmul(x2, w) if plan is None \
            else ina_matmul(x2, w, tiles=plan)
    return y.reshape(*lead, w.shape[1])


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them requires a gradient (serving passes none that does)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """The model's layout through the flash kernel: q [B, Sq, H, D], k/v
    [B, Sk, KVH, D] with GQA unexpanded, each read in place (a KV cache
    slice included); returns a contiguous [B, Sq, H, D].  A shape the
    kernel cannot take (v's head dim not q's, as in MLA, or D > 160)
    raises: it is never rerouted."""
    if v.shape[-1] != q.shape[-1] or q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention takes one head dim <= {MAX_HEAD_DIM} for q, k "
            f"and v, got q {q.shape[-1]}, k {k.shape[-1]}, v {v.shape[-1]} "
            f"(MLA runs models.layers.attention_by_chunk)")
    if needs_grad(q, k, v):
        return remat.kernel("flash", "fused", lambda kept: FlashAttention
                            .apply(q, k, v, causal, q_offset, kept))
    return flash_attention_heads(q, k, v, causal=causal, q_offset=q_offset)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """RWKV6 WKV through the wkv6 kernel: r/k/v/logw [B, S, H, hd] (the
    model's layout, read in place), u [H, hd]; returns [B, S, H, hd].

    The reference's ``wkv`` also takes the TPU kernel's chunk, which only
    sets where its factorised decay is clamped; the port's chunk is fixed by
    the kernel and anchors every decay at or below zero, exact at any
    decay, so there is no chunk to pass."""
    if needs_grad(r, k, v, logw, u):
        return remat.kernel("wkv6", "fused",
                            lambda kept: Wkv6.apply(r, k, v, logw, u, kept))
    return wkv6_heads(r, k, v, logw, u)
