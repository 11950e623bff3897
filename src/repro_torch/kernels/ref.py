"""Plain PyTorch oracles (counterpart of ``repro.kernels.ref``).

``attention_ref`` adds ``q_offset``: query row ``i`` sits at absolute
position ``q_offset + i``, so a chunk of a prefill can be checked against
the cache it attends to.
"""
from __future__ import annotations

import math

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def matmul_eject_inject(x: torch.Tensor, w: torch.Tensor,
                        bk: int = 512) -> torch.Tensor:
    """The paper's Fig. 4(a) baseline at chip level: every K-block partial
    product is materialized and re-read to accumulate (the eject/inject
    contrast to the INA matmul, which keeps the partial sum on chip)."""
    k = x.shape[1]
    partials = torch.stack([
        x[:, i:i + bk].float() @ w[i:i + bk].float()
        for i in range(0, k, bk)])
    return partials.sum(0).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D], k/v: [BH, Sk, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Step-by-step WKV6 recurrence (the ground-truth semantics).

    r/k/v/logw: [BH, S, hd]; u: [BH, hd].
    """
    rf, kf, vf = (t.float() for t in (r, k, v))
    wf = torch.exp(logw.float())
    uf = u.float()
    bh, s, hd = r.shape
    state = torch.zeros(bh, hd, hd, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        ys.append(torch.einsum("bc,bcd->bd", rt, state)
                  + torch.einsum("bc,bc,bc,bd->bd", rt, uf, kt, vt))
        state = state * wt[:, :, None] + kt[:, :, None] * vt[:, None, :]
    return torch.stack(ys, dim=1).to(r.dtype)
