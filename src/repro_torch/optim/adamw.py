"""AdamW with global-norm clipping and a cosine schedule (counterpart of
``repro.optim.adamw``).

Plain functions on nested dicts of tensors.  The optimizer state mirrors
the parameter tree (m, v per leaf, float32) beside a step count.  The
reference is pure and returns new trees; :func:`adamw_update` updates the
parameters and the moments in place, which saves a copy of the whole
state (1.5 B parameters take 18.5 GB of f32 params, m and v), and returns
them.  The arithmetic is the reference's, in float32, and so is its
decay rule (``weight_decay * p * (p.ndim >= 2)`` on the stored leaf: a
stacked ``[L, D]`` norm weight or bias decays, the final norm's ``[D]``
does not).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core.collectives import all_reduce_, axis_size


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: dict
    v: dict


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, their leaves passed beside ``tree``'s)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def adamw_init(params: dict) -> AdamWState:
    """Zero moments in float32 on each parameter's device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``step`` (an integer tensor) -> the learning rate, a float32 scalar:
    a linear warmup, then a cosine from ``base_lr`` down to a tenth."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * (0.1 + 0.9 * cos))
    return lr


def _clip_scale(grads: dict, max_norm: float, group=None,
                holding: Optional[dict] = None):
    """(the factor that brings the global norm to at most ``max_norm``, the
    norm): the norm is float32, over every leaf.

    At more than one rank ``grads`` are this rank's shards and ``holding``
    (:func:`repro_torch.parallel.sharding.leaf_holding`) says how each is
    held: the sums of squares of the ``"cut"`` leaves are all-reduced over
    ``group`` (a group, or a tuple of groups whose product is the ranks
    that hold distinct pieces: the rank mesh's data and model lines), a
    ``"whole"`` leaf (the same on every rank) is counted once and a
    ``"copy"`` (a piece that another rank counts) not at all, so the norm
    is the one over the logical arrays, and the same on every rank.  A
    leaf held in runs along its last dim (Mamba2's packed ``w_in``: its
    heads' segments cut, B and C whole) has a kind a run."""
    leaves = tree_leaves(grads)
    groups = [g for g in (group if isinstance(group, tuple) else (group,))
              if axis_size(g) > 1]
    if holding is None or not groups:
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    else:
        squares = {"cut": [], "whole": [], "copy": []}
        for g, kind in zip(leaves, tree_leaves(holding)):
            if isinstance(kind, str):
                squares[kind].append(g.float().square().sum())
                continue
            for k, start, size in kind:
                squares[k].append(g.narrow(-1, start, size).float().square()
                                  .sum())
        cut = torch.stack(squares["cut"]).sum()
        for g in groups:
            all_reduce_(cut, g)
        gnorm = torch.sqrt(cut + sum(squares["whole"]))
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0), \
        gnorm


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling); the scale is cast to each leaf's dtype."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState,
                 lr: Union[Callable, float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_norm: float = 1.0,
                 group=None, holding: Optional[dict] = None):
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    updated and returned, with ``{"grad_norm", "lr"}`` (float32 scalars).
    ``lr`` is a schedule (step -> lr) or a float.  ``grads`` are clipped
    to ``max_norm`` first, as the reference does (each leaf scaled as it
    is used, not copied whole); they are not changed.  A rank's shards
    are clipped by the norm over the logical arrays (``group`` and
    ``holding``: :func:`_clip_scale`)."""
    scale, gnorm = _clip_scale(grads, max_norm, group, holding)
    step = state.step + 1
    stepf = step.float()
    lr_t = lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)
    b1c = 1.0 - torch.pow(b1, stepf)
    b2c = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        g32 = (g * scale.to(g.dtype)).float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
        p32 = p.float()
        if p.dim() >= 2:
            delta.add_(weight_decay * p32)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr_t))
        else:
            p.copy_(p32 - lr_t * delta)

    tree_map(upd, params, grads, state.m, state.v)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr_t}
