"""Selective recompute of a checkpointed function's products.

A :class:`Tape` holds the set of product kinds (names its callers agree
on; the models' are :data:`repro_torch.models.remat.KINDS`) whose outputs
one checkpointed call keeps.  Its pair of contexts is the ``context_fn``
of ``torch.utils.checkpoint.checkpoint`` (non-reentrant): in the first
forward each product of a kept kind records its output; in the recompute
it returns that output, in order, and computes nothing.  A kernel's
autograd Function takes the kept output through :func:`kernel`; a plain
PyTorch product goes through :func:`product`.  A product still runs its
autograd node in the recompute (the kernel's Function, the ``aten`` node
of a plain product), so the tensors its backward saves are unpacked as
when nothing is kept, and every gradient comes out bit-equal to it.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

#: products computed in a recompute, by site name (``"ina"``, ``"flash"``,
#: ``"wkv6"``, ``"router"``, ``"lora"``, ``"experts"``, ``"combine"``,
#: ``"mla_attn"``, ``"ssd"``); a replayed product is not counted
RECOMPUTED: collections.Counter = collections.Counter()
#: the ``aten`` ops that carry a plain product's arithmetic (the rest of
#: an einsum is views and copies of its operands, recomputed as they are)
_PRODUCT_OPS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
#: the sum that carries a weighted reduction's arithmetic (``reduction``)
_SUM_OPS = {_aten.sum.dim_IntList}


class Tape:
    """The outputs one checkpointed call keeps of the kinds in ``policy``:
    recorded in its first forward (:meth:`recording`), returned in order
    in its recompute (:meth:`replaying`), then dropped."""

    def __init__(self, policy: frozenset):
        self.policy = policy
        self.outs: list = []
        self.replay = False
        self.at = 0

    @contextlib.contextmanager
    def _active(self, replay: bool):
        self.replay, self.at = replay, 0
        _STACK.append(self)
        try:
            yield
        finally:
            _STACK.pop()
            if replay:
                self.outs = []      # the backward has what it needs

    def recording(self):
        return self._active(False)

    def replaying(self):
        return self._active(True)

    def contexts(self):
        """``context_fn`` of ``torch.utils.checkpoint.checkpoint``."""
        return self.recording(), self.replaying()

    def put(self, out):
        self.outs.append(out)

    def take(self):
        out = self.outs[self.at]
        self.at += 1
        return out


_STACK: list = []


def _tape(kind: str) -> Optional[Tape]:
    """The running layer's tape where it keeps ``kind``; ``None`` outside
    a checkpointed layer or for a kind its policy recomputes."""
    if not _STACK:
        return None
    tape = _STACK[-1]
    return tape if kind in tape.policy else None


def _count(site: str) -> None:
    if _STACK and _STACK[-1].replay:
        RECOMPUTED[site] += 1


def kernel(site: str, kind: str, apply: Callable):
    """``apply(kept)`` for a kernel's autograd Function: ``kept`` is the
    1-tuple of the output the first forward recorded (the Function returns
    it and launches nothing) in the recompute of a layer that keeps
    ``kind``, else ``None`` (the Function launches its kernel)."""
    tape = _tape(kind)
    if tape is not None and tape.replay:
        return apply((tape.take(),))
    _count(site)
    out = apply(None)
    if tape is not None:
        tape.put(out.detach())
    return out


class _Products(TorchDispatchMode):
    """Below autograd, so every node of the product is still built: records
    the outputs of ``ops`` (or, replaying, returns them in order)."""

    def __init__(self, tape: Tape, ops: set):
        super().__init__()
        self.tape, self.ops = tape, ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if self.tape.replay:
            return self.tape.take().detach()
        out = func(*args, **(kwargs or {}))
        self.tape.put(out.detach())
        return out


def product(site: str, kind: str, fn: Callable, *args, reduction=False):
    """``fn(*args)``: a plain PyTorch product of ``kind`` (an einsum, a
    ``bmm``, a ``matmul``; with ``reduction`` the MoE combine's weighted
    sum), its output kept or recomputed as the running layer's policy
    says."""
    tape = _tape(kind)
    if tape is None:
        _count(site)
        return fn(*args)
    with _Products(tape, _SUM_OPS if reduction else _PRODUCT_OPS):
        return fn(*args)
