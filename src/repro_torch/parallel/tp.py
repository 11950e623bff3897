"""Tensor-parallel linears (counterpart of ``repro.parallel.tp``).

This slice runs on one chip, so :class:`ParallelCtx` carries no process
group and the row-parallel partial sum needs no reduction.  It takes only
the ``ina`` psum mode; the other strategies of ``repro.core.collectives``
(``xla_spmd``, ``ina_ring``, ``eject_inject``, ``auto``) come with the
multi-rank slice (ROADMAP Queue 1, item 3) and raise until then.  Every
projection goes through :func:`repro_torch.kernels.ops.matmul`, the INA
matmul; the bias is added after it, as ``repro.parallel.tp`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import ops

PSUM_MODES = ("ina",)


@dataclass(frozen=True)
class ParallelCtx:
    """How model-axis parallelism runs inside the forward pass (one rank)."""
    psum_mode: str = "ina"

    def __post_init__(self):
        if self.psum_mode not in PSUM_MODES:
            raise ValueError(
                f"psum_mode {self.psum_mode!r}: this port runs on one rank "
                f"and takes only {PSUM_MODES}; the multi-rank strategies "
                f"are ROADMAP Queue 1, item 3")


def col_linear(x: torch.Tensor, w: torch.Tensor,
               pctx: Optional[ParallelCtx] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column-parallel matmul: w sharded on its last dim; no communication."""
    out = ops.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def row_linear(x: torch.Tensor, w: torch.Tensor,
               pctx: Optional[ParallelCtx] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-parallel matmul, the paper's INA site.  On one rank the partial
    sum is already the whole sum."""
    out = ops.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out
