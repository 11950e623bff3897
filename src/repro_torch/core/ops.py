"""GEMM layer shapes and lowerings — the non-CNN front-end of the mapper (a
copy of ``repro.core.ops``).

The paper only maps CONV layers (Eqs. 1-4), but its WS placement is really a
statement about *reductions*: split a filter's C*R*R-long dot product across
P# chained PEs and accumulate over the NoC.  A GEMM ``C[M,N] = A[M,K] @
B[K,N]`` is the same computation with R=1 — the reduction dim K plays the
input channels C, the N output columns play the filters F, and the M rows
play the O*O output pixels.  :class:`GemmLayer` exposes exactly the shape
interface the analytical model (:mod:`repro_torch.core.ina_model`) and the traffic
planner (:mod:`repro_torch.core.noc.traffic`) consume, so FC layers, im2col-lowered
CONVs and transformer projections flow through the simulator unchanged.

Two lowerings are provided:

* :func:`im2col` — a CONV layer as the equivalent GEMM (M=O*O, K=C*R*R,
  N=F); preserves MACs, P# and INA round counts exactly.
* :func:`transformer_gemms` — one decoder block's projection/MLP GEMMs
  derived from a :class:`repro_torch.configs.base.ModelConfig` (attention q/k/v/o
  plus gate/up/down).  Whole-model totals scale linearly in depth, so
  mapper ratios over one block are depth-invariant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Union

from .ina_model import DEFAULT_Q_BITS, ConvLayer

if TYPE_CHECKING:                       # pure typing; configs import no jax
    from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class GemmLayer:
    """One GEMM ``C[M,N] = A[M,K] @ B[K,N]`` under the paper's WS mapping."""

    name: str
    M: int          # output rows (tokens / batch pixels)
    K: int          # reduction (contraction) dimension
    N: int          # output columns (weight matrix width)

    # ---- Eq. (1)-(4) shape interface (shared with ConvLayer) -------------
    @property
    def R(self) -> int:
        return 1

    @property
    def C(self) -> int:
        return self.K

    @property
    def F(self) -> int:
        return self.N

    @property
    def outputs(self) -> int:
        """Output activations per filter (the M rows)."""
        return self.M

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def weight_bits(self) -> int:
        return self.K * DEFAULT_Q_BITS


#: Any layer shape the analytical model / traffic planner accepts.
LayerShape = Union[ConvLayer, GemmLayer]


def im2col(conv: ConvLayer) -> GemmLayer:
    """Lower a CONV layer to its im2col GEMM (exact WS-mapping equivalent)."""
    return GemmLayer(f"{conv.name}.im2col", M=conv.O * conv.O,
                     K=conv.C * conv.R * conv.R, N=conv.F)


def transformer_gemms(cfg: "ModelConfig", tokens: int = 256) -> list[GemmLayer]:
    """One decoder block's GEMMs for a ``configs/`` model shape.

    ``tokens`` is the token tile mapped per pass (the M dimension).  GQA
    models get narrower K/V projections (n_kv_heads); the MLP emits the
    gate/up/down trio used by every SwiGLU config in the registry.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    name = cfg.name
    return [
        GemmLayer(f"{name}.wq", M=tokens, K=d, N=cfg.n_heads * hd),
        GemmLayer(f"{name}.wk", M=tokens, K=d, N=cfg.n_kv_heads * hd),
        GemmLayer(f"{name}.wv", M=tokens, K=d, N=cfg.n_kv_heads * hd),
        GemmLayer(f"{name}.wo", M=tokens, K=cfg.n_heads * hd, N=d),
        GemmLayer(f"{name}.w_gate", M=tokens, K=d, N=cfg.d_ff),
        GemmLayer(f"{name}.w_up", M=tokens, K=d, N=cfg.d_ff),
        GemmLayer(f"{name}.w_down", M=tokens, K=cfg.d_ff, N=d),
    ]
