"""Analytical model of In-Network Accumulation (INA) — Eqs. (1)-(4) of the paper
(a copy of ``repro.core.ina_model``).

The paper models a Weight-Stationary (WS) dataflow on an N x N mesh NoC with
1 PE per router and M bits of scratch memory per PE.  For a CONV layer with
R x R kernels, C input channels, F filters, O x O output feature map and q-bit
precision:

  Eq. (1)  INA is needed   iff  C*R*R*q > M
  Eq. (2)  P#   = ceil(C*R*R*q / M)            PEs sharing one filter
  Eq. (3)  INA# = ceil( (F/N) * (O*O / floor(N/P#)) )   accumulation rounds
  Eq. (4)  INA#E = ceil( (F/(N*E)) * (O*O / floor(N/P#)) )  for E PEs/router

Note (paper anomaly, see DESIGN.md S7): Tables I/II say "M = 32KB" but only
reproduce with M = 32 Kbit = 32768 bits; we default to 32768.

The Eq. (1)-(4) helpers only touch a layer's R/C/F and output count, so they
accept any shape exposing that interface — :class:`ConvLayer` here, and the
GEMM shapes of :mod:`repro_torch.core.ops` (R=1, C=K, F=N, outputs=M), which is
what lets the mapper search FC and transformer layers with the same model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

#: Paper default parameters (Tables I & II footnotes).
DEFAULT_M_BITS = 32 * 1024   # 32 Kbit scratch memory per PE (see DESIGN.md S7)
DEFAULT_Q_BITS = 32          # psum / weight precision


@dataclass(frozen=True)
class ConvLayer:
    """One CONV layer as parameterised by the paper: R, C, F, O (+stride for traces)."""

    name: str
    R: int          # kernel spatial size (R x R)
    C: int          # input channels
    F: int          # number of filters (output channels)
    O: int          # output feature map spatial size (O x O)
    stride: int = 1

    @property
    def outputs(self) -> int:
        """Output activations per filter (the O x O pixels)."""
        return self.O * self.O

    @property
    def macs(self) -> int:
        """MAC count for the layer (one input image)."""
        return self.R * self.R * self.C * self.F * self.outputs

    @property
    def weight_bits(self) -> int:
        return self.C * self.R * self.R * DEFAULT_Q_BITS


def needs_ina(layer: ConvLayer, m_bits: int = DEFAULT_M_BITS,
              q_bits: int = DEFAULT_Q_BITS) -> bool:
    """Eq. (1): INA is required iff one filter's weights exceed PE memory."""
    return layer.C * layer.R * layer.R * q_bits > m_bits


def p_num(layer: ConvLayer, m_bits: int = DEFAULT_M_BITS,
          q_bits: int = DEFAULT_Q_BITS) -> int:
    """Eq. (2): number of PEs a single filter's weights are split across."""
    return math.ceil(layer.C * layer.R * layer.R * q_bits / m_bits)


def ina_rounds(layer: ConvLayer, n: int, e_pes_per_router: int = 1,
               m_bits: int = DEFAULT_M_BITS, q_bits: int = DEFAULT_Q_BITS,
               force: bool = False) -> Optional[int]:
    """Eqs. (3)/(4): rounds of INA to complete one CONV layer on an N x N mesh.

    Returns ``None`` ("NA" in the paper's tables) when the layer does not need
    INA per Eq. (1) — unless ``force`` is set (used to reproduce the VGG-16
    CONV3 row, which the paper lists despite P#=1; DESIGN.md S7).
    """
    if not force and not needs_ina(layer, m_bits, q_bits):
        return None
    p = p_num(layer, m_bits, q_bits)
    groups = n // p                      # floor(N / P#): filter groups per mesh row
    if groups == 0:
        # A filter's chain is taller than the mesh (P# > N): the paper's
        # tables never hit this case, but the mapper's search space (GEMM
        # reductions, small mesh columns) does.  The column accumulates the
        # filter in ceil(P#/N) sequential passes of N chained PEs each
        # (partial results parked at the port PE between passes), so every
        # output costs that many gather rounds — clamping to one group, as
        # the old fallback did, undercounts rounds by the pass factor.
        passes = math.ceil(p / n)
        return passes * math.ceil((layer.F / (n * e_pes_per_router))
                                  * layer.outputs)
    return math.ceil((layer.F / (n * e_pes_per_router))
                     * (layer.outputs / groups))


def ina_table(layers: list[ConvLayer], n: int, e_pes_per_router: int = 1,
              m_bits: int = DEFAULT_M_BITS, q_bits: int = DEFAULT_Q_BITS,
              ) -> list[dict]:
    """Reproduce a Table-I/II-style table: one row per layer."""
    rows = []
    for layer in layers:
        rows.append({
            "layer": layer.name,
            "R": layer.R, "C": layer.C, "F": layer.F, "O": layer.O,
            "P#": p_num(layer, m_bits, q_bits),
            "INA#": ina_rounds(layer, n, e_pes_per_router, m_bits, q_bits),
        })
    return rows


def total_ina_rounds(layers: list[ConvLayer], n: int, e: int = 1,
                     m_bits: int = DEFAULT_M_BITS,
                     q_bits: int = DEFAULT_Q_BITS) -> int:
    """Total accumulation rounds for a whole network (NA layers contribute 0).

    ``q_bits`` is forwarded to :func:`ina_rounds` like every other Eq. (1)-(4)
    helper, so mixed-precision sweeps (q=8/16) flip Eq. (1) consistently.
    """
    return sum(ina_rounds(l, n, e, m_bits, q_bits) or 0 for l in layers)
