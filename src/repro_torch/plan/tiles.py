"""The Hopper tile policy for the INA matmul kernel (counterpart of
``repro.plan.tiles``).

The reference plans Pallas blocks against a TPU's VMEM budget and sublane
granularity.  On an H100 the launch is what
:func:`~repro_torch.kernels.ina_matmul.plan_matmul` picks: the regime
(``wide`` TMA + wgmma tiles for M > 16, ``narrow`` with A and B swapped
for M <= 16, ``generic`` where TMA cannot describe the operands), the
output tile, and the thread block cluster that splits K when the tiles are
fewer than the SMs.  This module does not duplicate that policy, it calls
it: a planned launch is the launch the planless call makes, so a planned
serve gives the same tokens to the bit.

What bounds a choice on sm_90, and what the plan verifier
(:func:`repro_torch.analysis.verify_plan`) checks:

* the kernel instantiates only some tiles
  (:data:`~repro_torch.kernels.ina_matmul.TMA_TILES`, ``generic`` and
  ``f32`` 64 x 64);
* a cluster is a power of two of at most ``MAX_CLUSTER`` CTAs, one CTA an
  SM (``tiles x cluster <= SMS``), each with two or more K tiles;
* a CTA's shared memory is at most 227 KB (:data:`SMEM_LIMIT`), reckoned
  as the kernel reckons its ring (:func:`tile_working_set`).

A plan's tiles assume TMA-aligned operands (16-byte bases, row strides of
a multiple of 8 elements); ``kernels.ops.matmul`` uses them only where the
operands are so.  Pure arithmetic: no simulation, no device.
"""
from __future__ import annotations

from repro_torch.kernels.ina_matmul import (BK, F32_PLAN, GENERIC_BK,
                                            MAX_CLUSTER, SMS, TMA_TILES,
                                            MatmulPlan, plan_matmul)

#: Dynamic shared memory one CTA may opt into on an H100 (sm_90).
SMEM_LIMIT = 227 * 1024

#: bytes of one [64][64] bf16 sub-tile of A (``SUB`` in the kernel)
_SUB = 64 * 64 * 2

#: The static shared memory of the two kernels without a TMA ring: generic
#: (``As[64][136]`` and ``Bs[128][72]`` bf16, the larger of its two w
#: layouts) and f32 (``As``, ``Bs`` ``[16][68]`` float).
_STATIC_SMEM = {"generic": (64 * 136 + 128 * 72) * 2,
                "f32": 2 * 16 * 68 * 4}


def tile_policy_signature() -> tuple:
    """Everything a planned tile depends on besides the GEMM shape: part of
    ``plan_schema_hash()``, so a change to any of these makes every stored
    plan cold."""
    return (BK, GENERIC_BK, SMS, MAX_CLUSTER, SMEM_LIMIT,
            tuple(sorted(TMA_TILES.items())),
            tuple(sorted(_STATIC_SMEM.items())), tuple(F32_PLAN))


def tile_working_set(plan: MatmulPlan) -> int:
    """Shared-memory bytes one CTA of ``plan``'s launch holds: for a TMA
    regime ``Ring<NWG, WN, STAGES>::SMEM`` (1 KB of alignment slack, the
    stages of A and B tiles, a full and an empty mbarrier a stage), else
    the kernel's static arrays.  Shared by :func:`choose_tiles`'s callers
    and the plan verifier."""
    if plan.regime in _STATIC_SMEM:
        return _STATIC_SMEM[plan.regime]
    nwg, wn, stages = TMA_TILES[(plan.regime, plan.tile_m, plan.tile_n)]
    return 1024 + stages * (nwg * _SUB + wn * BK * 2) + 2 * stages * 8


def choose_tiles(m: int, k: int, n: int,
                 dtype: str = "bfloat16") -> MatmulPlan:
    """The launch for ``[m, k] @ [k, n]`` on TMA-aligned operands of
    ``dtype`` (``"bfloat16"`` or ``"float32"``)."""
    if dtype == "bfloat16":
        return plan_matmul(m, n, k, True)
    if dtype == "float32":
        return F32_PLAN
    raise ValueError(f"ina_matmul takes bfloat16 or float32, not {dtype!r}")
