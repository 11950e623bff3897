"""NoC-costed iteration latencies for the cluster simulator (a copy of
``repro.serve.costs``).

:class:`PlanCostModel` turns per-phase :class:`~repro_torch.plan.ExecutionPlan`s
into wall-clock step latencies: one serving iteration's cycles are the
per-decoder-block GEMM cycles of the phase plan's mapper verdicts (scaled
by how many M-tile passes the in-flight token count needs and by the
model's depth) plus the plan's psum collective cycles.  Because the plans
record the cost of **every** auto candidate per psum site
(``PsumDecision.costs``) and both the INA-searched and eject/inject
baseline mapper verdicts per GEMM, a single plan prices both semantics —
``semantics="ina"`` vs ``"eject_inject"`` needs no replanning, which is
what lets ``experiments --section serve`` sweep the INA advantage into a
fleet-size delta.

Cycles → seconds via ``clock_ghz`` plus a ``calibration`` scale, the hook
for anchoring against a measured engine (fit one scalar from a real
iteration time; the default 1.0 keeps results in model-relative units).

A port plan's psum decision counts the call sites of every layer (the
port's layer loop runs each one, where the reference's ``lax.scan`` traces a
stacked body once), so :func:`_psum_cycles` prices the whole model's
collectives: the reference's count times the depth.  The reference's fault-slowed model
(``DegradedCostModel``, ``fault_slowdown``) waits for the port's fault
layer (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig, depth_units

SEMANTICS = ("ina", "eject_inject")


def _gemm_cycles(plan, semantics: str) -> float:
    """One decoder block's GEMM cycles at the plan's M tile."""
    if semantics == "ina":
        return sum(g.latency_cycles for g in plan.gemms)
    return sum(g.baseline_latency_cycles for g in plan.gemms)


def _psum_cycles(plan, semantics: str) -> float:
    """All psum sites' cycles under one collective semantics."""
    total = 0.0
    for d in plan.psum:
        costs = d.cost_of
        lat = costs.get(semantics)
        if lat is None:                     # plan predates per-mode costs
            lat = costs.get(d.mode, (0.0, 0.0))
        total += lat[0] * d.count
    return total


@dataclasses.dataclass(frozen=True)
class PlanCostModel:
    """Step latencies derived from (prefill plan, decode plan).

    ``chips`` is read off the plans (DESIGN.md S14): a ``chips``-chip
    replica shards the token tile across its chips (the mapper's output-row
    split), so one pass covers ``tokens * chips`` tokens — the psum cycles
    already carry the plans' hierarchical collective pricing.
    """

    arch: str
    semantics: str
    clock_ghz: float
    calibration: float
    depth: int
    prefill_chunk: int
    pf_gemm_cycles: float          # per block, at pf_tokens M tile
    pf_tokens: int
    pf_psum_cycles: float
    dec_gemm_cycles: float
    dec_tokens: int
    dec_psum_cycles: float
    chips: int = 1                 # chips per replica (from the plans)

    @classmethod
    def from_plans(cls, cfg: ModelConfig, prefill_plan, decode_plan,
                   prefill_chunk: int, semantics: str = "ina",
                   clock_ghz: float = 1.0, calibration: float = 1.0,
                   ) -> "PlanCostModel":
        if semantics not in SEMANTICS:
            raise ValueError(f"semantics {semantics!r} not in {SEMANTICS}")
        if not prefill_plan.gemms or not decode_plan.gemms:
            raise ValueError("cost model needs plans built with gemm_search")
        if prefill_plan.chips != decode_plan.chips:
            raise ValueError(
                f"phase plans disagree on chip count "
                f"({prefill_plan.chips} vs {decode_plan.chips})")
        return cls(
            arch=cfg.name, semantics=semantics, clock_ghz=clock_ghz,
            calibration=calibration, depth=depth_units(cfg),
            prefill_chunk=prefill_chunk,
            pf_gemm_cycles=_gemm_cycles(prefill_plan, semantics),
            pf_tokens=prefill_plan.tokens,
            pf_psum_cycles=_psum_cycles(prefill_plan, semantics),
            dec_gemm_cycles=_gemm_cycles(decode_plan, semantics),
            dec_tokens=decode_plan.tokens,
            dec_psum_cycles=_psum_cycles(decode_plan, semantics),
            chips=prefill_plan.chips)

    def _seconds(self, cycles: float) -> float:
        return cycles / (self.clock_ghz * 1e9) * self.calibration

    def prefill_chunk_seconds(self) -> float:
        """One B=1 chunk of chunked prefill."""
        tiles = max(1, math.ceil(self.prefill_chunk
                                 / (self.pf_tokens * self.chips)))
        return self._seconds(
            self.depth * self.pf_gemm_cycles * tiles + self.pf_psum_cycles)

    def decode_iter_seconds(self, n_active: int) -> float:
        """One continuous-batching decode step over ``n_active`` slots."""
        tiles = max(1, math.ceil(max(1, n_active)
                                 / (self.dec_tokens * self.chips)))
        return self._seconds(
            self.depth * self.dec_gemm_cycles * tiles + self.dec_psum_cycles)


@dataclasses.dataclass(frozen=True)
class SyntheticCostModel:
    """Fixed latencies for unit tests (no plans, no NoC)."""

    prefill_chunk_s: float = 0.002
    decode_base_s: float = 0.004
    decode_per_slot_s: float = 0.0005

    def prefill_chunk_seconds(self) -> float:
        return self.prefill_chunk_s

    def decode_iter_seconds(self, n_active: int) -> float:
        return self.decode_base_s + self.decode_per_slot_s * n_active


def serve_plans(cfg: ModelConfig, mesh_shape, plan_dir=None,
                verbose: bool = True, chips: int = 1,
                package: str = "mesh") -> dict:
    """Per-phase plans for serving: ``{"prefill": (plan, info), "decode":
    (plan, info)}`` through :func:`~repro_torch.plan.plan_for_launch` on the
    canonical phase shapes — a store warmed by ``experiments --section
    plan`` (or a previous serve run) answers with **zero collective
    simulations**, the acceptance evidence ``repro_torch.serve`` reports.
    ``chips`` > 1 plans a multi-chip replica (hierarchical psum pricing,
    stored under the plan's ``__cN`` key)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.plan import plan_for_launch

    out = {}
    for phase, shape_name in (("prefill", "prefill_32k"),
                              ("decode", "decode_32k")):
        plan, info = plan_for_launch(cfg, mesh_shape, SHAPES[shape_name],
                                     "auto", plan_dir=plan_dir,
                                     verbose=verbose, chips=chips,
                                     package=package)
        out[phase] = (plan, info)
    return out
