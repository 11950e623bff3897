"""Whole-network schedules: the mapper's output artifact (a copy of
``repro.mapper.schedule``).

A :class:`NetworkSchedule` fixes one hardware point and one per-layer
:class:`~.space.Mapping` each, with the exact simulated cost attached.  It
round-trips through JSON (:meth:`~NetworkSchedule.to_dict` /
:meth:`~NetworkSchedule.from_dict`, the reference's layout) and re-emits,
on demand, the per-layer packet programs
(:func:`~repro_torch.core.noc.collective.schedule.ws_round_program`) that
the static schedule verifier checks and the collective engine replays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

from repro_torch.core.noc import NocConfig
from repro_torch.core.noc.collective.schedule import (PacketOp,
                                                      ws_round_program)
from repro_torch.core.noc.traffic import LayerResult, layer_plan
from repro_torch.core.ops import LayerShape

from .space import Mapping, shard_layer


def mapping_utilization(layer: LayerShape, mapping: Mapping,
                        base_cfg: NocConfig = NocConfig()) -> float:
    """Placement efficiency: live PE round-slots / provided PE round-slots.

    Each accumulation round offers ``W*H*E`` PE-slots; the mapping keeps
    ``W*G*P#*E`` of them on live work (idle column tails when ``H % P# !=
    0``) and rounds it runs beyond ``F * outputs * passes / (chains * E)``
    are pure ceil waste.  MAC issue time is not simulated (compute overlaps
    the NoC, paper [12]), so this measures how much of the mesh the mapping
    *can* keep busy, not a cycle-level activity factor.  Multi-chip
    mappings measure their per-chip shard (every chip runs the same
    placement on its own output rows, so the ratio is chip-invariant).
    """
    m = mapping
    cfg = m.cfg(base_cfg)
    layer = shard_layer(layer, m.chips)
    plan = layer_plan(layer, cfg, m.e_pes, m.mode, m.q_bits, m.groups)
    provided = plan.rounds * cfg.width * cfg.height * m.e_pes
    live = layer.F * layer.outputs * plan.p * plan.passes
    return min(1.0, live / max(provided, 1))


@dataclass(frozen=True)
class LayerAssignment:
    """One layer's chosen mapping plus its simulated cost."""

    layer: str
    mapping: Mapping
    rounds: int
    fills: int
    latency_cycles: float
    noc_energy_pj: float
    stream_energy_pj: float
    macs: int
    utilization: float

    @property
    def total_energy_pj(self) -> float:
        return self.noc_energy_pj + self.stream_energy_pj

    @classmethod
    def from_result(cls, layer: LayerShape, mapping: Mapping,
                    result: LayerResult,
                    base_cfg: NocConfig = NocConfig()) -> "LayerAssignment":
        return cls(layer=layer.name, mapping=mapping, rounds=result.rounds,
                   fills=result.fills, latency_cycles=result.latency_cycles,
                   noc_energy_pj=result.noc_energy_pj,
                   stream_energy_pj=result.stream_energy_pj,
                   macs=layer.macs,
                   utilization=mapping_utilization(layer, mapping, base_cfg))


@dataclass(frozen=True)
class NetworkSchedule:
    """Per-layer mappings for a whole network on one hardware point."""

    workload: str
    hardware: tuple[int, ...]      # (width, height, e_pes[, chips])
    assignments: tuple[LayerAssignment, ...]

    @property
    def latency_cycles(self) -> float:
        """Layers execute back-to-back (as in the paper's evaluation)."""
        return sum(a.latency_cycles for a in self.assignments)

    @property
    def total_energy_pj(self) -> float:
        return sum(a.total_energy_pj for a in self.assignments)

    @property
    def noc_energy_pj(self) -> float:
        return sum(a.noc_energy_pj for a in self.assignments)

    @property
    def num_pes(self) -> int:
        w, h, e = self.hardware[:3]
        chips = self.hardware[3] if len(self.hardware) > 3 else 1
        return w * h * e * chips

    @property
    def pe_utilization(self) -> float:
        """Time-weighted placement efficiency (see mapping_utilization)."""
        total = self.latency_cycles
        if total <= 0:
            return 0.0
        return sum(a.utilization * a.latency_cycles
                   for a in self.assignments) / total

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "workload": self.workload,
            "hardware": list(self.hardware),
            "latency_cycles": self.latency_cycles,
            "total_energy_pj": self.total_energy_pj,
            "noc_energy_pj": self.noc_energy_pj,
            "pe_utilization": self.pe_utilization,
            "layers": [{
                "layer": a.layer,
                "mapping": dataclasses.asdict(a.mapping),
                "rounds": a.rounds,
                "fills": a.fills,
                "latency_cycles": a.latency_cycles,
                "noc_energy_pj": a.noc_energy_pj,
                "stream_energy_pj": a.stream_energy_pj,
                "macs": a.macs,
                "utilization": a.utilization,
            } for a in self.assignments],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkSchedule":
        return cls(
            workload=d["workload"], hardware=tuple(d["hardware"]),
            assignments=tuple(
                LayerAssignment(
                    layer=row["layer"], mapping=Mapping(**row["mapping"]),
                    rounds=row["rounds"], fills=row["fills"],
                    latency_cycles=row["latency_cycles"],
                    noc_energy_pj=row["noc_energy_pj"],
                    stream_energy_pj=row["stream_energy_pj"],
                    macs=row["macs"], utilization=row["utilization"])
                for row in d["layers"]))

    # ------------------------------------------------------------------ #
    def programs(self, layers: Sequence[LayerShape],
                 base_cfg: NocConfig = NocConfig(),
                 window: Optional[int] = None,
                 ) -> Iterator[tuple[str, NocConfig, list[PacketOp]]]:
        """Re-emit each layer's accumulation-round packet program.

        Yields ``(layer_name, cfg, program)`` replayable through
        :func:`~repro_torch.core.noc.collective.engine.run_program`.
        ``window`` caps the rounds emitted per layer (None = one round, the
        homogeneous unit the simulator extrapolates from).
        """
        by_name = {l.name: l for l in layers}
        for a in self.assignments:
            layer = by_name[a.layer]
            m = a.mapping
            cfg = m.cfg(base_cfg)
            # A multi-chip assignment re-emits one chip's shard program:
            # every chip runs the same rounds, so one lane is the replay unit.
            layer = shard_layer(layer, m.chips)
            plan = layer_plan(layer, cfg, m.e_pes, m.mode, m.q_bits, m.groups)
            rounds = max(1, min(plan.rounds, window or 1))
            prog = ws_round_program(cfg, m.mode, rounds, g=plan.g, p=plan.p,
                                    gather_flits=plan.gather_flits,
                                    unicast_flits=plan.unicast_flits,
                                    e_pes=m.e_pes)
            yield a.layer, cfg, prog
