"""Power/energy reporting helpers (Orion-3.0-style, ratio-oriented; a copy
of ``repro.core.noc.power``).

The paper reports *improvement ratios* (Figs 7-12): latency ratio
latency(baseline)/latency(INA) and power ratio power(baseline)/power(INA),
where power = network energy / runtime.  Absolute pJ constants live in
:class:`repro_torch.core.noc.router.NocConfig`; ratios are robust to their scale.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..ina_model import ConvLayer
from .router import NocConfig
from .traffic import simulate_network


@dataclass(frozen=True)
class Improvement:
    workload: str
    e_pes: int
    latency_x: float      # baseline_latency / ina_latency   (>1 = INA better)
    power_x: float        # baseline_power   / ina_power
    energy_x: float       # baseline_energy  / ina_energy


def ws_ina_improvement(name: str, layers: list[ConvLayer], e_pes: int,
                       cfg: NocConfig = NocConfig(), sim_rounds: int = 32,
                       ) -> Improvement:
    """Fig. 7-9: WS+INA vs WS-without-INA.

    Both flows are schedules emitted by the collective planner
    (``collective.schedule.ws_round_program``) and replayed on the program
    engine; ``tests/test_noc_collective.py`` pins the results to the
    pre-planner traffic generator cycle-exactly.
    """
    base = simulate_network(layers, "ws_noina", cfg, e_pes, sim_rounds)
    ina = simulate_network(layers, "ws_ina", cfg, e_pes, sim_rounds)
    return Improvement(
        workload=name, e_pes=e_pes,
        latency_x=base["latency_cycles"] / ina["latency_cycles"],
        power_x=base["network_power"] / ina["network_power"],
        energy_x=base["total_energy_pj"] / ina["total_energy_pj"],
    )


def ws_vs_os_improvement(name: str, layers: list[ConvLayer], e_pes: int,
                         cfg: NocConfig = NocConfig(), sim_rounds: int = 32,
                         ) -> Improvement:
    """Fig. 10-12: WS+INA vs OS-with-gather."""
    base = simulate_network(layers, "os_gather", cfg, e_pes, sim_rounds)
    ina = simulate_network(layers, "ws_ina", cfg, e_pes, sim_rounds)
    return Improvement(
        workload=name, e_pes=e_pes,
        latency_x=base["latency_cycles"] / ina["latency_cycles"],
        power_x=base["network_power"] / ina["network_power"],
        energy_x=base["total_energy_pj"] / ina["total_energy_pj"],
    )
