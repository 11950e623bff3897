"""WS(+/-INA) and OS dataflow traffic generation + per-layer simulation (a
copy of ``repro.core.noc.traffic``).

Mapping (paper Fig. 3): filters are split into P# parts distributed among P#
vertically-adjacent PEs of one column ("chains"); G = floor(N/P#) chains per
column; each router hosts E PEs, so one chain keeps E filters resident.  Per
accumulation round each chain finishes E output activations.

Architecture (paper [12], "two-way streaming architecture"): weights/inputs
are delivered over dedicated row streaming buses (cheap wires, no router
traversal); the mesh NoC proper carries psum-accumulation and gather traffic.
Hence the +/-INA comparison (Figs 7-9) is decided by NoC traffic and the
WS-vs-OS comparison (Figs 10-12) additionally by streaming volume/overlap.

Traffic per accumulation round:
  * WS without INA (Fig. 4a): every chain runs an eject->add->inject unicast
    relay over its P#-1 hops (2-3 flit packets, paper Table III); the final
    results are collected to the column's memory port (``baseline_collection``
    selects a shared column gather packet or per-chain result unicasts).
  * WS with INA (Fig. 4b): one gather packet per column rides south,
    accumulating each chain in-network (the INA block adds the local operand
    inside the router pipeline) and collecting tails - relay traffic is gone.
  * OS with gather [12]: psums accumulate locally (output-stationary), the
    same gather collects finished outputs; but weights are *not* stationary:
    weight (and input) streaming re-occurs continuously on the buses.

Latency: accumulation rounds are simulated back-to-back in a window of
``sim_rounds`` rounds through the event-driven NoC and extrapolated from the
measured marginal round period (rounds are homogeneous); energy is exact
(event counts scale linearly in rounds).

A window is replayed by the vectorized closed form
(:func:`~repro_torch.core.noc.vectorized.window_result`) when it is on, by
a :class:`CompiledWindow` when the compiled executor is on, and by the
heap engine otherwise; all three give the same bits.  The store
(:data:`~repro_torch.core.noc.simcache.SIM_CACHE`) answers every later ask.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

from ..ina_model import DEFAULT_Q_BITS, ConvLayer, p_num
from .compiled import (CompiledProgram, UncompilableProgram, compile_program,
                       compiled_enabled)
from .router import EnergyLedger, NocConfig
from .simcache import SIM_CACHE
from .simulator import NocSim
from .vectorized import vectorized_enabled, window_result

MODES = ("ws_ina", "ws_noina", "os_gather")


@dataclass
class LayerResult:
    name: str
    mode: str
    e_pes: int
    rounds: int
    fills: int
    latency_cycles: float
    fill_cycles: float
    noc_energy_pj: float
    stream_energy_pj: float

    @property
    def total_energy_pj(self) -> float:
        return self.noc_energy_pj + self.stream_energy_pj

    @property
    def network_power(self) -> float:
        """Average network power (energy per cycle; pJ/cycle ~ mW at 1 GHz)."""
        return self.total_energy_pj / max(self.latency_cycles, 1.0)


@dataclass(frozen=True)
class _Plan:
    p: int                    # P#: PEs per chain (clamped to the column height)
    g: int                    # chains per column
    rounds: int               # accumulation/gather rounds for the whole layer
    fills: int                # weight (re)distribution phases
    passes: int               # sequential chain segments when P# > height
    unicast_flits: int
    gather_flits: int
    weight_bits: int              # whole-filter weight bits at the plan's q
    weight_bits_per_router: int   # per fill


@lru_cache(maxsize=None)
def _plan(layer: ConvLayer, cfg: NocConfig, e_pes: int, mode: str,
          q_bits: int = DEFAULT_Q_BITS, groups: Optional[int] = None) -> _Plan:
    """Lay ``layer`` onto the (possibly rectangular) mesh under ``mode``.

    Memoized: plans are pure functions of frozen inputs, and the mapper's
    analytic ranking re-plans the same (layer, mapping) pairs constantly.

    ``q_bits`` scales the weight precision through Eqs. (1)-(2); ``groups``
    overrides the chains-per-column count G (mapper search axis; clamped to
    the feasible 1..H//P# range).  Defaults reproduce the paper's fixed
    placement bit-for-bit.  When a filter's chain is taller than a column
    (P# > H — GEMM reductions, small meshes), the column accumulates it in
    ``ceil(P#/H)`` sequential passes of H chained PEs, matching the
    ``ina_rounds`` multi-row-chain model.
    """
    w, h = cfg.width, cfg.height
    weight_bits = layer.C * layer.R * layer.R * q_bits
    if mode.startswith("ws"):
        p_req = p_num(layer, q_bits=q_bits)
        p = min(p_req, h)
        passes = math.ceil(p_req / h)
        if passes > 1:
            g = 1
            rounds = passes * math.ceil((layer.F / (w * e_pes))
                                        * layer.outputs)
        else:
            g = h // p if groups is None else max(1, min(groups, h // p))
            rounds = math.ceil((layer.F / (w * e_pes)) * (layer.outputs / g))
        fills = passes * max(1, math.ceil(layer.F / (w * g * e_pes)))
        w_bits_router = math.ceil(weight_bits / p_req) * e_pes
    else:  # OS: whole filters per PE; re-streamed continuously (no stationarity).
        p, g, passes = 1, max(1, h), 1
        rounds = math.ceil(layer.F * layer.outputs / (w * h * e_pes))
        fills = 0
        w_bits_router = weight_bits * e_pes
    # Gather packet sized by the results it collects: one per chain (G) per
    # router-PE (E).  For P#=1 layers this reproduces Table III's static
    # 3/5/9(/17)-flit gather packets (8 nodes x E results on the 8x8 mesh).
    return _Plan(
        p=p, g=g, rounds=rounds, fills=fills, passes=passes,
        unicast_flits=cfg.unicast_flits(e_pes),
        gather_flits=cfg.gather_flits(g * e_pes),
        weight_bits=weight_bits,
        weight_bits_per_router=w_bits_router,
    )


def layer_plan(layer: ConvLayer, cfg: NocConfig, e_pes: int, mode: str,
               q_bits: int = DEFAULT_Q_BITS,
               groups: Optional[int] = None) -> _Plan:
    """Public planner entry point (the mapper prunes/replays from plans)."""
    return _plan(layer, cfg, e_pes, mode, q_bits, groups)


# --------------------------------------------------------------------------- #
# Streaming phases (two-way row buses; contention-free, analytic)
# --------------------------------------------------------------------------- #
def _fill_phase(plan: _Plan, cfg: NocConfig, ledger: EnergyLedger) -> float:
    """One WS weight-distribution barrier: all routers filled over row buses."""
    w, h = cfg.width, cfg.height
    flits_per_router = cfg.payload_flits(plan.weight_bits_per_router)
    # Each of the two bus directions serves half a row's routers, one flit
    # per cycle (rows are ``width`` routers long).
    cycles = (w // cfg.stream_buses_per_row) * flits_per_router
    # Bus energy: every flit drives on average half its direction's segment.
    ledger.stream_flit_segments += w * h * flits_per_router * max(1, w // 4)
    return float(cycles)


def _input_stream_round(plan: _Plan, cfg: NocConfig,
                        ledger: EnergyLedger) -> float:
    """Per-round input streaming (bus cycles per row); common to WS and OS."""
    bits = plan.weight_bits / (plan.p * cfg.ws_input_reuse)
    flits = bits / cfg.flit_bits
    ledger.stream_flit_segments += flits * cfg.width   # broadcast spans the row
    return flits / cfg.stream_buses_per_row


def _os_weight_stream_round(plan: _Plan, cfg: NocConfig,
                            ledger: EnergyLedger) -> float:
    """Per-round OS weight re-streaming (bus cycles per row).

    OS keeps outputs stationary, so weights flow continuously; a streamed
    weight word is only reused ``os_weight_reuse``-wide (one assignment
    wave), unlike WS where a distributed weight serves all output pixels.
    """
    flits = plan.weight_bits / (cfg.flit_bits * cfg.os_weight_reuse)
    ledger.stream_flit_segments += flits * cfg.width
    return flits / cfg.os_stream_bw


# --------------------------------------------------------------------------- #
# Accumulation + gather rounds (planner-emitted schedule, event-driven replay)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class CompiledWindow:
    """One window's packet program, recorded once and replayed flat.

    The program (sources, destinations, flit counts, VCs, dependency
    edges) of a WS/OS window depends only on the plan-shape key, so it is
    compiled on first miss and replayed via
    :class:`~repro_torch.core.noc.compiled.CompiledProgram` without rebuilding
    the PacketOps or the engine's per-op closures (DESIGN.md S10).
    """

    key: tuple
    program: CompiledProgram

    def replay(self) -> tuple[float, EnergyLedger]:
        latency, ledger, _, _ = self.program.run()
        return float(latency), ledger


#: Plan-shape key -> CompiledWindow.  Populated only while the result
#: cache is disabled (``--no-cache`` replays the same window repeatedly);
#: with the cache on, a window's first replay lands in SIM_CACHE and the
#: replicated program would be dead weight.
_WINDOW_PROGRAMS: dict = {}

#: Window-length-free key -> one compiled round; windows of any length
#: replicate it (rounds are dependency-disjoint by construction).
_ROUND_PROGRAMS: dict = {}


def clear_compiled_caches() -> None:
    """Forget every recorded program/plan (cold-start measurement aid).

    Never needed for correctness (programs are pure functions of their
    keys): only to measure genuinely cold runs or to bound memory.
    """
    from . import simulator, topology, vectorized

    _WINDOW_PROGRAMS.clear()
    _ROUND_PROGRAMS.clear()
    _plan.cache_clear()
    simulator.clear_link_caches()
    topology.clear_route_caches()
    vectorized.clear_vector_caches()


def _compiled_window(key: tuple, cfg: NocConfig, mode: str, window: int,
                     plan: _Plan, e_pes: int) -> Optional[CompiledWindow]:
    """Build (or fetch) the CompiledWindow for a plan-shape key."""
    from .collective.schedule import ws_round_program

    cw = _WINDOW_PROGRAMS.get(key)
    if cw is not None:
        return cw
    round_key = (cfg, mode, plan.g, plan.p, plan.gather_flits,
                 plan.unicast_flits, e_pes)
    base = _ROUND_PROGRAMS.get(round_key)
    if base is None:
        prog = ws_round_program(cfg, mode, 1, g=plan.g, p=plan.p,
                                gather_flits=plan.gather_flits,
                                unicast_flits=plan.unicast_flits,
                                e_pes=e_pes)
        try:
            base = compile_program(prog, cfg)
        except UncompilableProgram:     # exotic config: heap fallback
            return None
        _ROUND_PROGRAMS[round_key] = base
    cw = CompiledWindow(key, base.replicate(window))
    if not SIM_CACHE.enabled:
        _WINDOW_PROGRAMS[key] = cw
    return cw


def _sim_rounds_window(plan: _Plan, cfg: NocConfig, mode: str, window: int,
                       e_pes: int = 1) -> tuple[float, EnergyLedger]:
    """Simulate ``window`` back-to-back rounds; return (makespan, ledger).

    The per-round traffic — column gather packets with in-network
    accumulation (``ws_ina``/``os_gather``) or Fig. 4(a) relay chains gated
    before the collection (``ws_noina``) — is emitted by the collective
    planner (:func:`~repro_torch.core.noc.collective.schedule.ws_round_program`)
    and replayed on the event-driven simulator: by the vectorized closed
    form or through a :class:`CompiledWindow` normally, or through the
    closure-based heap engine under :func:`~repro_torch.core.noc.compiled.
    compiled_disabled` (ground truth; all are bit-identical).

    Results are memoized per plan shape in :data:`~repro_torch.core.noc.
    simcache.SIM_CACHE`: the window program depends on the key below and not
    on the layer identity, so a whole-network search replays each distinct
    program once.
    """
    from .collective.engine import run_program
    from .collective.schedule import ws_round_program

    key = (cfg, mode, window, plan.g, plan.p, plan.gather_flits,
           plan.unicast_flits, e_pes)
    hit = SIM_CACHE.get(key)
    if hit is not None:
        return hit
    if compiled_enabled():
        if vectorized_enabled():
            vec = window_result(cfg, mode, window, plan.g, plan.p,
                                plan.gather_flits, plan.unicast_flits, e_pes)
            if vec is not None:
                latency, ledger = vec
                SIM_CACHE.put(key, latency, ledger)
                return latency, ledger
        cw = _compiled_window(key, cfg, mode, window, plan, e_pes)
        if cw is not None:
            latency, ledger = cw.replay()
            SIM_CACHE.put(key, latency, ledger)
            return latency, ledger
    sim = NocSim(cfg)
    prog = ws_round_program(cfg, mode, window, g=plan.g, p=plan.p,
                            gather_flits=plan.gather_flits,
                            unicast_flits=plan.unicast_flits, e_pes=e_pes)
    res = run_program(prog, cfg, sim=sim)
    SIM_CACHE.put(key, float(res.latency_cycles), sim.ledger)
    return float(res.latency_cycles), sim.ledger


def _accum_phase(plan: _Plan, cfg: NocConfig, mode: str,
                 sim_rounds: int, e_pes: int) -> tuple[float, EnergyLedger]:
    rounds = plan.rounds
    if rounds <= 0:
        return 0.0, EnergyLedger()
    w_big = min(rounds, max(1, sim_rounds))   # at least one simulated round
    t_big, led_big = _sim_rounds_window(plan, cfg, mode, w_big, e_pes)
    if rounds <= w_big:
        return t_big, led_big
    w_small = max(1, w_big // 2)
    if w_small == w_big:
        # Single-round window (sim_rounds=1): no second measurement point;
        # the whole window is one round, so it *is* the marginal period.
        marginal = t_big / w_big
    else:
        t_small, _ = _sim_rounds_window(plan, cfg, mode, w_small, e_pes)
        marginal = (t_big - t_small) / (w_big - w_small)
    return t_big + (rounds - w_big) * marginal, led_big.scaled(rounds / w_big)


# --------------------------------------------------------------------------- #
def simulate_layer(layer: ConvLayer, mode: str, cfg: NocConfig = NocConfig(),
                   e_pes: int = 1, sim_rounds: int = 32,
                   q_bits: int = DEFAULT_Q_BITS,
                   groups: Optional[int] = None) -> LayerResult:
    """Simulate one CONV/GEMM layer under a dataflow mode.

    ``q_bits``/``groups`` are mapper search axes (see :func:`_plan`); the
    defaults reproduce the paper's fixed placement.
    """
    assert mode in MODES, mode
    plan = _plan(layer, cfg, e_pes, mode, q_bits, groups)
    stream_ledger = EnergyLedger()

    noc_cycles, noc_ledger = _accum_phase(plan, cfg, mode, sim_rounds, e_pes)

    # Per-round input streaming paces the steady state together with the NoC
    # (whichever is slower); its energy scales with rounds.
    in_round = _input_stream_round(plan, cfg, stream_ledger)
    stream_ledger.stream_flit_segments *= max(plan.rounds, 1)

    if mode.startswith("ws"):
        # Weight barrier: distribution must finish before MACs/psums start.
        # One fill is computed and accumulated ``fills`` times (alexnet's FC
        # tail alone runs thousands of identical fills per layer); the
        # repeated float adds are kept so the ledger stays bit-identical to
        # the historical per-fill loop, but the phase itself is derived once.
        fill_cycles = 0
        if plan.fills:
            tmp = EnergyLedger()
            one = _fill_phase(plan, cfg, tmp)
            seg = stream_ledger.stream_flit_segments
            for _ in range(plan.fills):
                seg += tmp.stream_flit_segments
            stream_ledger.stream_flit_segments = seg
            fill_cycles = one * plan.fills
        latency = fill_cycles + max(noc_cycles, in_round * plan.rounds)
    else:
        # OS overlaps weight+input distribution with execution (paper SIV.B):
        # the layer is paced by the slower of streaming and the gather NoC.
        tmp = EnergyLedger()
        w_round = _os_weight_stream_round(plan, cfg, tmp)
        stream_ledger.stream_flit_segments += tmp.stream_flit_segments * plan.rounds
        fill_cycles = (w_round + in_round) * plan.rounds
        latency = max(fill_cycles, noc_cycles)

    return LayerResult(
        name=layer.name, mode=mode, e_pes=e_pes,
        rounds=plan.rounds, fills=plan.fills,
        latency_cycles=latency, fill_cycles=fill_cycles,
        noc_energy_pj=noc_ledger.network_energy_pj(cfg),
        stream_energy_pj=stream_ledger.energy_pj(cfg),
    )


def simulate_network(layers: list[ConvLayer], mode: str,
                     cfg: NocConfig = NocConfig(), e_pes: int = 1,
                     sim_rounds: int = 32,
                     q_bits: int = DEFAULT_Q_BITS) -> dict:
    """Whole-network totals (layers execute back-to-back, as in the paper)."""
    results = [simulate_layer(l, mode, cfg, e_pes, sim_rounds, q_bits)
               for l in layers]
    latency = sum(r.latency_cycles for r in results)
    noc_e = sum(r.noc_energy_pj for r in results)
    stream_e = sum(r.stream_energy_pj for r in results)
    return {
        "mode": mode, "e_pes": e_pes, "layers": results,
        "latency_cycles": latency,
        "noc_energy_pj": noc_e,
        "stream_energy_pj": stream_e,
        "total_energy_pj": noc_e + stream_e,
        "network_power": (noc_e + stream_e) / max(latency, 1.0),
    }
