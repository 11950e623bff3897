"""The mapping search space: what the mapper enumerates, and how it prunes
(a copy of ``repro.mapper.space``).

A :class:`Mapping` is one way to lay a layer onto the accelerator: a mesh
shape (rectangular ``width x height`` included), PEs per router, dataflow
(WS/OS), router collective semantics (INA vs eject->add->inject), weight
precision, and the chains-per-column count G (the paper always uses the
maximum ``floor(H/P#)``; smaller G trades bigger gather payloads against
round count, which is exactly the latency/energy tension the Pareto report
surfaces).

Hardware axes (``width``/``height``/``e_pes``) are fixed for a whole network
— a chip does not reconfigure between layers — while the per-layer axes
(``dataflow``/``semantics``/``groups``/``q_bits``) may vary layer to layer.
:class:`MapperConfig` bounds the space under a PE budget so searched
mappings compare fairly against the paper's fixed 8x8x1 placement.

Pruning rules (DESIGN.md S9):
1. *Feasibility* — WS needs ``g * P# <= height`` per Eq. (2); chains taller
   than a column fall back to the sequential multi-pass model and only the
   maximal-G mapping is kept for them.
2. *Budget* — ``width * height * e_pes`` must land in
   ``[pe_budget * min_pe_fill, pe_budget]``; aspect ratios beyond
   ``max_aspect`` are dropped (row streaming degenerates).
3. *Analytic ranking* — survivors are ranked by the Eq. (1)-(4) round count
   composed with per-round serialization bounds (:func:`analytic_latency`),
   and only the ``prune_keep`` best per (layer, hardware) reach the
   event-driven simulator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

from repro_torch.core.ina_model import DEFAULT_Q_BITS, p_num
from repro_torch.core.noc import NocConfig
from repro_torch.core.noc.router import cached_field_hash, state_without_hash
from repro_torch.core.noc.traffic import layer_plan
from repro_torch.core.ops import LayerShape

DATAFLOWS = ("ws", "os")
SEMANTICS = ("ina", "eject_inject")


@dataclass(frozen=True)
class Mapping:
    """One candidate placement of a layer onto the mesh.

    ``chips`` > 1 replicates the mesh across a package of chips
    (DESIGN.md S14): output rows shard evenly per chip, weights are
    broadcast over the package network once per fill, and the per-chip
    shard runs the unchanged flat simulator.
    """

    width: int = 8
    height: int = 8
    e_pes: int = 1
    dataflow: str = "ws"            # "ws" | "os"
    semantics: str = "ina"          # "ina" | "eject_inject"
    q_bits: int = DEFAULT_Q_BITS
    groups: Optional[int] = None    # chains per column (None = max feasible)
    chips: int = 1                  # package replication (1 = flat mesh)

    @property
    def mode(self) -> str:
        """The traffic-generator mode this mapping lowers to."""
        if self.dataflow == "os":
            return "os_gather"
        return "ws_ina" if self.semantics == "ina" else "ws_noina"

    @property
    def num_pes(self) -> int:
        return self.width * self.height * self.e_pes * self.chips

    @property
    def hardware(self) -> tuple[int, ...]:
        """(w, h, e) for flat mappings — the pre-hierarchy tuple — and
        (w, h, e, chips) once a package axis exists."""
        if self.chips == 1:
            return (self.width, self.height, self.e_pes)
        return (self.width, self.height, self.e_pes, self.chips)

    @property
    def sort_key(self) -> tuple:
        """Total deterministic order (``groups=None`` sorts first)."""
        return (self.width, self.height, self.e_pes, self.dataflow,
                self.semantics, self.q_bits,
                -1 if self.groups is None else self.groups, self.chips)

    def cfg(self, base: NocConfig = NocConfig()) -> NocConfig:
        """The NocConfig one chip of this mapping simulates under."""
        rows = None if self.height == self.width else self.height
        return _mesh_cfg(base, self.width, rows)

    def label(self) -> str:
        g = "max" if self.groups is None else str(self.groups)
        lab = (f"{self.width}x{self.height}xE{self.e_pes}:{self.dataflow}/"
               f"{self.semantics}/q{self.q_bits}/g{g}")
        if self.chips > 1:
            lab += f"/c{self.chips}"
        return lab


#: Mappings are dict keys in the layer-result memo and members of sort
#: keys; cache their field hash like NocConfig's (see router.py).
Mapping.__hash__ = cached_field_hash
Mapping.__getstate__ = state_without_hash


@lru_cache(maxsize=None)
def _mesh_cfg(base: NocConfig, n: int, rows: Optional[int]) -> NocConfig:
    """Memoized mesh reshape (``dataclasses.replace`` is surprisingly hot:
    the search derives the same few configs tens of thousands of times)."""
    return dataclasses.replace(base, n=n, rows=rows)


#: The paper's fixed placement: 8x8 square, 1 PE/router, WS + INA, q=32,
#: maximal chains per column (Eqs. 1-4 / Fig. 3).
PAPER_MAPPING = Mapping()


@dataclass(frozen=True)
class MapperConfig:
    """Bounds of the search space (defaults sized to the paper's 64 PEs).

    ``pe_budget`` bounds one *chip*; ``chips_list`` adds a package axis on
    top of it (every listed count pairs with every in-budget chip shape),
    so multi-chip candidates compare per-chip-fair against the paper's
    fully-populated single mesh.
    """

    pe_budget: int = 64             # width * height * e_pes ceiling per chip
    min_pe_fill: float = 0.5        # floor, as a fraction of the budget
    max_aspect: int = 4             # max width/height (and height/width)
    min_dim: int = 2                # smallest mesh side considered
    e_list: tuple[int, ...] = (1, 2, 4)
    q_list: tuple[int, ...] = (DEFAULT_Q_BITS,)
    dataflows: tuple[str, ...] = DATAFLOWS
    semantics: tuple[str, ...] = SEMANTICS
    group_options: int = 3          # distinct G values tried per (layer, hw)
    prune_keep: int = 6             # survivors simulated per (layer, hw)
    sim_rounds: int = 16            # simulated window length
    chips_list: tuple[int, ...] = (1,)   # package axis (DESIGN.md S14)
    package: str = "mesh"           # cross-chip fabric ("mesh" | "express")


#: CI smoke shape: square + one rectangle, two E points, short windows.
QUICK_MAPPER = MapperConfig(e_list=(1, 2), min_dim=4, group_options=2,
                            prune_keep=4, sim_rounds=4)


def hardware_candidates(mcfg: MapperConfig) -> list[tuple[int, ...]]:
    """All hardware points inside the per-chip budget (deterministic).

    Dimensions run over powers of two (meshes and Eq. (3) divisions stay
    integral); the budget floor keeps the comparison against the paper's
    fully-populated mesh fair.  Single-chip points stay the historical
    ``(w, h, e)`` triples; every ``chips_list`` entry > 1 adds
    ``(w, h, e, chips)`` package points on the same chip shapes.
    """
    dims = []
    d = mcfg.min_dim
    while d * mcfg.min_dim <= mcfg.pe_budget:
        dims.append(d)
        d *= 2
    out: list[tuple[int, ...]] = []
    lo = mcfg.pe_budget * mcfg.min_pe_fill
    for w in dims:
        for h in dims:
            if max(w, h) > mcfg.max_aspect * min(w, h):
                continue
            for e in mcfg.e_list:
                if not lo <= w * h * e <= mcfg.pe_budget:
                    continue
                for chips in sorted(set(mcfg.chips_list)):
                    out.append((w, h, e) if chips == 1
                               else (w, h, e, chips))
    return sorted(out)


def hardware_mapping_fields(hw: tuple[int, ...]) -> tuple[int, int, int, int]:
    """(w, h, e, chips) from a 3- or 4-tuple hardware point."""
    w, h, e = hw[:3]
    chips = hw[3] if len(hw) > 3 else 1
    return w, h, e, chips


def group_choices(p_req: int, height: int, k: int) -> list[Optional[int]]:
    """Up to ``k`` chains-per-column values: max feasible, then halvings.

    ``None`` (= the paper's maximal G) always leads; ``G=1`` closes the list
    when it fits.  Chains taller than the column (``p_req > height``) leave
    only the sequential multi-pass mapping (pruning rule 1).
    """
    g_max = height // min(p_req, height)
    if p_req > height or g_max <= 1:
        return [None]
    out: list[Optional[int]] = [None]
    g = g_max // 2
    while g > 1 and len(out) < k - 1:
        out.append(g)
        g //= 2
    if len(out) < k:
        out.append(1)
    return out


def layer_candidates(layer: LayerShape, hardware: tuple[int, ...],
                     mcfg: MapperConfig) -> list[Mapping]:
    """Enumerate the per-layer mappings for one hardware point (sorted)."""
    w, h, e, chips = hardware_mapping_fields(hardware)
    out = []
    for q in mcfg.q_list:
        if "os" in mcfg.dataflows and "ina" in mcfg.semantics:
            # OS keeps psums local; the gather collective is the only NoC
            # flow and it needs gather-capable routers — OS under plain
            # eject/inject routers is not modeled (paper SIV.B compares
            # OS-with-gather only), so OS contributes one candidate per q
            # and none at all when the space excludes capable routers.
            out.append(Mapping(w, h, e, "os", "ina", q, None, chips))
        if "ws" not in mcfg.dataflows:
            continue
        p_req = p_num(layer, q_bits=q)
        for sem in mcfg.semantics:
            for g in group_choices(p_req, h, mcfg.group_options):
                out.append(Mapping(w, h, e, "ws", sem, q, g, chips))
    return sorted(set(out), key=lambda m: m.sort_key)


def shard_layer(layer: LayerShape, chips: int) -> LayerShape:
    """The per-chip slice of a layer under package replication.

    Output rows (M) shard evenly across chips — weights replicate, so the
    only cross-chip traffic is the per-fill package broadcast the search
    prices with the reference's ``repro.core.noc.hierarchy.chip_round_cost``
    (not ported: the port's search raises for ``chips`` > 1).  CONV
    layers shard through their exact im2col GEMM (same MACs, P#, rounds).
    """
    if chips <= 1:
        return layer
    from repro_torch.core.ops import GemmLayer, im2col
    g = layer if isinstance(layer, GemmLayer) else im2col(layer)
    return dataclasses.replace(g, name=f"{g.name}+c{chips}",
                               M=-(-g.M // chips))


def analytic_latency(layer: LayerShape, mapping: Mapping,
                     base_cfg: NocConfig = NocConfig()) -> float:
    """Cheap cycle estimate used for pruning (no event-driven simulation).

    Composes the Eq. (1)-(4) round count (via :func:`layer_plan`, the same
    arithmetic) with per-round serialization bounds: the column gather
    occupies its ejection port for ``gather_flits`` cycles per round, a
    Fig. 4(a) relay chain adds its eject->add->inject pipeline, and weight
    fills bar execution.  Not exact — contention is what the simulator is
    for — but monotone enough to rank candidates (DESIGN.md S9).  Chips > 1
    rank on their per-chip shard plus a hop-count package-broadcast bound
    (the exact surcharge is simulated only for pruning survivors).
    """
    cfg = mapping.cfg(base_cfg)
    layer = shard_layer(layer, mapping.chips)
    plan = layer_plan(layer, cfg, mapping.e_pes, mapping.mode,
                      mapping.q_bits, mapping.groups)
    hop = cfg.router_cycles + cfg.link_cycles
    per_round = float(plan.gather_flits)
    if mapping.mode == "ws_noina" and plan.p > 1:
        per_round += (plan.p - 1) * (hop + 2 * cfg.ni_cycles
                                     + plan.unicast_flits
                                     + cfg.pe_add_cycles)
    depth = (cfg.height - 1) * hop + 2 * cfg.ni_cycles
    fill = plan.fills * (cfg.width // cfg.stream_buses_per_row) \
        * cfg.payload_flits(plan.weight_bits_per_router)
    stream = plan.weight_bits / (plan.p * cfg.ws_input_reuse * cfg.flit_bits
                                 * cfg.stream_buses_per_row)
    if mapping.dataflow == "os":
        # OS re-streams weights continuously (no stationarity): its
        # per-round pacing is the weight re-stream plus input streaming,
        # mirroring _os_weight_stream_round in the exact simulator.
        stream += plan.weight_bits / (cfg.flit_bits * cfg.os_weight_reuse
                                      * cfg.os_stream_bw)
    total = fill + depth + plan.rounds * max(per_round, stream)
    if mapping.chips > 1:
        # Analytic package surcharge: per fill, the weight payload crosses
        # the package diameter and serializes onto one root link.
        pkg_bits = plan.weight_bits_per_router * cfg.width * cfg.height
        total += plan.fills * ((mapping.chips - 1) * (cfg.router_cycles + 4)
                               + pkg_bits / cfg.flit_bits)
    return total
