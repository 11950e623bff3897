"""Hierarchical collective costs, riding the persistent SIM_CACHE (a copy
of ``repro.core.noc.hierarchy.cost``).

Every lane of a :class:`~.collective.HierarchicalSchedule` is a flat
collective on its own config, so lane costs reuse the flat
:func:`~repro_torch.core.noc.collective.cost.collective_cost` facade: the
same ``("collective", ...)`` SIM_CACHE keys, the same COST_STATS
accounting, the same persistence.  A multi-chip plan therefore
re-simulates *nothing* a warm store already holds (a warm re-plan runs 0
engine runs), and identical chips dedup through the lru and store layers.
Express-star package lanes are the one shape ``plan_collective`` cannot
emit; they get their own ``("hier-express", ...)`` store key with the same
protocol.

The psum facade mirrors ``collective/cost.psum_mode_costs``: a TP axis of
``p`` devices over ``chips`` chips is embedded as one PE row per chip
(contiguous split, so uneven tails are priced exactly) plus the chip
roots as one package row.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

from ..collective.cost import (AUTO_CANDIDATES, COST_STATS, CollectiveCost,
                               PSUM_MODE_LOWERING, _row_cfg, collective_cost)
from ..collective.engine import run_program
from ..collective.trees import mesh_row
from ..router import NocConfig
from ..simcache import SIM_CACHE
from .collective import _package_program
from .topology import Coord, HierarchicalMesh


@dataclass(frozen=True)
class HierCost:
    """Simulated cost of one hierarchical collective."""

    op: str
    algorithm: str
    semantics: str
    chips: int
    participants: int
    payload_bits: float
    latency_cycles: int
    energy_pj: float
    packets: int
    #: per-level (name, latency_cycles) in execution order
    level_latency: tuple = ()


@lru_cache(maxsize=4096)
def _simulate_express(op: str, chips: tuple[Coord, ...],
                      payload_bits: float, pkg_cfg: NocConfig, root: Coord,
                      algorithm: str, semantics: str) -> tuple[int, float, int]:
    """Run (or recall) one express-star package lane.  The store protocol
    of ``collective/cost._simulate`` under a distinct leading tag: the
    schema-hashed persistent store replays these across processes too."""
    prog = _package_program(op, list(chips), payload_bits, pkg_cfg, root,
                            express=True, algorithm=algorithm,
                            semantics=semantics)
    packets = sum(1 for o in prog if o.flits)
    key = ("hier-express", op, chips, payload_bits, pkg_cfg, root,
           algorithm, semantics)
    hit = SIM_CACHE.get(key)
    if hit is not None:
        COST_STATS["store_hits"] += 1
        latency, ledger = hit
        return (int(latency), ledger.network_energy_pj(pkg_cfg), packets)
    COST_STATS["engine_runs"] += 1
    res = run_program(prog, pkg_cfg)
    SIM_CACHE.put(key, float(res.latency_cycles), res.ledger)
    return (res.latency_cycles, res.network_energy_pj(pkg_cfg), packets)


def _package_cost(op: str, chips: list[Coord], payload_bits: float,
                  hmesh: HierarchicalMesh, cfg: NocConfig, *,
                  algorithm: str, semantics: str) -> tuple[int, float, int]:
    """(latency, energy_pj, packets) of the package-level lane."""
    pkg_cfg = hmesh.package_cfg(cfg)
    root = hmesh.chip_coord(min(hmesh.chip_id(cx, cy) for cx, cy in chips))
    if hmesh.package == "express":
        return _simulate_express(op, tuple(sorted(chips)),
                                 float(payload_bits), pkg_cfg, root,
                                 algorithm, semantics)
    c = collective_cost(op, payload_bits, pkg_cfg,
                        participants=chips, root=root,
                        algorithm=algorithm, semantics=semantics)
    return (c.latency_cycles, c.energy_pj, c.packets)


# --------------------------------------------------------------------------- #
# whole-hierarchy collectives
# --------------------------------------------------------------------------- #
def hier_collective_cost(op: str, hmesh: HierarchicalMesh,
                         payload_bits: float,
                         cfg: NocConfig = NocConfig(), *,
                         algorithm: str = "reduce_bcast",
                         semantics: str = "ina") -> HierCost:
    """Cost of a collective over *every* PE of ``hmesh``: per-level lane
    costs from the flat facade (identical chips priced once), levels
    summed, concurrent lanes maxed."""
    chip_cfg = hmesh.chip_cfg(cfg)
    chip_parts = [(x, y) for y in range(hmesh.chip_h)
                  for x in range(hmesh.chip_w)]
    chips = sorted(hmesh.chip_coord(c) for c in range(hmesh.num_chips))
    n_chips = hmesh.num_chips
    if n_chips == 1:
        c = collective_cost(op, payload_bits, chip_cfg,
                            participants=chip_parts,
                            root=hmesh.chip_root_xy,
                            algorithm=algorithm, semantics=semantics)
        return HierCost(op, algorithm, semantics, 1, len(chip_parts),
                        float(payload_bits), c.latency_cycles, c.energy_pj,
                        c.packets, (("flat", c.latency_cycles),))

    def chip_level(cop: str) -> tuple[int, float, int]:
        c = collective_cost(cop, payload_bits, chip_cfg,
                            participants=chip_parts,
                            root=hmesh.chip_root_xy, semantics=semantics)
        return (c.latency_cycles, n_chips * c.energy_pj, n_chips * c.packets)

    levels: list[tuple[str, tuple[int, float, int]]] = []
    if op in ("reduce", "allreduce"):
        levels.append(("intra-reduce", chip_level("reduce")))
    pkg_op = op if op != "broadcast" else "broadcast"
    levels.append(("package", _package_cost(
        pkg_op, chips, payload_bits, hmesh, cfg,
        algorithm=algorithm, semantics=semantics)))
    if op in ("broadcast", "allreduce"):
        levels.append(("intra-bcast", chip_level("broadcast")))
    latency = sum(lat for _, (lat, _, _) in levels)
    energy = sum(e for _, (_, e, _) in levels)
    packets = sum(p for _, (_, _, p) in levels)
    return HierCost(op, algorithm, semantics, n_chips,
                    n_chips * len(chip_parts), float(payload_bits),
                    latency, energy, packets,
                    tuple((name, lat) for name, (lat, _, _) in levels))


# --------------------------------------------------------------------------- #
# psum facade: a TP axis of p devices over `chips` chips
# --------------------------------------------------------------------------- #
def _chip_spans(p: int, chips: int) -> list[int]:
    """Contiguous split of ``p`` TP ranks over ``chips`` chips (the tail
    chips run one rank short when the split is uneven)."""
    c = max(1, min(chips, p))
    base, rem = divmod(p, c)
    return [base + (1 if i < rem else 0) for i in range(c)]


def hier_psum_mode_costs(p: int, nbytes: int,
                         cfg: NocConfig = NocConfig(), *,
                         chips: int = 1, package: str = "mesh",
                         pkg_link_cycles: int = 4,
                         pkg_flit_bits: Optional[int] = None,
                         ) -> dict[str, CollectiveCost]:
    """Allreduce cost for every PsumMode over a ``p``-rank TP axis split
    across ``chips`` chips.  ``chips <= 1`` delegates to the flat
    :func:`~repro_torch.core.noc.collective.cost.psum_mode_costs`
    embedding: identical keys, identical numbers."""
    from ..collective.cost import psum_mode_costs
    if chips <= 1 or p <= 1:
        return psum_mode_costs(p, nbytes, cfg)
    spans = _chip_spans(p, chips)
    c_eff = len(spans)
    hmesh = HierarchicalMesh(
        chip_w=max(cfg.n, max(spans)), chip_h=cfg.height,
        chips_x=c_eff, chips_y=1, package=package,
        pkg_link_cycles=pkg_link_cycles, pkg_flit_bits=pkg_flit_bits)
    payload_bits = nbytes * 8
    chip_coords = mesh_row(c_eff, 0)
    out: dict[str, CollectiveCost] = {}
    for mode, (algorithm, semantics) in PSUM_MODE_LOWERING.items():
        latency = 0
        energy = 0.0
        packets = 0
        # intra-chip reduce + broadcast-back, one lane shape per distinct
        # span (lanes overlap: latency is the worst span, energy sums all)
        for phase in ("reduce", "broadcast"):
            worst = 0
            for span in sorted(set(spans)):
                if span <= 1:
                    continue
                rcfg = _row_cfg(span, cfg)
                c = collective_cost(phase, payload_bits, rcfg,
                                    participants=mesh_row(span, 0)[:span],
                                    root=(0, 0), semantics=semantics)
                worst = max(worst, c.latency_cycles)
                k = sum(1 for s in spans if s == span)
                energy += k * c.energy_pj
                packets += k * c.packets
            latency += worst
        pkg_lat, pkg_e, pkg_p = _package_cost(
            "allreduce", chip_coords, payload_bits, hmesh, cfg,
            algorithm=algorithm, semantics=semantics)
        latency += pkg_lat
        energy += pkg_e
        packets += pkg_p
        out[mode] = CollectiveCost(
            op="allreduce", algorithm=algorithm, semantics=semantics,
            n=cfg.n, participants=p, payload_bits=float(payload_bits),
            latency_cycles=latency, energy_pj=energy, packets=packets)
    return out


def choose_hier_psum_mode(p: int, nbytes: int,
                          cfg: NocConfig = NocConfig(), *,
                          chips: int = 1, package: str = "mesh",
                          objective: str = "latency") -> str:
    """Argmin over :data:`AUTO_CANDIDATES` of the hierarchical psum cost
    (ties resolve toward the INA fast path, as in the flat chooser)."""
    if p <= 1:
        return "ina"
    costs = hier_psum_mode_costs(p, nbytes, cfg, chips=chips,
                                 package=package)
    key = (lambda c: c.latency_cycles) if objective == "latency" \
        else (lambda c: c.energy_pj)
    return min(AUTO_CANDIDATES,
               key=lambda m: (key(costs[m]), AUTO_CANDIDATES.index(m)))


def chip_round_cost(payload_bits: float, chips: int,
                    cfg: NocConfig = NocConfig(), *, package: str = "mesh",
                    pkg_link_cycles: int = 4,
                    semantics: str = "ina") -> tuple[int, float]:
    """(latency, energy) of shipping one round's operands to every chip
    over the package network: the mapper's per-round multi-chip surcharge
    (a package broadcast from the feeding chip's root)."""
    if chips <= 1:
        return (0, 0.0)
    hmesh = HierarchicalMesh(chips_x=chips, chips_y=1, package=package,
                             pkg_link_cycles=pkg_link_cycles)
    lat, e, _ = _package_cost("broadcast", mesh_row(chips, 0), payload_bits,
                              hmesh, cfg, algorithm="reduce_bcast",
                              semantics=semantics)
    return (lat, e)


def hier_cache_key_count() -> int:
    """Distinct express-lane signatures memoized in this process."""
    return _simulate_express.cache_info().currsize


def square_hier_mesh(chips: int, chip_w: int = 8, chip_h: int = 8, *,
                     package: str = "mesh",
                     pkg_link_cycles: int = 4) -> HierarchicalMesh:
    """A near-square chip grid for ``chips`` chips (sweep helper)."""
    cx = int(math.sqrt(chips))
    while chips % cx:
        cx -= 1
    return HierarchicalMesh(chip_w=chip_w, chip_h=chip_h,
                            chips_x=chips // cx, chips_y=cx,
                            package=package,
                            pkg_link_cycles=pkg_link_cycles)
