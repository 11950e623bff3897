"""Hierarchical collectives: per-level lowering onto the flat machinery (a
copy of ``repro.core.noc.hierarchy.collective``).

A hierarchical collective is a *sequence of levels*; each level is a set of
*lanes* that run concurrently on disjoint networks (one lane per chip, or
one package-level lane).  Every lane is an ordinary flat
:class:`~repro_torch.core.noc.collective.schedule.PacketOp` program under
its own :class:`~repro_torch.core.noc.router.NocConfig`, which the engine
replays unchanged: that is the whole point of the lowering.

* ``reduce``    -> [intra-chip reduce to each chip root] ; [package reduce
  over chip roots]
* ``broadcast`` -> [package multicast to chip roots] ; [intra-chip
  broadcast from each chip root]
* ``allreduce`` -> [intra-chip reduce] ; [package allreduce (either
  algorithm)] ; [intra-chip broadcast]

With a single populated chip there is nothing to lower: the plan is one
level whose one lane is *exactly* the flat ``plan_collective`` program on
the chip's config, so its latency and energy ledger are the flat
program's by construction.

Package lanes on the ``"mesh"`` variant come from ``plan_collective`` on
the package config (chips are just nodes).  The ``"express"`` variant
plans over a *star* tree whose edges are the dedicated chip-root ->
package-root channels: INA semantics reuse the flat segment planners
(star segments are single express edges, carried as path overrides the
heap engine resolves to per-channel overflow resources); eject-inject
semantics emit the star's unicasts explicitly with the same path
overrides.

The reference's ``faults=`` and ``failed_chips=`` (on-die faults and
whole-chip loss) go with its fault layer, which the port does not have
(``ROADMAP.md``, out of scope); the port has one executor, so
:func:`run_hier_schedule` takes no ``engine=``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..collective.engine import run_program
from ..collective.schedule import (ALLREDUCE_ALGORITHMS, SEMANTICS, PacketOp,
                                   _payload_flits, _plan_multicast_ina,
                                   _plan_reduce_ina, _words, plan_collective)
from ..collective.trees import CollectiveTree
from ..router import EnergyLedger, NocConfig
from .topology import Coord, HierCoord, HierarchicalMesh, group_by_chip

HIER_OPS = ("reduce", "broadcast", "allreduce")


@dataclass(frozen=True)
class HierLane:
    """One flat program on one physical network (a chip, or the package)."""

    label: str                    # "chip3" / "package"
    scope: str                    # "chip" | "package"
    cfg: NocConfig
    prog: tuple = ()              # tuple[PacketOp, ...]
    chip: Optional[int] = None    # chip index for chip-scope lanes


@dataclass(frozen=True)
class HierLevel:
    """Concurrent lanes; the level completes when its slowest lane does."""

    name: str                     # "flat" / "intra-reduce" / "package" / ...
    lanes: tuple = ()             # tuple[HierLane, ...]


@dataclass(frozen=True)
class HierarchicalSchedule:
    """A lowered hierarchical collective: levels run in sequence."""

    hmesh: HierarchicalMesh
    op: str
    semantics: str
    algorithm: str
    payload_bits: float
    levels: tuple = ()            # tuple[HierLevel, ...]

    def all_lanes(self):
        for level in self.levels:
            for lane in level.lanes:
                yield level, lane


@dataclass
class HierResult:
    """Replay outcome: levels are serialized, lanes within a level are
    concurrent (max), energy sums over every lane under its own config."""

    latency_cycles: int
    energy_pj: float
    ledger: EnergyLedger          # combined event counts across all lanes
    level_latency: dict = field(default_factory=dict)


# --------------------------------------------------------------------------- #
# express-star package programs
# --------------------------------------------------------------------------- #
def star_tree(root: Coord, participants: Iterable[Coord]) -> CollectiveTree:
    """The express package tree: every chip root is a direct child of the
    package root, each edge one dedicated express channel."""
    parts = frozenset(participants)
    parent = {p: root for p in sorted(parts) if p != root}
    tree = CollectiveTree(root=root, participants=parts | {root},
                          parent=parent, order="xy")
    tree.validate()
    return tree


def _express_reduce(prog: list, tree: CollectiveTree, payload_bits: float,
                    cfg: NocConfig, *, tag: str) -> int:
    """Express reduce without router support: every chip unicasts its
    operand over its own channel; the root PE folds arrivals."""
    flits = _payload_flits(cfg, payload_bits)
    words = _words(payload_bits)
    kids = sorted(tree.participants - {tree.root})
    deps = []
    for p in kids:
        prog.append(PacketOp(p, tree.root, flits, path=[p, tree.root],
                             tag=tag, contribs=frozenset({p})))
        deps.append(len(prog) - 1)
    prog.append(PacketOp(
        tree.root, tree.root, 0, inject=False, eject=False,
        pe_adds=len(deps) * words, deps=tuple(deps),
        delay=cfg.pe_add_cycles, tag=tag + ":root",
        contribs=frozenset(tree.participants), delivers=(tree.root,)))
    return len(prog) - 1


def _express_multicast(prog: list, tree: CollectiveTree,
                       payload_bits: float, cfg: NocConfig, *, tag: str,
                       contribs: frozenset, deps: tuple) -> list:
    """Express multicast without router support: one unicast per channel."""
    flits = _payload_flits(cfg, payload_bits)
    out = []
    for p in sorted(tree.participants - {tree.root}):
        prog.append(PacketOp(tree.root, p, flits, path=[tree.root, p],
                             deps=deps, tag=tag, contribs=contribs,
                             delivers=(p,)))
        out.append(len(prog) - 1)
    return out


def _package_program(op: str, chips: list[Coord], payload_bits: float,
                     pkg_cfg: NocConfig, root: Coord, *, express: bool,
                     algorithm: str, semantics: str) -> list[PacketOp]:
    """The package-level lane: a flat collective over chip-grid coords."""
    if not express:
        return plan_collective(op, chips, payload_bits, pkg_cfg, root=root,
                               algorithm=algorithm, semantics=semantics)
    tree = star_tree(root, chips)
    prog: list[PacketOp] = []
    if op == "reduce":
        if semantics == "ina":
            _plan_reduce_ina(prog, tree, payload_bits, pkg_cfg, vc=0,
                             chunk=0, tag="reduce")
        else:
            _express_reduce(prog, tree, payload_bits, pkg_cfg, tag="reduce")
        return prog
    if op == "broadcast":
        if semantics == "ina":
            _plan_multicast_ina(prog, tree, payload_bits, pkg_cfg, vc=0,
                                chunk=0, tag="bcast",
                                contribs=frozenset({root}), deps=())
        else:
            _express_multicast(prog, tree, payload_bits, pkg_cfg,
                               tag="bcast", contribs=frozenset({root}),
                               deps=())
        return prog
    # allreduce over the star: reduce to the package root, multicast back
    # (the star has no ring to scatter over: rs_ag degenerates to this).
    parts = frozenset(chips)
    if semantics == "ina":
        final = _plan_reduce_ina(prog, tree, payload_bits, pkg_cfg, vc=0,
                                 chunk=0, tag="ar:reduce")
        _plan_multicast_ina(prog, tree, payload_bits, pkg_cfg, vc=0,
                            chunk=0, tag="ar:bcast", contribs=parts,
                            deps=(final,))
    else:
        final = _express_reduce(prog, tree, payload_bits, pkg_cfg,
                                tag="ar:reduce")
        _express_multicast(prog, tree, payload_bits, pkg_cfg,
                           tag="ar:bcast", contribs=parts, deps=(final,))
    return prog


# --------------------------------------------------------------------------- #
# the hierarchical planner
# --------------------------------------------------------------------------- #
def plan_hier_collective(op: str, hmesh: HierarchicalMesh,
                         payload_bits: float,
                         cfg: NocConfig = NocConfig(), *,
                         participants: Optional[Iterable[HierCoord]] = None,
                         root: Optional[HierCoord] = None,
                         algorithm: str = "reduce_bcast",
                         semantics: str = "ina",
                         ) -> HierarchicalSchedule:
    """Lower a collective over ``(chip, x, y)`` participants into levels.

    ``participants`` defaults to every PE of the hierarchy; ``root``
    defaults to the first participant.  With all participants on one chip
    the result is a single ``"flat"`` level carrying exactly the flat
    ``plan_collective`` program.
    """
    assert op in HIER_OPS, op
    assert semantics in SEMANTICS, semantics
    assert algorithm in ALLREDUCE_ALGORITHMS, algorithm
    parts = sorted(set(participants)) if participants is not None \
        else sorted(hmesh.nodes())
    assert parts, "empty participant set"
    root = parts[0] if root is None else root
    assert root in parts, f"root {root} is not a participant"
    by_chip = group_by_chip(parts)
    chip_cfg = hmesh.chip_cfg(cfg)

    def sched(levels):
        return HierarchicalSchedule(hmesh=hmesh, op=op, semantics=semantics,
                                    algorithm=algorithm,
                                    payload_bits=float(payload_bits),
                                    levels=tuple(levels))

    if len(by_chip) == 1:
        chip, xy = next(iter(by_chip.items()))
        prog = plan_collective(op, xy, payload_bits, chip_cfg,
                               root=(root[1], root[2]),
                               algorithm=algorithm, semantics=semantics)
        lane = HierLane(label=f"chip{chip}", scope="chip", cfg=chip_cfg,
                        prog=tuple(prog), chip=chip)
        return sched([HierLevel(name="flat", lanes=(lane,))])

    pkg_cfg = hmesh.package_cfg(cfg)
    express = hmesh.package == "express"
    root_chip = root[0]
    chip_coords = sorted(hmesh.chip_coord(c) for c in by_chip)
    rxy = hmesh.chip_root_xy

    def chip_lanes(cop: str, tag_chips) -> tuple:
        lanes = []
        for chip in tag_chips:
            prog = plan_collective(cop, by_chip[chip], payload_bits,
                                   chip_cfg, root=rxy, semantics=semantics)
            lanes.append(HierLane(label=f"chip{chip}", scope="chip",
                                  cfg=chip_cfg, prog=tuple(prog), chip=chip))
        return tuple(lanes)

    def package_lane(pop: str) -> HierLane:
        prog = _package_program(pop, chip_coords, payload_bits, pkg_cfg,
                                hmesh.chip_coord(root_chip),
                                express=express, algorithm=algorithm,
                                semantics=semantics)
        return HierLane(label="package", scope="package", cfg=pkg_cfg,
                        prog=tuple(prog))

    chips = sorted(by_chip)
    if op == "reduce":
        return sched([
            HierLevel("intra-reduce", chip_lanes("reduce", chips)),
            HierLevel("package", (package_lane("reduce"),)),
        ])
    if op == "broadcast":
        return sched([
            HierLevel("package", (package_lane("broadcast"),)),
            HierLevel("intra-bcast", chip_lanes("broadcast", chips)),
        ])
    return sched([                           # allreduce
        HierLevel("intra-reduce", chip_lanes("reduce", chips)),
        HierLevel("package", (package_lane("allreduce"),)),
        HierLevel("intra-bcast", chip_lanes("broadcast", chips)),
    ])


def flat_hier_schedule(hmesh: HierarchicalMesh, prog: Iterable[PacketOp],
                       cfg: NocConfig = NocConfig(), *,
                       chip: int = 0, op: str = "flat") -> HierarchicalSchedule:
    """Wrap an arbitrary flat program (e.g. a WS round program) as a
    single-level hierarchical schedule on one chip."""
    lane = HierLane(label=f"chip{chip}", scope="chip",
                    cfg=hmesh.chip_cfg(cfg), prog=tuple(prog), chip=chip)
    return HierarchicalSchedule(hmesh=hmesh, op=op, semantics="ina",
                                algorithm="reduce_bcast", payload_bits=0.0,
                                levels=(HierLevel("flat", (lane,)),))


# --------------------------------------------------------------------------- #
# replay
# --------------------------------------------------------------------------- #
def run_hier_schedule(sched: HierarchicalSchedule) -> HierResult:
    """Replay every lane on its own simulator; levels serialize, lanes
    within a level overlap (disjoint networks).  Energy is priced per lane
    under that lane's config: package links may cost differently than
    on-die wires."""
    total = 0
    energy = 0.0
    combined = EnergyLedger()
    level_latency: dict = {}
    for level in sched.levels:
        worst = 0
        for lane in level.lanes:
            res = run_program(list(lane.prog), lane.cfg)
            worst = max(worst, res.latency_cycles)
            energy += res.ledger.network_energy_pj(lane.cfg)
            combined.add(res.ledger)
        level_latency[level.name] = worst
        total += worst
    return HierResult(latency_cycles=total, energy_pj=energy,
                      ledger=combined, level_latency=level_latency)
