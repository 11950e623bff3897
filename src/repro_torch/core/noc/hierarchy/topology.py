"""Two-level mesh-of-meshes topology: chips of W x H PEs on a package grid
(a copy of ``repro.core.noc.hierarchy.topology``).

A :class:`HierarchicalMesh` joins ``chips_x * chips_y`` identical W x H PE
meshes through a package-level network.  Nodes are addressed ``(chip, x,
y)`` — ``chip`` is a flat index into the CX x CY chip grid, ``(x, y)`` the
PE coordinate inside that chip.  Cross-chip traffic enters and leaves a
chip only through its *chip root* PE (the NI that fronts the package
link), so every composed route is per-chip XY inside the endpoints' chips
plus package-level hops between chip roots.

Two package variants:

* ``"mesh"`` — the chips themselves form a CX x CY mesh with XY routing;
  the package network is an ordinary :class:`~repro_torch.core.noc.router.
  NocConfig` whose nodes are chips, so the whole collective stack (trees,
  schedules, the engine) applies unchanged at the package level.
* ``"express"`` — dedicated point-to-point express channels from every
  chip root to the package root chip (a star).  Express links are
  non-unit steps in the package plane; the heap engine models each as its
  own overflow-dict resource (dedicated channel, contention only at the
  shared root NI).

The package :class:`NocConfig` carries its own link timing
(``pkg_link_cycles``) and width (``pkg_flit_bits``): inter-chip links are
slower and often narrower than on-die wires (Guirado et al., PAPERS.md).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

from ..router import NocConfig
from ..topology import xy_route

Coord = tuple[int, int]
HierCoord = tuple[int, int, int]            # (chip, x, y)

PACKAGE_VARIANTS = ("mesh", "express")


@dataclass(frozen=True)
class HierarchicalMesh:
    """CX x CY chips, each a ``chip_w`` x ``chip_h`` PE mesh."""

    chip_w: int = 8
    chip_h: int = 8
    chips_x: int = 1
    chips_y: int = 1
    package: str = "mesh"
    #: Package-link timing/width relative to the on-die NocConfig; the
    #: defaults model a 4x slower, same-width interposer link.
    pkg_link_cycles: int = 4
    pkg_flit_bits: Optional[int] = None     # None = inherit the chip's

    def __post_init__(self):
        assert self.chip_w >= 1 and self.chip_h >= 1, "empty chip mesh"
        assert self.chips_x >= 1 and self.chips_y >= 1, "empty chip grid"
        assert self.package in PACKAGE_VARIANTS, self.package

    # ------------------------------------------------------------------ #
    # chip indexing
    # ------------------------------------------------------------------ #
    @property
    def num_chips(self) -> int:
        return self.chips_x * self.chips_y

    @property
    def num_pes(self) -> int:
        return self.num_chips * self.chip_w * self.chip_h

    def chip_coord(self, chip: int) -> Coord:
        """Chip-grid coordinate of a flat chip index."""
        assert 0 <= chip < self.num_chips, chip
        return chip % self.chips_x, chip // self.chips_x

    def chip_id(self, cx: int, cy: int) -> int:
        assert 0 <= cx < self.chips_x and 0 <= cy < self.chips_y, (cx, cy)
        return cy * self.chips_x + cx

    #: The PE fronting the package link: cross-chip traffic ejects from /
    #: injects into the package network here (fixed, deterministic).
    chip_root_xy: Coord = (0, 0)

    def chip_root(self, chip: int) -> HierCoord:
        return (chip, *self.chip_root_xy)

    def nodes(self) -> Iterator[HierCoord]:
        for chip in range(self.num_chips):
            for y in range(self.chip_h):
                for x in range(self.chip_w):
                    yield (chip, x, y)

    # ------------------------------------------------------------------ #
    # per-level NocConfigs
    # ------------------------------------------------------------------ #
    def chip_cfg(self, base: NocConfig = NocConfig()) -> NocConfig:
        """The on-die NocConfig of one chip (base timing/energy, chip shape).

        A 1-chip hierarchy whose chip shape equals ``base``'s mesh shape
        returns ``base`` itself — the degenerate-equivalence guarantee
        starts here (identical config hash, identical cache keys).
        """
        if (base.width, base.height) == (self.chip_w, self.chip_h):
            return base
        rows = None if self.chip_h == self.chip_w else self.chip_h
        return dataclasses.replace(base, n=self.chip_w, rows=rows)

    def package_cfg(self, base: NocConfig = NocConfig()) -> NocConfig:
        """The package-level NocConfig: nodes are chips, links are the
        inter-chip channels (slower/narrower per ``pkg_link_cycles`` /
        ``pkg_flit_bits``)."""
        rows = None if self.chips_y == self.chips_x else self.chips_y
        return dataclasses.replace(
            base, n=self.chips_x, rows=rows,
            link_cycles=self.pkg_link_cycles,
            flit_bits=self.pkg_flit_bits or base.flit_bits)

    # ------------------------------------------------------------------ #
    # composed routing
    # ------------------------------------------------------------------ #
    def route(self, src: HierCoord, dst: HierCoord) -> list[HierCoord]:
        """Composed route ``src -> dst``: per-chip XY inside the endpoint
        chips, package-level hops between chip roots in between.  Package
        hops are XY over the chip grid (``"mesh"``) or one direct express
        hop (``"express"``)."""
        (sc, sx, sy), (dc, dx, dy) = src, dst
        if sc == dc:
            return [(sc, x, y) for x, y in xy_route((sx, sy), (dx, dy))]
        rx, ry = self.chip_root_xy
        path = [(sc, x, y) for x, y in xy_route((sx, sy), (rx, ry))]
        if self.package == "express":
            hops = [self.chip_coord(sc), self.chip_coord(dc)]
        else:
            hops = xy_route(self.chip_coord(sc), self.chip_coord(dc))
        for cx, cy in hops[1:]:
            path.append((self.chip_id(cx, cy), rx, ry))
        path += [(dc, x, y) for x, y in xy_route((rx, ry), (dx, dy))[1:]]
        return path

    def is_package_hop(self, a: HierCoord, b: HierCoord) -> bool:
        """True when ``a -> b`` is a legal package-link traversal: both
        endpoints are chip roots of *different* chips that the package
        network actually joins."""
        if a[0] == b[0]:
            return False
        if (a[1], a[2]) != self.chip_root_xy or \
                (b[1], b[2]) != self.chip_root_xy:
            return False
        if self.package == "express":
            return True                      # dedicated any-to-any channels
        (ax, ay), (bx, by) = self.chip_coord(a[0]), self.chip_coord(b[0])
        return abs(ax - bx) + abs(ay - by) == 1

    def label(self) -> str:
        tag = "" if self.package == "mesh" else "e"
        return (f"{self.chips_x}x{self.chips_y}{tag}c"
                f"{self.chip_w}x{self.chip_h}")


def group_by_chip(participants) -> dict[int, list[Coord]]:
    """Split ``(chip, x, y)`` participants into per-chip ``(x, y)`` sets."""
    out: dict[int, list[Coord]] = {}
    for chip, x, y in sorted(set(participants)):
        out.setdefault(chip, []).append((x, y))
    return out
