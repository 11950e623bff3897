"""Reduction / multicast trees over the 2D mesh (dimension-ordered).

A collective on a mesh NoC is shaped by a *tree* embedded in the topology:
reduce flows leaf->root, multicast/broadcast root->leaf, gather leaf->root
without combining.  With deterministic dimension-ordered routing the union
of the per-participant routes is always a tree:

* **reduction tree** — every participant routes to the root with XY (or YX)
  routing; because the next hop toward a fixed destination is a function of
  the current node only, each node has a unique parent.
* **multicast tree** — the root routes to every participant; paths from a
  single source under deterministic routing share prefixes and never rejoin
  after diverging.

Mesh nodes that lie on a route but are not participants become pure
forwarders (they relay/merge but contribute no operand).  The paper's WS
gather chain is the special case of a single-column participant set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..topology import route

Coord = tuple[int, int]


@dataclass(frozen=True)
class CollectiveTree:
    """A routing tree over the mesh.

    ``parent`` maps every non-root tree node to its next hop toward the
    root; for a multicast tree the data flows against these edges.  The
    structure is shared by both directions — the scheduler decides flow.
    """

    root: Coord
    participants: frozenset[Coord]
    parent: dict[Coord, Coord] = field(hash=False)
    order: str = "xy"

    @property
    def nodes(self) -> frozenset[Coord]:
        return frozenset(self.parent) | {self.root}

    def children(self) -> dict[Coord, list[Coord]]:
        """Child lists (deterministic order: sorted by coordinate)."""
        out: dict[Coord, list[Coord]] = {v: [] for v in sorted(self.nodes)}
        for child, par in sorted(self.parent.items()):
            out[par].append(child)
        return out

    def leaves(self) -> list[Coord]:
        ch = self.children()
        return sorted(v for v in self.nodes if not ch[v])

    def depth(self, v: Coord) -> int:
        d = 0
        while v != self.root:
            v = self.parent[v]
            d += 1
        return d

    def path_to_root(self, v: Coord) -> list[Coord]:
        out = [v]
        while v != self.root:
            v = self.parent[v]
            out.append(v)
        return out

    def validate(self) -> None:
        """Tree invariants: connected, acyclic, participants covered."""
        nodes = self.nodes
        assert self.root in nodes
        assert self.root not in self.parent, "root must have no parent"
        for p in sorted(self.participants):
            assert p in nodes, f"participant {p} not reached"
        for v in self.parent:
            seen = {v}
            w = v
            while w != self.root:
                w = self.parent[w]
                assert w not in seen, f"cycle through {w}"
                seen.add(w)
        assert len(self.parent) == len(nodes) - 1


def _build(root: Coord, participants: Iterable[Coord], order: str,
           toward_root: bool) -> CollectiveTree:
    parts = frozenset(participants)
    parent: dict[Coord, Coord] = {}
    for p in sorted(parts):
        if p == root:
            continue
        # Route orientation decides the embedding: reduce uses each
        # participant's own route to the root (merging corridors), multicast
        # uses the root's route to each participant (forking corridors).
        path = route(p, root, order) if toward_root else \
            list(reversed(route(root, p, order)))
        for child, par in zip(path[:-1], path[1:]):
            prev = parent.setdefault(child, par)
            if prev != par:
                raise AssertionError(
                    f"routing produced two parents for {child}: {prev}, {par}")
    tree = CollectiveTree(root=root, participants=parts, parent=parent,
                          order=order)
    tree.validate()
    return tree


def reduction_tree(root: Coord, participants: Iterable[Coord],
                   order: str = "xy") -> CollectiveTree:
    """Dimension-ordered reduction tree: participants route *to* the root."""
    return _build(root, participants, order, toward_root=True)


def multicast_tree(root: Coord, participants: Iterable[Coord],
                   order: str = "xy") -> CollectiveTree:
    """Dimension-ordered multicast tree: the root routes to each participant."""
    return _build(root, participants, order, toward_root=False)


# --------------------------------------------------------------------------- #
# Participant-set helpers (DSE sweeps use these)
# --------------------------------------------------------------------------- #
def full_mesh(n: int) -> list[Coord]:
    return [(x, y) for y in range(n) for x in range(n)]


def mesh_row(n: int, y: int) -> list[Coord]:
    return [(x, y) for x in range(n)]


def mesh_column(n: int, x: int) -> list[Coord]:
    return [(x, y) for y in range(n)]


def segments(tree: CollectiveTree) -> list[list[Coord]]:
    """Maximal non-branching paths of the tree, listed in leaf->root node
    order.  Collective packets travel one segment at a time: they are
    combined (reduce/gather) or forked (multicast) at segment boundaries,
    which are exactly the merge nodes (>= 2 children) and the root.

    Every leaf and every merge node heads exactly one segment; a segment
    runs toward the root until the next merge node or the root (inclusive).
    """
    ch = tree.children()
    breaks = {v for v, c in ch.items() if len(c) >= 2}
    heads = (set(tree.leaves()) | breaks) - {tree.root}
    segs = []
    for h in sorted(heads):
        seg = [h]
        v = h
        while v != tree.root:
            v = tree.parent[v]
            seg.append(v)
            if v in breaks:
                break
        segs.append(seg)
    return segs
