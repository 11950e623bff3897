"""Seeded fault model + deadlock-safe detour routing + tree repair.

A :class:`FaultModel` is a frozen, hashable description of a mesh's broken
hardware: permanently failed *links* (undirected — both directions die),
failed *routers* (the node cannot forward, and its PE is unreachable),
failed *PEs* (the router still forwards, the local core is dead), and
*transient* per-window link faults (``(window, link)`` pairs a caller folds
in with :meth:`FaultModel.at_window` before planning).  Instances come from
:func:`seeded_faults` — one ``random.Random(seed)`` stream, so the same
seed always yields the same fault set ("same seed, same bytes", the
serving-layer contract).

Routing around faults uses the **west-first turn model**: every westward
(-x) hop must precede all other hops, which prohibits the N->W / S->W
turns and makes any set of such routes deadlock-free by the Dally/Seitz
channel-dependency argument (:func:`repro_torch.analysis.verify.
verify_faulted` re-proves this on every faulted corpus shape).  Plain XY routes are
west-first-legal, so a clean XY path is always preferred and an empty
fault model degenerates to the exact memoized XY machinery: bit-identical
routes, cache keys and all.

Fault-aware routes are memoized in :data:`~.topology._ROUTE_CACHE` under
``(src, dst, rule, fault_key)``: a fault set can never serve another fault
set's (or the clean mesh's) entries.

This module is a copy of ``repro.core.noc.faults``: every iteration order
and ``sorted(...)`` is the reference's, so detour paths and repaired trees
equal the reference's hop for hop.

Collective *tree repair* rebuilds reduce/multicast trees over the healthy
fabric: a single BFS from the root assigns every reachable node one parent
such that each node's full path to (reduce) or from (multicast) the root
is west-first legal by induction; the tree is then pruned to the union of
the participants' root paths, so every leaf is a participant.  Dead PEs
are excluded from the participant set and their contributions *remapped*
to the nearest healthy participant (:func:`remap_participants`) — the
fold-exactly-once algebra then runs over the healthy set.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, Optional

from .topology import memo_route, xy_route_tuple

Coord = tuple[int, int]
Link = tuple[Coord, Coord]

#: West — the direction the turn model restricts.
_W = (-1, 0)
#: Deterministic neighbor-expansion order: W, E, N(-y), S(+y).
_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))


class UnroutableError(RuntimeError):
    """No west-first-legal fault-free path exists under this fault set."""


def _norm_link(a: Coord, b: Coord) -> Link:
    return (a, b) if a <= b else (b, a)


def mesh_links(width: int, height: int) -> list[Link]:
    """Every undirected mesh link, in deterministic scan order."""
    out: list[Link] = []
    for y in range(height):
        for x in range(width):
            if x + 1 < width:
                out.append(((x, y), (x + 1, y)))
            if y + 1 < height:
                out.append(((x, y), (x, y + 1)))
    return out


@dataclass(frozen=True)
class FaultModel:
    """Immutable fault set.  Hashable — joins sim-cache keys directly."""

    links: frozenset = frozenset()     # undirected, normalized (a <= b)
    routers: frozenset = frozenset()   # failed routers (PE dies with it)
    pes: frozenset = frozenset()       # failed PEs (router still forwards)
    transient: tuple = ()              # sorted ((window, link), ...)
    seed: Optional[int] = None         # provenance only (reporting)

    def __post_init__(self):
        object.__setattr__(self, "links", frozenset(
            _norm_link(a, b) for a, b in self.links))
        object.__setattr__(self, "routers", frozenset(self.routers))
        object.__setattr__(self, "pes", frozenset(self.pes))
        object.__setattr__(self, "transient", tuple(sorted(
            (int(w), _norm_link(a, b)) for w, (a, b) in self.transient)))

    # ------------------------------------------------------------------ #
    @property
    def empty(self) -> bool:
        return not (self.links or self.routers or self.pes or self.transient)

    def key(self) -> tuple:
        """Canonical sorted signature — the route/sim cache key component."""
        return (tuple(sorted(self.links)), tuple(sorted(self.routers)),
                tuple(sorted(self.pes)), self.transient)

    def link_ok(self, a: Coord, b: Coord) -> bool:
        return _norm_link(a, b) not in self.links

    def router_ok(self, n: Coord) -> bool:
        return n not in self.routers

    def pe_ok(self, n: Coord) -> bool:
        """A live PE needs both its core and its router."""
        return n not in self.pes and n not in self.routers

    def at_window(self, window: int) -> "FaultModel":
        """Permanent faults plus this window's transient link outages,
        as a transient-free model (what planners accept)."""
        if not self.transient:
            return self
        extra = frozenset(l for w, l in self.transient if w == window)
        return FaultModel(links=self.links | extra, routers=self.routers,
                          pes=self.pes, transient=(), seed=self.seed)

    def path_clear(self, path: Iterable[Coord]) -> bool:
        """True iff every router and link along ``path`` is healthy."""
        path = list(path)
        return (all(self.router_ok(v) for v in path)
                and all(self.link_ok(a, b)
                        for a, b in zip(path[:-1], path[1:])))


#: The canonical clean mesh (``detour_route`` degenerates to XY on it).
EMPTY_FAULTS = FaultModel()


def seeded_faults(width: int, height: int, *, link_rate: float = 0.0,
                  router_rate: float = 0.0, pe_rate: float = 0.0,
                  transient_rate: float = 0.0, windows: int = 0,
                  seed: int = 0) -> FaultModel:
    """Deterministic fault set: one ``random.Random(seed)`` stream drawn in
    a fixed order (links, routers, PEs, then per-window transients)."""
    rng = random.Random(seed)
    all_links = mesh_links(width, height)
    nodes = [(x, y) for y in range(height) for x in range(width)]
    links = [l for l in all_links if rng.random() < link_rate]
    routers = [n for n in nodes if rng.random() < router_rate]
    pes = [n for n in nodes if rng.random() < pe_rate]
    transient = [(w, l) for w in range(windows) for l in all_links
                 if rng.random() < transient_rate]
    return FaultModel(links=frozenset(links), routers=frozenset(routers),
                      pes=frozenset(pes), transient=tuple(transient),
                      seed=seed)


# --------------------------------------------------------------------------- #
# west-first turn model
# --------------------------------------------------------------------------- #
def allowed_turn(d1: Coord, d2: Coord) -> bool:
    """West-first legality of consecutive hop directions: no U-turns, and
    a west hop may only follow a west hop (all W hops come first)."""
    if d2 == (-d1[0], -d1[1]):
        return False
    return d2 != _W or d1 == _W


def path_is_west_first(path: Iterable[Coord]) -> bool:
    """True iff ``path`` uses unit mesh steps whose turn sequence the
    west-first model allows (XY paths always qualify)."""
    path = list(path)
    dirs = [(b[0] - a[0], b[1] - a[1])
            for a, b in zip(path[:-1], path[1:])]
    if any(d not in _DIRS for d in dirs):
        return False
    return all(allowed_turn(d1, d2) for d1, d2 in zip(dirs, dirs[1:]))


# --------------------------------------------------------------------------- #
# up*/down* routing (the any-connected-fault-pattern fallback)
# --------------------------------------------------------------------------- #
#: The detour rules, in the order the planner tries them.  West-first is
#: only *partially* adaptive (a destination whose westward corridor is cut
#: can become unreachable — all W hops must come first); up*/down* routes
#: any connected healthy fabric at the price of non-minimal paths.  A
#: program never mixes rules: the deadlock argument holds per rule, and
#: the union of one program's paths must follow a single relation.
DETOUR_RULES = ("west_first", "updown")


@lru_cache(maxsize=256)
def updown_keys(faults: FaultModel, width: int,
                height: int) -> dict[Coord, tuple[int, int]]:
    """Up*/down* link orientation: BFS spanning tree of the healthy fabric
    from the first healthy node in scan order; each node's key is
    ``(bfs_level, scan_id)`` and a hop is *up* iff it moves to a strictly
    smaller key.  Channel dependencies then order strictly (up hops
    decrease the key, down hops increase it, down never precedes up), so
    any route set under one key map is deadlock-free — the Autonet
    argument, re-proved per corpus shape by the CDG checker."""
    nodes = [(x, y) for y in range(height) for x in range(width)
             if faults.router_ok((x, y))]
    if not nodes:
        raise UnroutableError("every router failed")
    root = min(nodes, key=lambda n: (n[1], n[0]))
    level = {root: 0}
    frontier = [root]
    while frontier:
        nxt = []
        for v in frontier:
            for delta in _DIRS:
                u = (v[0] + delta[0], v[1] + delta[1])
                if not (0 <= u[0] < width and 0 <= u[1] < height):
                    continue
                if u in level or not faults.router_ok(u) \
                        or not faults.link_ok(u, v):
                    continue
                level[u] = level[v] + 1
                nxt.append(u)
        frontier = nxt
    return {n: (lvl, n[1] * width + n[0]) for n, lvl in level.items()}


def path_is_updown(path: Iterable[Coord], faults: FaultModel,
                   width: int, height: int) -> bool:
    """True iff ``path`` is up*/down*-legal under this fault set's
    canonical key map: unit steps, every hop up until the first down hop,
    only down hops after it."""
    path = list(path)
    keys = updown_keys(faults, width, height)
    if any(v not in keys for v in path):
        return False
    down = False
    for a, b in zip(path[:-1], path[1:]):
        if (b[0] - a[0], b[1] - a[1]) not in _DIRS:
            return False
        if keys[b] < keys[a]:            # up hop
            if down:
                return False
        else:
            down = True
    return True


# --------------------------------------------------------------------------- #
# detour routing
# --------------------------------------------------------------------------- #
def detour_route(src: Coord, dst: Coord, faults: FaultModel,
                 width: int, height: int,
                 rule: str = "west_first") -> tuple[Coord, ...]:
    """Shortest ``rule``-legal fault-free route (memoized per fault set).

    Under ``"west_first"`` clean XY paths are preferred (minimal
    perturbation); an empty fault model returns the exact memoized XY
    entry — same cache key, same tuple.  Raises
    :class:`UnroutableError` when the rule cannot reach ``dst``.
    """
    if faults.empty:
        return xy_route_tuple(src, dst)
    if faults.transient:
        raise ValueError("resolve transient faults with "
                         "FaultModel.at_window() before routing")
    assert rule in DETOUR_RULES, rule
    return memo_route(
        (src, dst, rule, faults.key()),
        lambda: _derive_detour(src, dst, faults, width, height, rule))


def _state_bfs(src: Coord, dst: Coord, start_state, step) -> tuple:
    """Deterministic shortest-path BFS over (node, state) pairs.  ``step``
    yields legal successor states; the first goal state found at the
    shallowest level (fixed expansion order) wins."""
    start = (src, start_state)
    parent: dict = {start: None}
    frontier = [start]
    goal = None
    while frontier and goal is None:
        nxt = []
        for state in frontier:
            for ns in step(state):
                if ns in parent:
                    continue
                parent[ns] = state
                if ns[0] == dst:
                    goal = ns
                    break
                nxt.append(ns)
            if goal is not None:
                break
        frontier = nxt
    if goal is None:
        return ()
    path = []
    s = goal
    while s is not None:
        path.append(s[0])
        s = parent[s]
    return tuple(reversed(path))


def _derive_detour(src: Coord, dst: Coord, faults: FaultModel,
                   width: int, height: int, rule: str) -> tuple[Coord, ...]:
    if not faults.router_ok(src) or not faults.router_ok(dst):
        raise UnroutableError(f"failed router at endpoint of {src}->{dst}")
    if src == dst:
        return (src,)
    xy = xy_route_tuple(src, dst)
    if rule == "west_first" and faults.path_clear(xy):
        return xy                         # XY is west-first-legal

    def in_mesh(v):
        return 0 <= v[0] < width and 0 <= v[1] < height

    if rule == "west_first":
        def step(state):
            (x, y), d = state
            for nd in _DIRS:
                if d is not None and not allowed_turn(d, nd):
                    continue
                v = (x + nd[0], y + nd[1])
                if in_mesh(v) and faults.router_ok(v) \
                        and faults.link_ok((x, y), v):
                    yield (v, nd)
        path = _state_bfs(src, dst, None, step)
    else:
        keys = updown_keys(faults, width, height)
        if src not in keys or dst not in keys:
            raise UnroutableError(
                f"{src}->{dst} disconnected from the healthy fabric")

        def step(state):
            (x, y), down = state
            for nd in _DIRS:
                v = (x + nd[0], y + nd[1])
                if not in_mesh(v) or v not in keys \
                        or not faults.link_ok((x, y), v):
                    continue
                up = keys[v] < keys[(x, y)]
                if up and down:
                    continue              # never up after down
                yield (v, down or not up)
        path = _state_bfs(src, dst, False, step)
    if not path:
        raise UnroutableError(
            f"no {rule} path {src}->{dst} under {len(faults.links)} "
            f"link / {len(faults.routers)} router faults")
    return path


# --------------------------------------------------------------------------- #
# collective tree repair
# --------------------------------------------------------------------------- #
def _neighbors(v: Coord, faults: FaultModel,
               width: int, height: int) -> list[Coord]:
    """Healthy-linked in-mesh neighbors of ``v`` in deterministic order."""
    out = []
    for delta in _DIRS:
        u = (v[0] + delta[0], v[1] + delta[1])
        if (0 <= u[0] < width and 0 <= u[1] < height
                and faults.router_ok(u) and faults.link_ok(u, v)):
            out.append(u)
    return out


def _west_first_parents(root: Coord, faults: FaultModel,
                        width: int, height: int,
                        toward_root: bool) -> dict[Coord, Coord]:
    """Greedy BFS parent assignment keeping every root path west-first
    legal in the packet-flow direction.  Greedy state-claiming can strand
    nodes a different parent choice would reach — on top of the turn
    model's own partial adaptivity — so callers fall back to the updown
    rule on failure."""
    parent: dict[Coord, Coord] = {}
    # hop direction adjacent to v on its root path (toward-root: v's
    # outgoing hop; multicast: the hop into v).
    state: dict[Coord, Optional[Coord]] = {root: None}
    frontier = [root]
    while frontier:
        nxt = []
        for v in frontier:
            for u in _neighbors(v, faults, width, height):
                if u in state:
                    continue
                delta = (u[0] - v[0], u[1] - v[1])
                prev = state[v]
                if toward_root:
                    hd = (-delta[0], -delta[1])       # packet hop u -> v
                    if prev is not None and not allowed_turn(hd, prev):
                        continue
                else:
                    hd = delta                        # packet hop v -> u
                    if prev is not None and not allowed_turn(prev, hd):
                        continue
                state[u] = hd
                parent[u] = v
                nxt.append(u)
        frontier = nxt
    return parent


def _updown_parents(root: Coord, faults: FaultModel,
                    width: int, height: int) -> dict[Coord, Coord]:
    """Two-phase parent assignment spanning the whole healthy connected
    component with up*/down*-legal root paths.

    Phase 1 grows the monotone region: children whose hop to their parent
    *increases* the updown key (so the leaf->root suffix below them is all
    downs).  Phase 2 extends it with key-*decreasing* attachments — an up
    hop composes with any legal path, in either flow direction, because
    reversing an ups-then-downs walk flips every hop and yields another
    ups-then-downs walk.  The same tree is therefore legal for reduce
    (leaf->root) and multicast (root->leaf), and phase 1 + phase 2
    together reach every node the updown spanning tree connects (up the
    BFS tree to its root, down to anywhere).
    """
    keys = updown_keys(faults, width, height)
    if root not in keys:
        raise UnroutableError(f"tree root {root} disconnected")
    parent: dict[Coord, Coord] = {}
    attached = {root}
    frontier = [root]
    while frontier:                       # phase 1: key-increasing chains
        nxt = []
        for v in frontier:
            for u in _neighbors(v, faults, width, height):
                if u in attached or u not in keys or keys[u] >= keys[v]:
                    continue
                attached.add(u)
                parent[u] = v
                nxt.append(u)
        frontier = nxt
    frontier = sorted(attached)           # phase 2: key-decreasing hops
    while frontier:
        nxt = []
        for v in frontier:
            for u in _neighbors(v, faults, width, height):
                if u in attached or u not in keys or keys[u] <= keys[v]:
                    continue
                attached.add(u)
                parent[u] = v
                nxt.append(u)
        frontier = nxt
    return parent


def _repair_tree(root: Coord, participants: Iterable[Coord],
                 faults: FaultModel, width: int, height: int, *,
                 toward_root: bool, rule: str = "west_first"):
    """BFS from the root over the healthy fabric assigning each node one
    parent such that every node's root path is ``rule``-legal in the
    packet-flow direction (leaf->root for reduce, root->leaf for
    multicast); pruned to the participants' root paths.

    Legality is inductive on the parent chain, so every tree *segment*
    (a contiguous subpath of some member's root path) inherits it — the
    property the per-segment INA packets need.
    """
    from .collective.trees import CollectiveTree
    assert rule in DETOUR_RULES, rule
    parts = frozenset(participants)
    if not faults.router_ok(root):
        raise UnroutableError(f"tree root {root} has a failed router")
    if rule == "updown":
        parent = _updown_parents(root, faults, width, height)
    else:
        parent = _west_first_parents(root, faults, width, height,
                                     toward_root)
    keep = {root}
    for p in sorted(parts):
        v = p
        chain = []
        while v not in keep:
            if v != root and v not in parent:
                raise UnroutableError(
                    f"participant {p} unreachable from root {root} "
                    f"under the {rule} rule")
            chain.append(v)
            v = parent[v]
        keep.update(chain)
    pruned = {u: parent[u] for u in sorted(keep) if u != root}
    tree = CollectiveTree(root=root, participants=parts, parent=pruned,
                          order="xy")
    tree.validate()
    return tree


def repair_reduction_tree(root: Coord, participants: Iterable[Coord],
                          faults: FaultModel, width: int, height: int,
                          rule: str = "west_first"):
    """Fault-avoiding reduction tree (packets flow leaf -> root)."""
    return _repair_tree(root, participants, faults, width, height,
                        toward_root=True, rule=rule)


def repair_multicast_tree(root: Coord, participants: Iterable[Coord],
                          faults: FaultModel, width: int, height: int,
                          rule: str = "west_first"):
    """Fault-avoiding multicast tree (packets flow root -> leaf)."""
    return _repair_tree(root, participants, faults, width, height,
                        toward_root=False, rule=rule)


# --------------------------------------------------------------------------- #
# participant remapping (dead PEs hand their shard to a healthy neighbor)
# --------------------------------------------------------------------------- #
def remap_participants(participants: Iterable[Coord], faults: FaultModel,
                       width: Optional[int] = None,
                       height: Optional[int] = None,
                       ) -> tuple[list[Coord], dict[Coord, Coord]]:
    """``(usable participants sorted, {dead -> nearest usable})``.

    A participant is usable when its PE survives *and* (given the mesh
    shape) its router sits in the fabric's main connected component — a
    healthy PE whose links all failed is as stranded as a dead one.  The
    nearest usable participant (Manhattan distance, coordinate tie-break)
    takes over each dead participant's operand — it holds or recomputes
    the shard, so the collective's algebra closes over the usable set
    exactly once per original contribution owner.
    """
    parts = sorted(set(participants))
    if width is not None and height is not None:
        keys = updown_keys(faults, width, height)
        usable = lambda p: faults.pe_ok(p) and p in keys
    else:
        usable = faults.pe_ok
    healthy = [p for p in parts if usable(p)]
    if not healthy:
        raise UnroutableError("no healthy participants left")
    mapping: dict[Coord, Coord] = {}
    for dead in parts:
        if usable(dead):
            continue
        mapping[dead] = min(
            healthy,
            key=lambda h: (abs(h[0] - dead[0]) + abs(h[1] - dead[1]), h))
    return healthy, mapping


def remap_root(root: Coord, healthy: list[Coord],
               faults: FaultModel) -> Coord:
    """The collective root after faults: unchanged when it survives as a
    usable participant, otherwise the nearest healthy participant
    (deterministic)."""
    if root in healthy:
        return root
    return min(healthy,
               key=lambda h: (abs(h[0] - root[0]) + abs(h[1] - root[1]), h))
