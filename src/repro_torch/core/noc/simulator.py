"""Discrete-event wormhole mesh simulator with time-ordered link arbitration.

Each directed link (and each node's per-VC injection/ejection port) is a
resource with a busy-until time.  Packets are processed as events ordered by
ready time (a heap), so arbitration between flows happens in *time* order —
a late-issued gather packet cannot retroactively block an earlier relay
packet of the next round, matching real router behaviour.  A packet of
``flits`` flits holds each traversed link for ``flits`` cycles (wormhole
serialization); the head flit pays ``router_cycles + link_cycles`` per hop
plus contention wait; the tail arrives ``flits - 1`` cycles after the head.
The two VCs of the paper's Table III are modeled as separate injection/
ejection port resources (gather rides VC1, unicast/relay VC0).

Energy is counted per event into an :class:`EnergyLedger` (Orion-style):
router traversals (buffer write/read + crossbar) per flit per router
(links + 1 routers per path), links per flit per link, NI crossings per flit,
and packet (dis)assembly per endpoint.

Resource state is held in int-indexed flat arrays sized from the
:class:`NocConfig` mesh (4 directed links per node, ``2 * vcs`` ports per
node) rather than tuple-keyed dicts, and per-packet routes/link ids are
memoized per ``(width, height, src, dst)`` — ``enqueue`` no longer derives
a route or allocates per packet (DESIGN.md S10).  Coordinates outside the
configured mesh (or non-unit path steps) transparently fall back to a
keyed overflow dict, keeping the earlier "any coordinate" semantics.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

from .router import EnergyLedger, NocConfig
from .topology import route_links

Coord = tuple[int, int]

#: Direction codes for the 4 outgoing links of a node (E, W, S, N).
_DIRS = {(1, 0): 0, (-1, 0): 1, (0, 1): 2, (0, -1): 3}

#: Per-mesh-shape link-id memo: ``(width, height) -> {(src, dst) | path:
#: (link_ids, links)}``.  Keying per shape keeps a multi-chip
#: hierarchy sweep (many shapes alive at once: chip meshes, package grids)
#: from evicting the flat mesh's hot set, and gives per-shape derivation
#: stats the hierarchy regression tests assert on.  Each shape's table is
#: FIFO-bounded at :data:`LINK_ID_CACHE_MAX` entries.
_LINK_ID_CACHE: dict = {}

#: Per-shape observability: ``(width, height) -> {"derived", "evicted"}``.
LINK_ID_STATS: dict = {}

LINK_ID_CACHE_MAX = 1 << 15


def _shape_cache(width: int, height: int) -> dict:
    shape = (width, height)
    cache = _LINK_ID_CACHE.get(shape)
    if cache is None:
        cache = _LINK_ID_CACHE[shape] = {}
        LINK_ID_STATS.setdefault(shape, {"derived": 0, "evicted": 0})
    return cache


def _shape_put(width: int, height: int, cache: dict, key, value):
    stats = LINK_ID_STATS[(width, height)]
    stats["derived"] += 1
    cache[key] = value
    while len(cache) > LINK_ID_CACHE_MAX:
        del cache[next(iter(cache))]          # FIFO: dict keeps insert order
        stats["evicted"] += 1
    return value


def clear_link_caches() -> None:
    """Drop every shape's link-id table (stats are cumulative)."""
    _LINK_ID_CACHE.clear()


def encode_links_mixed(links, width: int, height: int) -> tuple:
    """Per-link encoding: the flat int id for in-mesh unit steps, the raw
    coord-pair key for anything else.  Encoding per *link* (not per
    packet) keeps contention exact when exotic and in-mesh packets share
    a physical link — the same link always resolves to the same resource
    slot, whichever packet traverses it."""
    out = []
    for link in links:
        (ax, ay), (bx, by) = link
        d = _DIRS.get((bx - ax, by - ay))
        if d is None or not (0 <= ax < width and 0 <= ay < height
                             and 0 <= bx < width and 0 <= by < height):
            out.append(link)
        else:
            out.append((ay * width + ax) * 4 + d)
    return tuple(out)


def route_link_ids(width: int, height: int, src: Coord, dst: Coord):
    """Memoized ``(link_ids, links)`` of the XY route on a W x H mesh;
    each link id is a flat index or an overflow key."""
    cache = _shape_cache(width, height)
    key = (src, dst)
    hit = cache.get(key)
    if hit is None:
        hit = _shape_put(width, height, cache, key,
                         _encode_entry(route_links(src, dst), width, height))
    return hit


def path_link_ids(width: int, height: int, path: tuple[Coord, ...]):
    """Memoized ``(link_ids, links)`` of a path override."""
    cache = _shape_cache(width, height)
    # Tagged key: a two-node override (src, dst) must not alias the XY
    # route entry for the same endpoints (express links are non-XY).
    key = ("path", path)
    hit = cache.get(key)
    if hit is None:
        hit = _shape_put(
            width, height, cache, key,
            _encode_entry(tuple(zip(path[:-1], path[1:])), width, height))
    return hit


def _encode_entry(links, width: int, height: int) -> tuple:
    return (encode_links_mixed(links, width, height), links)


def port_index(kind: int, vc: int, node: Coord, width: int, height: int,
               vcs: int) -> Optional[int]:
    """Flat index of an injection (kind 0) / ejection (kind 1) port.

    Returns None when the node/VC falls outside the configured mesh.
    """
    x, y = node
    if 0 <= x < width and 0 <= y < height and 0 <= vc < vcs:
        return (kind * vcs + vc) * (width * height) + y * width + x
    return None


def effective_vcs(cfg: NocConfig) -> int:
    """Port-array VC dimension (>= 2: gather always rides VC1)."""
    return max(cfg.vcs, 2)


def link_array_size(cfg: NocConfig) -> int:
    """4 directed links per node (E/W/S/N)."""
    return 4 * cfg.width * cfg.height


def port_array_size(cfg: NocConfig) -> int:
    """2 (inj/ej) x VCs ports per node."""
    return 2 * effective_vcs(cfg) * cfg.width * cfg.height


class _Packet:
    __slots__ = ("src", "dst", "flits", "vc", "inject", "eject",
                 "reduce_words", "on_hop", "on_done", "links", "link_ids",
                 "inj_port", "ej_port", "stage", "head")

    def __init__(self, src, dst, flits, vc, inject, eject, reduce_words,
                 on_hop, on_done):
        self.src = src
        self.dst = dst
        self.flits = flits
        self.vc = vc
        self.inject = inject
        self.eject = eject
        self.reduce_words = reduce_words
        self.on_hop = on_hop
        self.on_done = on_done
        self.links = ()
        self.link_ids: tuple = ()   # per link: flat int id or overflow key
        self.inj_port = None     # int index, or tuple key in the overflow dict
        self.ej_port = None
        self.stage = -1          # -1 = inject, 0..len(links)-1 = hop i, len = eject
        self.head = 0


class NocSim:
    """Event-driven simulator; create, enqueue packets, then ``run()``."""

    def __init__(self, cfg: NocConfig):
        self.cfg = cfg
        self._w, self._h = cfg.width, cfg.height
        self._nodes = self._w * self._h
        self._vcs = effective_vcs(cfg)
        #: Flat busy-until arrays: 4 directed links per node, 2 (inj/ej)
        #: x vcs ports per node.  See ``_overflow`` for out-of-mesh keys.
        self.link_free: list[int] = [0] * link_array_size(cfg)
        self.port_free: list[int] = [0] * port_array_size(cfg)
        self._overflow: dict = {}
        self.ledger = EnergyLedger()
        self._heap: list = []
        self._seq = itertools.count()
        self.now = 0

    # ------------------------------------------------------------------ #
    def _port_id(self, kind: int, vc: int, node: Coord):
        """Flat port index (kind 0 = inject, 1 = eject); tuple key when the
        node/VC falls outside the configured mesh (overflow dict)."""
        pid = port_index(kind, vc, node, self._w, self._h, self._vcs)
        if pid is not None:
            return pid
        return ("inj" if kind == 0 else "ej", vc, node)

    def enqueue(self, t: int, src: Coord, dst: Coord, flits: int, *,
                vc: int = 0, inject: bool = True, eject: bool = True,
                reduce_words: int = 0,
                on_hop: Optional[Callable[[Coord, int], None]] = None,
                on_done: Optional[Callable[[int], None]] = None,
                path: Optional[list] = None) -> None:
        """Schedule a packet to become ready at time ``t``.

        ``reduce_words`` is the generic in-network reduce count: the number
        of operand words folded into this packet by router ALUs along its
        path (the INA block of the paper, the gather/reduce units of
        collective-capable routers).  ``on_hop(node, t_head)`` fires as the
        head flit enters each traversed router — the collective engine uses
        it to timestamp in-passing payload deliveries (multicast drops).
        ``path`` overrides the XY route (must start at ``src`` and end at
        ``dst``).
        """
        pkt = _Packet(src, dst, flits, vc, inject, eject, reduce_words,
                      on_hop, on_done)
        if path is not None:
            pkt.link_ids, pkt.links = path_link_ids(self._w, self._h,
                                                    tuple(path))
        else:
            pkt.link_ids, pkt.links = route_link_ids(self._w, self._h,
                                                     src, dst)
        if inject:
            pkt.inj_port = self._port_id(0, vc, src)
        if eject:
            pkt.ej_port = self._port_id(1, vc, dst)
        pkt.stage = -1 if inject else 0
        pkt.head = t
        # Energy that is path-determined (independent of contention):
        n_links = len(pkt.links)
        self.ledger.flit_routers += flits * (n_links + 1)
        self.ledger.flit_links += flits * n_links
        self.ledger.packet_hops += n_links
        self.ledger.router_adds += reduce_words
        if inject:
            self.ledger.ni_flits += flits
            self.ledger.packets_built += 1
        if eject:
            self.ledger.ni_flits += flits
            self.ledger.packets_built += 1
        self._push(t, pkt)

    def _push(self, t: int, pkt: _Packet) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), pkt))

    # ------------------------------------------------------------------ #
    def run(self) -> int:
        """Process all events; returns the makespan (last completion time)."""
        cfg = self.cfg
        link_free = self.link_free
        port_free = self.port_free
        overflow = self._overflow
        makespan = 0
        while self._heap:
            t, _, pkt = heapq.heappop(self._heap)
            self.now = max(self.now, t)

            if pkt.stage == -1:                          # injection port
                pid = pkt.inj_port
                if type(pid) is int:
                    free = port_free[pid]
                else:
                    free = overflow.get(pid, 0)
                if free > t:
                    self._push(free, pkt)
                    continue
                if type(pid) is int:
                    port_free[pid] = t + pkt.flits
                else:
                    overflow[pid] = t + pkt.flits
                pkt.head = t + cfg.ni_cycles
                pkt.stage = 0
                self._push(pkt.head, pkt)
                continue

            if pkt.stage < len(pkt.links):               # link hop
                ready = pkt.head + cfg.router_cycles
                lid = pkt.link_ids[pkt.stage]
                flat = type(lid) is int
                free = link_free[lid] if flat else overflow.get(lid, 0)
                if free > ready:
                    pkt.head = free - cfg.router_cycles
                    self._push(free, pkt)
                    continue
                if flat:
                    link_free[lid] = ready + pkt.flits
                else:
                    overflow[lid] = ready + pkt.flits
                pkt.head = ready + cfg.link_cycles
                pkt.stage += 1
                if pkt.on_hop is not None:
                    pkt.on_hop(pkt.links[pkt.stage - 1][1], pkt.head)
                self._push(pkt.head, pkt)
                continue

            # ejection (or in-router completion when eject=False)
            if pkt.eject:
                pid = pkt.ej_port
                ready = pkt.head + cfg.router_cycles
                if type(pid) is int:
                    free = port_free[pid]
                else:
                    free = overflow.get(pid, 0)
                if free > ready:
                    pkt.head = free - cfg.router_cycles
                    self._push(free, pkt)
                    continue
                if type(pid) is int:
                    port_free[pid] = ready + pkt.flits
                else:
                    overflow[pid] = ready + pkt.flits
                done = ready + cfg.ni_cycles + pkt.flits - 1
            else:
                done = pkt.head + pkt.flits - 1
            makespan = max(makespan, done)
            if pkt.on_done is not None:
                pkt.on_done(done)
        return makespan

    # ------------------------------------------------------------------ #
    def chain_eject_inject(self, t: int, chain: list[Coord], flits: int,
                           on_done: Optional[Callable[[int], None]] = None,
                           ) -> None:
        """Fig. 4(a): psum relayed PE->PE, ejected/added/re-injected per stop.

        ``on_done(t)`` fires when the accumulated psum rests in the tail PE.
        """
        cfg = self.cfg
        hops = list(zip(chain[:-1], chain[1:]))

        def launch(i: int, t_ready: int) -> None:
            if i == len(hops):
                if on_done:
                    on_done(t_ready)
                return
            src, dst = hops[i]
            self.ledger.pe_adds += 1
            self.enqueue(t_ready, src, dst, flits, vc=0, inject=True,
                         eject=True,
                         on_done=lambda td: launch(i + 1, td + cfg.pe_add_cycles))

        launch(0, t)
