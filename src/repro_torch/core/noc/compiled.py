"""Compiled packet programs: record a program once, replay it closure-free.

:func:`compile_program` lowers a list of
:class:`~repro_torch.core.noc.collective.schedule.PacketOp` into flat per-op
tuples — int link ids, port ids, dependency edges, and the op's static
energy contribution — and :meth:`CompiledProgram.run` replays them with a
single event loop that touches only local lists and ints.  This removes
everything the heap engine pays per run *per op*: closure allocation
(``on_done``/``on_hop`` lambdas), ``_Packet`` construction, route
derivation, and attribute chasing.

Replay is bit-identical to ``engine.run_program`` + ``NocSim.run`` by
construction:

* identical issue order (dependency-free ops in program order, children
  issued recursively inside completions) and identical heap tie-breaking
  (one monotone sequence number shared by first pushes and re-pushes);
* identical integer timing arithmetic per stage (inject port, per-link
  wormhole reservation, eject port);
* identical per-op ledger contributions applied at issue time in issue
  order (event counts are path-determined, never contention-determined).

``tests/test_torch_executors.py`` asserts latency *and* full-ledger
equality against the reference's heap engine across every fig7-12 plan
shape and collective corpus.  This module is a copy of
``repro.core.noc.compiled``; the port's ``route_link_ids`` /
``path_link_ids`` return ``(link_ids, links)``, and a route is encodable
here when every id is a flat int (:func:`_strict_ids`).

Programs whose coordinates fall outside the configured mesh (or whose
path overrides take non-unit steps) raise :class:`UncompilableProgram`;
callers fall back to the heap engine.  The module-level switch
(:func:`compiled_disabled`) forces the fallback everywhere — that is the
ground-truth mode benchmarks use to time the legacy path.
"""
from __future__ import annotations

from contextlib import contextmanager
from heapq import heappop, heappush
from typing import Sequence

from .router import EnergyLedger, NocConfig
from .simulator import (effective_vcs, link_array_size, path_link_ids,
                        port_array_size, port_index, route_link_ids)

#: Global switch: when False, ``run_program``/``_sim_rounds_window`` use the
#: heap engine even for compilable programs (ground-truth/reference mode).
_STATE = {"enabled": True}


def compiled_enabled() -> bool:
    return _STATE["enabled"]


@contextmanager
def compiled_disabled():
    """Force the closure-based heap engine (legacy/reference execution)."""
    prev = _STATE["enabled"]
    _STATE["enabled"] = False
    try:
        yield
    finally:
        _STATE["enabled"] = prev


class UncompilableProgram(ValueError):
    """The program uses features the flat executor cannot encode."""


def _strict_ids(ids: tuple):
    """``ids`` when every link is a flat in-mesh index, else None (an
    overflow key: a hop off the mesh or not a unit step)."""
    return ids if all(type(x) is int for x in ids) else None


class CompiledProgram:
    """One packet program lowered to flat arrays, replayable many times."""

    __slots__ = ("n", "ops", "children", "dep_count", "n_links", "n_ports",
                 "ni_cycles", "router_cycles", "link_cycles")

    def __init__(self, cfg: NocConfig):
        self.n = 0
        self.ops: list[tuple] = []
        self.children: list[tuple[int, ...]] = []
        self.dep_count: list[int] = []
        self.n_links = link_array_size(cfg)
        self.n_ports = port_array_size(cfg)
        self.ni_cycles = cfg.ni_cycles
        self.router_cycles = cfg.router_cycles
        self.link_cycles = cfg.link_cycles

    # ------------------------------------------------------------------ #
    def run(self, t0: int = 0) -> tuple[int, EnergyLedger, list, dict]:
        """Replay; returns ``(latency, ledger, done, delivered)``."""
        ops = self.ops
        children = self.children
        remaining = list(self.dep_count)
        n = self.n
        done: list = [None] * n
        link_free = [0] * self.n_links
        port_free = [0] * self.n_ports
        heap: list = []
        ni_cycles = self.ni_cycles
        router_cycles = self.router_cycles
        link_cycles = self.link_cycles
        # Per-run mutable packet state (parallel to ops).
        stage = [0] * n
        head = [0] * n
        delivered: dict = {}
        # Ledger accumulators (issue-order, see module docstring).
        acc = [0.0] * 7   # pe, ni, routers, links, hops, radds, pkts
        seq = 0

        def deliver(node, t: int) -> None:
            if node not in delivered or t < delivered[node]:
                delivered[node] = t

        def issue(i: int, t: int) -> None:
            nonlocal seq
            op = ops[i]
            # op = (t, delay, deps, virtual, flits, inject, eject, link_ids,
            #       inj_pid, ej_pid, hop_deliver, completion_delivers, energy)
            e = op[12]
            acc[0] += e[0]
            acc[1] += e[1]
            if op[3]:                          # virtual synchronisation op
                complete(i, t)
                return
            acc[2] += e[2]
            acc[3] += e[3]
            acc[4] += e[4]
            acc[5] += e[5]
            acc[6] += e[6]
            stage[i] = -1 if op[5] else 0
            head[i] = t
            heappush(heap, (t, seq, i))
            seq += 1

        def complete(i: int, td: int) -> None:
            done[i] = td
            op = ops[i]
            for node in op[11]:
                deliver(node, td)
            for j in children[i]:
                remaining[j] -= 1
                if remaining[j] == 0:
                    child = ops[j]
                    t = t0 + child[0]
                    for d in child[2]:
                        if done[d] > t:
                            t = done[d]
                    issue(j, t + child[1])

        for i, op in enumerate(ops):
            if not op[2]:
                issue(i, t0 + op[0])

        makespan = 0
        while heap:
            t, s, i = heappop(heap)
            op = ops[i]
            st = stage[i]
            flits = op[4]
            if st == -1:                                 # injection port
                pid = op[8]
                free = port_free[pid]
                if free > t:
                    heappush(heap, (free, seq, i))
                    seq += 1
                    continue
                port_free[pid] = t + flits
                head[i] = t + ni_cycles
                stage[i] = 0
                heappush(heap, (head[i], seq, i))
                seq += 1
                continue
            link_ids = op[7]
            if st < len(link_ids):                       # link hop
                lid = link_ids[st]
                ready = head[i] + router_cycles
                free = link_free[lid]
                if free > ready:
                    head[i] = free - router_cycles
                    heappush(heap, (free, seq, i))
                    seq += 1
                    continue
                link_free[lid] = ready + flits
                h = ready + link_cycles
                head[i] = h
                stage[i] = st + 1
                hop = op[10]
                if hop is not None:
                    node = hop[st]
                    if node is not None:
                        deliver(node, h + flits - 1)
                heappush(heap, (h, seq, i))
                seq += 1
                continue
            if op[6]:                                    # ejection port
                pid = op[9]
                ready = head[i] + router_cycles
                free = port_free[pid]
                if free > ready:
                    head[i] = free - router_cycles
                    heappush(heap, (free, seq, i))
                    seq += 1
                    continue
                port_free[pid] = ready + flits
                dt = ready + ni_cycles + flits - 1
            else:
                dt = head[i] + flits - 1
            if dt > makespan:
                makespan = dt
            complete(i, dt)

        stuck = [i for i, d in enumerate(done) if d is None]
        assert not stuck, f"deadlocked ops (circular/unmet deps): {stuck}"
        ledger = EnergyLedger(
            pe_adds=acc[0], ni_flits=acc[1], flit_routers=acc[2],
            flit_links=acc[3], packet_hops=acc[4], router_adds=acc[5],
            packets_built=acc[6])
        return max([makespan] + done), ledger, done, delivered

    # ------------------------------------------------------------------ #
    def replicate(self, k: int) -> "CompiledProgram":
        """The program repeated ``k`` times back-to-back (dep-shifted).

        Exactly equivalent to compiling the ``k``-fold concatenation:
        op order is preserved round-major, and dependency/children indices
        are offset per repetition.  Valid because the source program's
        dependencies are internal (guaranteed for ``ws_round_program``
        rounds, whose ops never reference another round) — this is what
        lets a :class:`~repro_torch.core.noc.traffic.CompiledWindow` be built
        from one compiled round instead of re-planning and re-compiling
        every distinct window length.
        """
        if k == 1:
            return self
        out = CompiledProgram.__new__(CompiledProgram)
        out.n_links = self.n_links
        out.n_ports = self.n_ports
        out.ni_cycles = self.ni_cycles
        out.router_cycles = self.router_cycles
        out.link_cycles = self.link_cycles
        n = self.n
        ops: list[tuple] = []
        children: list[tuple[int, ...]] = []
        for r in range(k):
            off = r * n
            if off == 0:
                ops.extend(self.ops)
                children.extend(self.children)
                continue
            for op in self.ops:
                if op[2]:
                    op = op[:2] + (tuple(d + off for d in op[2]),) + op[3:]
                ops.append(op)
            children.extend(tuple(c + off for c in ch)
                            for ch in self.children)
        out.ops = ops
        out.children = children
        out.dep_count = self.dep_count * k
        out.n = n * k
        return out


def compile_program(prog: Sequence, cfg: NocConfig) -> CompiledProgram:
    """Lower ``prog`` (a sequence of PacketOps) for flat replay.

    Raises :class:`UncompilableProgram` when an op cannot be encoded into
    the mesh-sized flat arrays (out-of-mesh coordinate, non-unit path
    step, VC beyond the config) — callers fall back to the heap engine.
    """
    cp = CompiledProgram(cfg)
    width, height = cfg.width, cfg.height
    vcs = effective_vcs(cfg)
    n = len(prog)
    children: list[list[int]] = [[] for _ in range(n)]
    for i, op in enumerate(prog):
        for d in op.deps:
            if not 0 <= d < i:
                raise UncompilableProgram(f"op {i} depends on non-prior {d}")
            children[d].append(i)

    def port_id(kind: int, vc: int, node) -> int:
        pid = port_index(kind, vc, node, width, height, vcs)
        if pid is None:
            raise UncompilableProgram(f"port ({kind}, {vc}, {node}) "
                                      f"outside the {width}x{height} mesh")
        return pid

    for i, op in enumerate(prog):
        virtual = op.flits == 0 and not op.inject and not op.eject
        link_ids: tuple[int, ...] = ()
        inj_pid = ej_pid = 0
        hop_deliver = None
        if not virtual:
            if op.path is not None:
                ids, links = path_link_ids(width, height, tuple(op.path))
            else:
                ids, links = route_link_ids(width, height, op.src, op.dst)
            link_ids = _strict_ids(ids)
            if link_ids is None:
                raise UncompilableProgram(f"op {i}: route {op.src}->{op.dst} "
                                          f"leaves the {width}x{height} mesh")
            if op.inject:
                inj_pid = port_id(0, op.vc, op.src)
            if op.eject:
                ej_pid = port_id(1, op.vc, op.dst)
            midway = set(op.delivers) - {op.dst}
            if midway:
                hop_deliver = tuple(l[1] if l[1] in midway else None
                                    for l in links)
        n_links = len(link_ids)
        completion = tuple(node for node in op.delivers
                           if node == op.dst or op.flits == 0)
        energy = (op.pe_adds,
                  op.extra_ni_flits
                  + op.flits * (int(op.inject) + int(op.eject)),
                  op.flits * (n_links + 1),
                  op.flits * n_links,
                  n_links,
                  op.reduce_words,
                  int(op.inject) + int(op.eject))
        cp.ops.append((op.t, op.delay, tuple(op.deps), virtual, op.flits,
                       op.inject, op.eject, link_ids, inj_pid, ej_pid,
                       hop_deliver, completion, energy))
    cp.children = [tuple(c) for c in children]
    cp.dep_count = [len(op.deps) for op in prog]
    cp.n = n
    return cp
