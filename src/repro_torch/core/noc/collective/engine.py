"""Replay collective packet programs on the discrete-event NoC simulator.

The engine resolves :class:`~.schedule.PacketOp` dependencies at run time:
an op is enqueued when all its ``deps`` have completed, at ``max(op.t,
latest dep completion + op.delay)``.  Dependency-free ops are enqueued in
program order, so two programs that list the same packets in the same order
arbitrate identically (heap ties break by enqueue sequence) — this is what
lets the WS+INA schedule emitted by the planner reproduce the legacy
traffic generator cycle-for-cycle.

Virtual ops (``flits == 0``, no inject/eject) are synchronisation points:
they complete at their issue time without touching the network.

The reference has three executors of these semantics: this heap engine
(its ground truth), a compiled flat-array replay and a vectorized wavefront
kernel, bit-identical to it.  The port keeps the heap engine only: the
other two exist for speed, and ``mode="auto"`` resolves a handful of
collective signatures a process, each once (``chip_smoke.py``'s ``[tp]``
phase times a cold ``choose_psum_mode`` at p 2, 4 and 8: a few ms on the
heap engine alone).  ``run_program(verify=True)`` runs the static checks
of :mod:`repro_torch.analysis.verify` first, as the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..router import EnergyLedger, NocConfig
from ..simulator import NocSim
from .schedule import PacketOp


@dataclass
class ProgramResult:
    """Outcome of one program replay."""

    latency_cycles: int            # completion time of the last op
    ledger: EnergyLedger           # event counts (shared with the sim)
    done: list                     # per-op completion times
    delivered: dict                # node -> cycle its payload landed (the
                                   # earliest tail arrival; mid-segment
                                   # multicast drops land before segment end)

    def network_energy_pj(self, cfg: NocConfig) -> float:
        return self.ledger.network_energy_pj(cfg)


def run_program(prog: Sequence[PacketOp], cfg: Optional[NocConfig] = None,
                *, sim: Optional[NocSim] = None, t0: int = 0,
                verify: bool = False) -> ProgramResult:
    """Execute ``prog`` on ``sim`` (or a fresh simulator) and return the
    makespan, per-op completion times, and the energy ledger.

    A caller supplied ``sim`` keeps its ledger and resource state.
    ``verify=True`` runs the static checks (DAG, routes, CDG:
    :func:`repro_torch.analysis.verify.check_program`) first and raises
    ``VerificationError`` instead of simulating a broken program.  The
    reference's ``engine=`` (its executor choice) is not copied: the port
    has the heap engine only.
    """
    if verify:
        from repro_torch.analysis.verify import check_program
        check_program(prog, cfg)
    if sim is None:
        sim = NocSim(cfg if cfg is not None else NocConfig())
    n = len(prog)
    children: list[list[int]] = [[] for _ in range(n)]
    remaining = [len(op.deps) for op in prog]
    for i, op in enumerate(prog):
        for d in op.deps:
            assert 0 <= d < i, f"op {i} depends on non-prior op {d}"
            children[d].append(i)
    done: list[Optional[int]] = [None] * n
    delivered: dict = {}

    def deliver(node, t: int) -> None:
        if node not in delivered or t < delivered[node]:
            delivered[node] = t

    def issue(i: int, t: int) -> None:
        op = prog[i]
        sim.ledger.pe_adds += op.pe_adds
        sim.ledger.ni_flits += op.extra_ni_flits
        if op.flits == 0 and not op.inject and not op.eject:
            complete(i, t)                     # virtual synchronisation op
            return
        # In-passing deliveries (multicast drops at participant routers)
        # land when the packet tail clears the router, before the segment
        # completes; the per-hop hook timestamps them.
        midway = set(op.delivers) - {op.dst}
        on_hop = (lambda node, th, f=op.flits:
                  deliver(node, th + f - 1) if node in midway else None) \
            if midway else None
        sim.enqueue(t, op.src, op.dst, op.flits, vc=op.vc,
                    inject=op.inject, eject=op.eject,
                    reduce_words=op.reduce_words, path=op.path,
                    on_hop=on_hop,
                    on_done=lambda td, i=i: complete(i, td))

    def complete(i: int, td: int) -> None:
        done[i] = td
        for node in prog[i].delivers:
            if node == prog[i].dst or prog[i].flits == 0:
                deliver(node, td)
        for j in children[i]:
            remaining[j] -= 1
            if remaining[j] == 0:
                op = prog[j]
                t = max([t0 + op.t] + [done[d] for d in op.deps]) + op.delay
                issue(j, t)

    for i, op in enumerate(prog):
        if not op.deps:
            issue(i, t0 + op.t)
    makespan = sim.run()
    stuck = [i for i, d in enumerate(done) if d is None]
    assert not stuck, f"deadlocked ops (circular/unmet deps): {stuck}"
    return ProgramResult(latency_cycles=max([makespan] + done),
                         ledger=sim.ledger, done=done, delivered=delivered)
