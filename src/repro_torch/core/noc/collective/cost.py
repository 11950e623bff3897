"""Cost-model facade: simulated mesh latency/energy for collectives.

This is the bridge between the NoC subsystem and the JAX side:
``core.collectives`` / ``parallel.tp`` ask *"what would this psum cost on
the mesh?"* and get numbers from the same event-driven simulator that
reproduces the paper's Figs. 7-12, instead of hand-derived per-link traffic
formulas.  Results are cached — programs for a given (op, participants,
payload, semantics) are deterministic.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, Optional

from ..router import EnergyLedger, NocConfig
from ..simcache import SIM_CACHE
from .engine import run_program
from .schedule import plan_collective
from .trees import full_mesh, mesh_row

Coord = tuple[int, int]

#: How each JAX-side psum mode maps onto a mesh collective.
#:
#: ``"xla"`` deliberately aliases ``"ina"``: XLA's native ``psum`` lowers to
#: the same in-network reduce+broadcast schedule on the wire — the only
#: difference is whether the algorithm is visible in the HLO.  The alias
#: means ``mode="auto"`` can never *prefer* XLA over INA on simulated cost
#: (their costs are identical by construction), which is why
#: :data:`AUTO_CANDIDATES` drops ``"xla"`` from the argmin entirely instead
#: of comparing four candidates.  ``tests/test_plan.py`` pins both the
#: alias and the candidate set.
PSUM_MODE_LOWERING = {
    "eject_inject": ("reduce_bcast", "eject_inject"),
    "ina_ring": ("rs_ag", "ina"),
    "ina": ("reduce_bcast", "ina"),
    "xla": ("reduce_bcast", "ina"),
}

#: The strategies ``mode="auto"`` actually compares (tie-break order).
#: ``"xla"`` is excluded: it shares ``"ina"``'s lowering (see above), so
#: including it would only shadow the INA fast path with an equal-cost
#: duplicate that hides the algorithm from the HLO.
AUTO_CANDIDATES = ("ina", "ina_ring", "eject_inject")

#: Observable simulation effort, in the style of ``topology.ROUTE_STATS``:
#: ``engine_runs`` counts actual event-driven program executions (the
#: expensive part), ``store_hits`` counts runs avoided by the
#: :data:`~repro_torch.core.noc.simcache.SIM_CACHE` store (in memory or
#: persisted), ``memo_hits`` counts per-process ``lru_cache`` returns
#: (tracked by :func:`collective_cost` — the lru layer never re-enters
#: ``_simulate``'s body).  Regression tests assert on deltas of these.
COST_STATS = {"engine_runs": 0, "store_hits": 0, "memo_hits": 0}


@dataclass(frozen=True)
class CollectiveCost:
    """Simulated cost of one collective on the mesh."""

    op: str
    algorithm: str
    semantics: str
    n: int                      # mesh dimension
    participants: int
    payload_bits: float
    latency_cycles: int
    energy_pj: float
    packets: int
    #: Per-event breakdown (a private copy).  Excluded from eq/hash: the
    #: ledger is mutable and fully determined by the other fields, and
    #: CollectiveCost instances must stay hashable (set/dict-key use).
    ledger: Optional[EnergyLedger] = dataclasses.field(default=None,
                                                       compare=False)

    @property
    def power_pj_per_cycle(self) -> float:
        return self.energy_pj / max(self.latency_cycles, 1)


@lru_cache(maxsize=4096)
def _simulate(op: str, parts: tuple[Coord, ...], payload_bits: float,
              cfg: NocConfig, root: Optional[Coord], algorithm: str,
              semantics: str, order: str,
              ) -> tuple[int, float, int, EnergyLedger]:
    # Planning (cheap, O(program ops)) runs even on a store hit: the
    # packets count is derived from the program, and the store's value
    # shape is fixed at (latency, ledger).  Bounded cost — the lru above
    # means once per distinct signature per process.
    prog = plan_collective(op, parts, payload_bits, cfg, root=root,
                           algorithm=algorithm, semantics=semantics,
                           order=order)
    packets = sum(1 for o in prog if o.flits)
    # The event-driven run (the expensive part) rides the store, persisted
    # by a launch's plan build: collective signatures key ``SIM_CACHE``
    # under a ``"collective"`` tag, so a process replays nothing the store
    # already holds, past the lru above too.  Latency and energy
    # reconstruct exactly from the stored (latency, ledger) pair — energy is
    # a pure function of ledger counts and ``cfg`` constants.
    key = ("collective", op, parts, payload_bits, cfg, root, algorithm,
           semantics, order)
    hit = SIM_CACHE.get(key)
    if hit is not None:
        COST_STATS["store_hits"] += 1
        latency, ledger = hit
        return (int(latency), ledger.network_energy_pj(cfg), packets, ledger)
    COST_STATS["engine_runs"] += 1
    res = run_program(prog, cfg)
    SIM_CACHE.put(key, float(res.latency_cycles), res.ledger)
    # Keep a private EnergyLedger.copy(): the cached tuple must never alias
    # a ledger a caller can mutate.
    return (res.latency_cycles, res.network_energy_pj(cfg),
            packets, res.ledger.copy())


@lru_cache(maxsize=2048)
def _simulate_faulted(op: str, parts: tuple[Coord, ...], payload_bits: float,
                      cfg: NocConfig, root: Optional[Coord], algorithm: str,
                      semantics: str, order: str, faults,
                      ) -> tuple[int, float, int, EnergyLedger]:
    """Fault-repaired twin of :func:`_simulate` under a distinct store tag.

    The FaultModel is frozen/hashable so it rides the lru key directly, and
    its normalized ``key()`` joins the SIM_CACHE signature — one fault set
    can never replay another's (or the clean mesh's) stored runs.
    """
    prog = plan_collective(op, parts, payload_bits, cfg, root=root,
                           algorithm=algorithm, semantics=semantics,
                           order=order, faults=faults)
    packets = sum(1 for o in prog if o.flits)
    key = ("collective-faulted", op, parts, payload_bits, cfg, root,
           algorithm, semantics, order, faults.key())
    hit = SIM_CACHE.get(key)
    if hit is not None:
        COST_STATS["store_hits"] += 1
        latency, ledger = hit
        return (int(latency), ledger.network_energy_pj(cfg), packets, ledger)
    COST_STATS["engine_runs"] += 1
    res = run_program(prog, cfg)
    SIM_CACHE.put(key, float(res.latency_cycles), res.ledger)
    return (res.latency_cycles, res.network_energy_pj(cfg),
            packets, res.ledger.copy())


def collective_cost(op: str, payload_bits: float,
                    cfg: NocConfig = NocConfig(), *,
                    participants: Optional[Iterable[Coord]] = None,
                    root: Optional[Coord] = None,
                    algorithm: str = "reduce_bcast",
                    semantics: str = "ina",
                    order: str = "xy", faults=None) -> CollectiveCost:
    """Plan + simulate one collective; ``participants`` defaults to the
    full ``cfg.n`` x ``cfg.n`` mesh.  ``payload_bits`` is per participant.

    ``faults`` (an optional :class:`~repro_torch.core.noc.faults.
    FaultModel`) prices the fault-repaired program instead; ``None`` or an
    empty model takes the exact unfaulted path: same memo, same store keys.
    """
    parts = tuple(sorted(participants)) if participants is not None \
        else tuple(full_mesh(cfg.n))
    if faults is not None and not faults.empty:
        memo_before = _simulate_faulted.cache_info().hits
        lat, energy, packets, ledger = _simulate_faulted(
            op, parts, float(payload_bits), cfg, root, algorithm,
            semantics, order, faults)
        if _simulate_faulted.cache_info().hits > memo_before:
            COST_STATS["memo_hits"] += 1
    else:
        memo_before = _simulate.cache_info().hits
        lat, energy, packets, ledger = _simulate(op, parts,
                                                 float(payload_bits),
                                                 cfg, root, algorithm,
                                                 semantics, order)
        if _simulate.cache_info().hits > memo_before:
            COST_STATS["memo_hits"] += 1
    return CollectiveCost(op=op, algorithm=algorithm, semantics=semantics,
                          n=cfg.n, participants=len(parts),
                          payload_bits=float(payload_bits),
                          latency_cycles=lat, energy_pj=energy,
                          packets=packets, ledger=ledger.copy())


# --------------------------------------------------------------------------- #
# psum-mode facade for the JAX side (a TP axis modelled as one mesh row)
# --------------------------------------------------------------------------- #
def _row_cfg(p: int, cfg: NocConfig) -> NocConfig:
    return cfg if cfg.n >= p else dataclasses.replace(cfg, n=p)


def psum_mode_costs(p: int, nbytes: int,
                    cfg: NocConfig = NocConfig()) -> dict[str, CollectiveCost]:
    """Simulated allreduce cost for every PsumMode over a ``p``-device TP
    axis, embedded as one mesh row (the ring of the paper's datacenter
    analogue laid out on NoC links)."""
    if p <= 1:
        zero = CollectiveCost("allreduce", "none", "none", cfg.n, 1,
                              nbytes * 8, 0, 0.0, 0)
        return {m: zero for m in PSUM_MODE_LOWERING}
    rcfg = _row_cfg(p, cfg)
    parts = mesh_row(p, 0)[:p]
    out = {}
    for mode, (algorithm, semantics) in PSUM_MODE_LOWERING.items():
        out[mode] = collective_cost(
            "allreduce", nbytes * 8, rcfg, participants=parts,
            algorithm=algorithm, semantics=semantics)
    return out


def choose_psum_mode(p: int, nbytes: int, cfg: NocConfig = NocConfig(),
                     objective: str = "latency") -> str:
    """Pick the PsumMode with the best simulated mesh cost.

    ``objective`` is ``"latency"`` or ``"energy"``.  The argmin runs over
    :data:`AUTO_CANDIDATES` only — ``"xla"`` is excluded because its
    lowering *is* ``"ina"``'s (see :data:`PSUM_MODE_LOWERING`): simulating
    it would compare two identical schedules and could only ever shadow the
    INA fast path.  Ties resolve toward the INA fast path (candidate
    order).
    """
    if p <= 1:
        return "ina"
    costs = psum_mode_costs(p, nbytes, cfg)
    key = (lambda c: c.latency_cycles) if objective == "latency" \
        else (lambda c: c.energy_pj)
    return min(AUTO_CANDIDATES,
               key=lambda m: (key(costs[m]), AUTO_CANDIDATES.index(m)))
