"""Keyed in-memory store of simulated collective results.

:func:`repro_torch.core.noc.collective.cost._simulate` keys each
collective signature (op, participants, payload, config, algorithm,
semantics, order) into :data:`SIM_CACHE` and replays nothing the store
already holds.  Invalidation is structural: :class:`NocConfig` is a frozen
dataclass and a full member of the key, so a changed timing or energy
constant hashes to a different entry.

Entries store ``(latency, EnergyLedger)``.  Ledgers are mutable event-count
accumulators, so the store keeps a private copy and hands out a fresh
:meth:`EnergyLedger.copy` per hit, keeping cached runs bit-identical to
uncached ones.

The port's copy of ``repro.core.noc.simcache`` differs in one place: it has
no persistent store (the reference's on-disk ``window_cache.json``, its
environment override, locking and save at exit).  The port never persists,
so it never reads a store the JAX package wrote.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Hashable, Optional

from .router import EnergyLedger


class SimCache:
    """Keyed store of ``(latency_cycles, EnergyLedger)`` results."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self._store: dict[Hashable, tuple[float, EnergyLedger]] = {}

    def get(self, key: Hashable) -> Optional[tuple[float, EnergyLedger]]:
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        t, ledger = hit
        return t, ledger.copy()

    def put(self, key: Hashable, latency: float, ledger: EnergyLedger) -> None:
        self._store[key] = (latency, ledger.copy())

    def clear(self) -> None:
        self.hits = self.misses = 0
        self._store.clear()

    def __len__(self) -> int:
        return len(self._store)


#: Process-wide store consulted by the collective cost facade.
SIM_CACHE = SimCache()


@contextmanager
def fresh_sim_cache():
    """Swap in an empty store (reference timings); the previous store and
    counters come back on exit."""
    saved = (SIM_CACHE.hits, SIM_CACHE.misses, SIM_CACHE._store)
    SIM_CACHE.hits = SIM_CACHE.misses = 0
    SIM_CACHE._store = {}
    try:
        yield SIM_CACHE
    finally:
        SIM_CACHE.hits, SIM_CACHE.misses, SIM_CACHE._store = saved
