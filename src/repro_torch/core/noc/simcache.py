"""Keyed store of simulated NoC results, in memory and on disk (a copy of
``repro.core.noc.simcache``).

Three kinds of entry share it: the collective cost facade
(:func:`repro_torch.core.noc.collective.cost._simulate`) keys each
collective signature (op, participants, payload, config, algorithm,
semantics, order) under a ``"collective"`` tag, the package hierarchy's
express lanes (:func:`repro_torch.core.noc.hierarchy.cost.
_simulate_express`) under ``"hier-express"``, and the WS/OS window
simulator (:func:`repro_torch.core.noc.traffic._sim_rounds_window`) keys
each window of accumulation rounds by its plan shape ``(cfg, mode, window,
g, p, gather_flits, unicast_flits, e_pes)``.  Invalidation is structural:
:class:`NocConfig` is a frozen dataclass and a full member of every key, so
a changed timing or energy constant hashes to a different entry.

Entries store ``(latency, EnergyLedger)``.  Ledgers are mutable event-count
accumulators, so the store keeps a private copy and hands out a fresh
:meth:`EnergyLedger.copy` per hit, keeping cached runs bit-identical to
uncached ones.

Persistence: :meth:`SimCache.persist` attaches an on-disk store
(``window_cache.json`` under ``results/.simcache_torch/`` by default, or
``$REPRO_TORCH_SIMCACHE_DIR``), read at start and merged back at exit, so
a second plan build in a new process runs no simulation the first one ran.
Keys are serialized as ``repr()`` of the live key; the file carries
:func:`schema_hash`, and a file of another schema loads as empty.  The
port's directory, environment variable and schema tag are its own: it never
reads a store the JAX package wrote.  Saves re-read the file and merge
under a file lock before an atomic replace, so concurrent processes union
their entries.

The store can be switched off (:func:`configure`, the experiments CLI's
``--no-cache``; :func:`sim_cache_disabled` for a ground-truth run): then
``get`` answers nothing and ``put`` keeps nothing, the mapper scores every
layer afresh and the batched window prefetch stands down.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Hashable, Optional

try:
    import fcntl
except ImportError:                              # non-POSIX: no inter-process
    fcntl = None                                 # lock; saves may interleave

from .router import EnergyLedger, NocConfig

#: Bump when the key layout or the stored payload shape changes.
SCHEMA_VERSION = 1

#: Environment override for the persistent store location.
CACHE_DIR_ENV = "REPRO_TORCH_SIMCACHE_DIR"

_DEFAULT_DIR = os.path.join("results", ".simcache_torch")
_CACHE_FILE = "window_cache.json"


def atomic_write_text(path: Path, text: str) -> None:
    """Write ``text`` to ``path`` via tempfile + ``os.replace``: readers
    never see a torn file, and the temp file is unlinked on any failure.
    Shared by the store below and the plan store
    (:mod:`repro_torch.plan.store`)."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}-")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def schema_hash() -> str:
    """Hash of everything the serialized entries structurally depend on:
    the key layout version, the ``NocConfig`` and ``EnergyLedger`` field
    lists, and the port's tag (the reference's store never matches)."""
    parts = ("repro_torch", SCHEMA_VERSION,
             tuple(NocConfig.__dataclass_fields__),
             tuple(EnergyLedger.__dataclass_fields__))
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:16]


class SimCache:
    """Keyed store of ``(latency_cycles, EnergyLedger)`` results."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        #: Incremented on :meth:`clear`; side memos (the mapper's layer
        #: results) key off it to invalidate themselves.
        self.generation = 0
        self._store: dict[Hashable, tuple[float, EnergyLedger]] = {}
        self._disk: dict[str, tuple] = {}        # key repr -> [lat, fields]
        self._persist_dir: Optional[Path] = None
        self._persist_pid: Optional[int] = None
        self._saved_size: Optional[int] = None   # len(_store) at last save

    def get(self, key: Hashable) -> Optional[tuple[float, EnergyLedger]]:
        if not self.enabled:
            return None
        hit = self._store.get(key)
        if hit is None and self._disk:
            row = self._disk.pop(repr(key), None)
            if row is not None:                  # promote a disk row
                hit = (float(row[0]), EnergyLedger.from_tuple(row[1]))
                self._store[key] = hit
                self.disk_hits += 1
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        t, ledger = hit
        return t, ledger.copy()

    def put(self, key: Hashable, latency: float, ledger: EnergyLedger) -> None:
        if self.enabled:
            self._store[key] = (latency, ledger.copy())

    def merge(self, entries: dict) -> int:
        """Adopt entries computed elsewhere (a pool worker's delta); keys
        are pure functions of what was simulated, so a duplicate carries the
        same value.  Returns the number of new keys."""
        new = 0
        for key, (latency, ledger) in entries.items():
            if key not in self._store:
                self._store[key] = (latency, ledger.copy())
                new += 1
        return new

    def export(self, keys=None) -> dict:
        """Entries (all, or the given keys) for a cross-process merge."""
        src = self._store if keys is None else {
            k: self._store[k] for k in keys if k in self._store}
        return {k: (t, led.copy()) for k, (t, led) in src.items()}

    def clear(self) -> None:
        self.hits = self.misses = self.disk_hits = 0
        self.generation += 1
        self._store.clear()
        self._disk.clear()

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> dict:
        looked = self.hits + self.misses
        return {"enabled": self.enabled, "entries": len(self._store),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / looked if looked else 0.0,
                "disk_hits": self.disk_hits,
                "persist_dir": str(self._persist_dir)
                if self._persist_dir else None}

    # ------------------------------------------------------------------ #
    # Persistent store
    # ------------------------------------------------------------------ #
    def load(self, dir_path: str | Path) -> int:
        """Read the on-disk store; returns the rows made visible.  A
        missing or corrupt file, or one of another schema, loads nothing."""
        path = Path(dir_path) / _CACHE_FILE
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return 0
        if doc.get("schema") != schema_hash():
            return 0
        self._disk.update(doc.get("entries", {}))
        return len(doc.get("entries", {}))

    def save(self, dir_path: Optional[str | Path] = None) -> int:
        """Merge the in-memory entries into the on-disk store (read, merge
        and replace under an exclusive lock where ``fcntl`` exists; the
        write is atomic).  Returns the rows written."""
        target = Path(dir_path) if dir_path is not None else self._persist_dir
        if target is None:
            return 0
        target.mkdir(parents=True, exist_ok=True)
        if fcntl is None:                        # pragma: no cover
            return self._merge_and_replace(target)
        # Lock files are advisory rendezvous points, not artifacts: torn
        # content is irrelevant (flock works on the inode, the file stays
        # empty) and atomic replace would defeat the rendezvous.
        with open(target / (_CACHE_FILE + ".lock"), "w") as lock:  # lint: allow(non-atomic-write)
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                return self._merge_and_replace(target)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _merge_and_replace(self, target: Path) -> int:
        path = target / _CACHE_FILE
        entries: dict[str, tuple] = {}
        try:
            doc = json.loads(path.read_text())
            if doc.get("schema") == schema_hash():
                entries.update(doc.get("entries", {}))
        except (OSError, ValueError):
            pass
        entries.update(self._disk)               # loaded rows not yet used
        for key, (latency, ledger) in self._store.items():
            entries[repr(key)] = (latency, ledger.as_tuple())
        atomic_write_text(
            path, json.dumps({"schema": schema_hash(), "entries": entries}))
        if target == self._persist_dir:
            self._saved_size = len(self._store)
        return len(entries)

    def persist(self, dir_path: str | Path) -> int:
        """Load now and merge back at exit, against ``dir_path``.  One
        exit hook, guarded by the process id, so a forked pool worker never
        writes; a second call only retargets the directory.  Returns the
        rows loaded."""
        self._persist_dir = Path(dir_path)
        loaded = self.load(self._persist_dir)
        if self._persist_pid is None:
            self._persist_pid = os.getpid()
            atexit.register(self._save_at_exit)
        return loaded

    def _save_at_exit(self) -> None:
        if self._persist_dir is None or os.getpid() != self._persist_pid:
            return
        if self._saved_size == len(self._store):
            return                               # nothing new since the save
        try:
            self.save()
        except OSError:
            pass                                 # best effort on teardown

    def persist_default_dir(self) -> str:
        """The store location, honoring ``$REPRO_TORCH_SIMCACHE_DIR``."""
        return os.environ.get(CACHE_DIR_ENV, _DEFAULT_DIR)


#: Process-wide store consulted by the cost facade and the window simulator.
SIM_CACHE = SimCache()


def configure(enabled: bool) -> None:
    """Globally enable/disable the store (clears it when disabling)."""
    SIM_CACHE.enabled = enabled
    if not enabled:
        SIM_CACHE.clear()


@contextmanager
def sim_cache_disabled():
    """Temporarily bypass the store (ground-truth runs in tests)."""
    prev = SIM_CACHE.enabled
    SIM_CACHE.enabled = False
    try:
        yield
    finally:
        SIM_CACHE.enabled = prev


@contextmanager
def fresh_sim_cache():
    """Swap in an empty, non-persistent store (reference timings); the
    previous store, counters and persistence come back on exit."""
    saved = (SIM_CACHE.hits, SIM_CACHE.misses, SIM_CACHE.disk_hits,
             SIM_CACHE._store, SIM_CACHE._disk, SIM_CACHE._persist_dir)
    SIM_CACHE.hits = SIM_CACHE.misses = SIM_CACHE.disk_hits = 0
    SIM_CACHE._store, SIM_CACHE._disk, SIM_CACHE._persist_dir = {}, {}, None
    SIM_CACHE.generation += 1
    try:
        yield SIM_CACHE
    finally:
        (SIM_CACHE.hits, SIM_CACHE.misses, SIM_CACHE.disk_hits,
         SIM_CACHE._store, SIM_CACHE._disk, SIM_CACHE._persist_dir) = saved
        SIM_CACHE.generation += 1
