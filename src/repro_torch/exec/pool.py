"""Deterministic process-pool fan-out for simulation workloads
(counterpart of ``repro.exec.pool``).

:func:`parallel_map` runs a picklable function over a list of items across
a process pool and returns results **in item order** — the same list a
serial ``[fn(x) for x in items]`` produces, which is what makes
``jobs=N`` observationally equivalent to ``jobs=1``: every window result
is a pure function of its plan key, so recomputing in a worker instead of
hitting the parent's warm cache yields bit-identical values.

Workers are started with ``spawn``, never ``fork``: every process of the
port holds torch's thread pools (and, on the card, a CUDA context), which
a forked child inherits in an undefined state.  So a worker starts cold,
and ``fn`` must be importable at module level.  Each task ships the
window-cache entries it created back to the parent, which merges them
(:meth:`SimCache.merge`; duplicate keys carry identical values, so merge
order cannot matter) so later work and the persistent store see the union.
Only the parent persists the store: a spawned worker never calls
:meth:`SimCache.persist`.

``jobs <= 1``, a single item, a call from inside a worker, or a single
schedulable CPU run serially in-process — the work is CPU-bound and
deterministic, so a pool on one core can only add overhead.
"""
from __future__ import annotations

import multiprocessing
import os
from itertools import islice
from typing import Callable, Iterable, Optional, TypeVar

from repro_torch.core.noc.simcache import SIM_CACHE

T = TypeVar("T")
R = TypeVar("R")

#: Set in pool workers; lets library code detect it runs inside a fan-out.
_IN_WORKER = False


def default_jobs(requested: Optional[int] = None) -> int:
    """Resolve a ``--jobs`` value: explicit N, else 0/None = all cores."""
    if requested is not None and requested > 0:
        return requested
    return max(1, os.cpu_count() or 1)


def _effective_cpus() -> int:
    """CPUs this process may actually run on (cgroup/affinity aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                          # pragma: no cover
        return os.cpu_count() or 1


def _run_task(payload):
    """Pool worker: run one task, return (result, new window-cache entries)."""
    global _IN_WORKER
    _IN_WORKER = True
    fn, item = payload
    before = len(SIM_CACHE._store)
    result = fn(item)
    # New entries are the insertion-ordered tail (the store never shrinks
    # inside a task); avoids hashing the whole store per task.
    delta = SIM_CACHE.export(
        list(islice(iter(SIM_CACHE._store), before, None)))
    return result, delta


def parallel_map(fn: Callable[[T], R], items: Iterable[T],
                 jobs: int = 1) -> list[R]:
    """``[fn(x) for x in items]`` across a spawned pool, results in order.

    ``fn`` must be a module-level (picklable) callable and deterministic;
    window-cache entries created by workers are merged back into the
    parent cache.  Serial fallback keeps single-job runs allocation-free.
    """
    items = list(items)
    if jobs <= 1 or len(items) <= 1 or _IN_WORKER or _effective_cpus() <= 1:
        return [fn(it) for it in items]
    spawn = multiprocessing.get_context("spawn")
    with spawn.Pool(min(jobs, len(items))) as pool:
        out = pool.map(_run_task, [(fn, it) for it in items])
    results = []
    for result, delta in out:
        SIM_CACHE.merge(delta)
        results.append(result)
    return results
