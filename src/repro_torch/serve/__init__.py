"""Serving subsystem of the port (counterpart of ``repro.serve``):
continuous batching + paged KV execution engine, the serving metrics, and
the request-level cluster capacity simulator.

* :mod:`repro_torch.serve.engine` — PyTorch serving: continuous batching
  over a paged per-slot decode step, chunked batched prefill, paged KV
  cache.
* :mod:`repro_torch.serve.cluster` — fleets of simulated instances with
  NoC-plan-derived iteration latencies (:mod:`.costs`); TTFT/TPOT/p99 +
  fleet sizing over seeded workloads (:mod:`.traffic`).
* ``python -m repro_torch.serve`` — the capacity-planning CLI gluing both.
"""
from repro_torch.serve.batching import (Request, RequestQueue, RequestState,
                                        Scheduler)
from repro_torch.serve.cluster import ClusterSimulator, search_fleet
from repro_torch.serve.costs import (PlanCostModel, SyntheticCostModel,
                                     serve_plans)
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.kvcache import BlockAllocator, PagedKVCache
from repro_torch.serve.metrics import percentile, summarize
from repro_torch.serve.traffic import (load_trace, make_workload,
                                       poisson_arrivals)

__all__ = [
    "BlockAllocator", "ClusterSimulator", "PagedKVCache", "PlanCostModel",
    "Request", "RequestQueue", "RequestState", "Scheduler", "ServingEngine",
    "SyntheticCostModel", "load_trace", "make_workload", "percentile",
    "poisson_arrivals", "search_fleet", "serve_plans", "summarize",
]
