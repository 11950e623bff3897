"""The port's copy of the NoC model: the cost of ``mode="auto"``'s psum
strategies, and the per-layer WS/OS traffic that the mapper searches.

``repro_torch.core.collectives.choose_psum_mode`` asks the event-driven mesh
simulator which psum strategy is cheapest for a (span, payload), and the
plan builder's mapper (:mod:`repro_torch.mapper`) scores each decoder GEMM's
placements through :mod:`.traffic`, whose whole-network totals
(``simulate_network``) and the power model's ratios (:mod:`.power`) are the
paper's Figs 7-12.  The port imports nothing of ``repro``,
so it keeps its own copy of what those questions reach: the router and
energy model, the topology, the heap simulator, the result store
(``simcache``, persisted under the port's own directory), the WS/OS
traffic (``traffic``) and ``collective/`` (trees, schedule, engine, cost).
The logic is the reference's, with its three bit-identical executors (the
heap engine, the compiled replay of :mod:`.compiled` and the vectorized
kernels of :mod:`.vectorized`, whose batched window pass also runs in
PyTorch on a device) and its fault layer (:mod:`.faults`: seeded faults,
detour routing, repaired collectives).  The package hierarchy
(``hierarchy/``: chips of meshes on a package network) prices psum sites
and mappings across chips.
"""
from .compiled import CompiledProgram, compile_program, compiled_disabled
from .router import EnergyLedger, NocConfig
from .simcache import (SIM_CACHE, SimCache, fresh_sim_cache,
                       sim_cache_disabled)
from .simulator import NocSim
from .topology import Mesh, route, xy_route, yx_route
from .traffic import (CompiledWindow, LayerResult, layer_plan,
                      simulate_layer, simulate_network)
from .vectorized import (VectorProgram, lower_program, run_vectorized,
                         vector_stats, vectorized_disabled)

__all__ = ["NocConfig", "EnergyLedger", "Mesh", "route", "xy_route",
           "yx_route", "NocSim", "LayerResult", "layer_plan",
           "simulate_layer", "simulate_network", "SIM_CACHE", "SimCache",
           "sim_cache_disabled", "fresh_sim_cache", "CompiledProgram",
           "CompiledWindow", "compile_program", "compiled_disabled",
           "VectorProgram", "lower_program", "run_vectorized",
           "vector_stats", "vectorized_disabled"]
