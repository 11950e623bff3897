"""The port's copy of the NoC cost model that ``mode="auto"`` consults.

``repro_torch.core.collectives.choose_psum_mode`` asks the event-driven mesh
simulator of ``repro.core.noc`` which psum strategy is cheapest for a
(span, payload).  The port imports nothing of ``repro``, so it keeps its own
copy of what that question reaches: the router and energy model, the
topology, the heap simulator, an in-memory result store, and
``collective/`` (trees, schedule, engine, cost).  The logic is the
reference's; the differences are stated where they are: one executor, the
heap engine (``collective.engine``), a store that persists nothing
(``simcache``), and no fault layer or static verifier
(``collective.schedule``, ``.cost``, ``.engine``).  The reference's
compiled and vectorized executors, workload traffic, power model, faults
and hierarchy are not copied: ``auto`` never needs them.
"""
from .router import EnergyLedger, NocConfig
from .simcache import SIM_CACHE, SimCache, fresh_sim_cache
from .simulator import NocSim
from .topology import Mesh, route, xy_route, yx_route

__all__ = ["NocConfig", "EnergyLedger", "Mesh", "route", "xy_route",
           "yx_route", "NocSim", "SIM_CACHE", "SimCache", "fresh_sim_cache"]
