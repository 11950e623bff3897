"""Mesh-of-meshes hierarchy: multi-chip topology, collectives and costs (a
copy of ``repro.core.noc.hierarchy``).  Public surface:

* :class:`~.topology.HierarchicalMesh`: chips of W x H PEs on a package
  grid, ``(chip, x, y)`` addressing, composed routing, mesh/express
  package variants;
* :func:`~.collective.plan_hier_collective` /
  :func:`~.collective.run_hier_schedule`: per-level lowering onto the
  flat collective machinery, replayed by every engine unchanged;
* :func:`~.cost.hier_collective_cost` /
  :func:`~.cost.hier_psum_mode_costs`: the SIM_CACHE-riding cost facade
  the plan builder (``resolve_sites(chips > 1)``) and the mapper
  (``Mapping.chips > 1``) price multi-chip placements with.

``plan_hier_collective(faults=, failed_chips=)`` repairs each chip's lanes
over its own faulted fabric and drops failed chips, as the reference's
does.
"""
from .collective import (HIER_OPS, HierarchicalSchedule, HierLane,
                         HierLevel, HierResult, flat_hier_schedule,
                         plan_hier_collective, run_hier_schedule)
from .cost import (HierCost, chip_round_cost, choose_hier_psum_mode,
                   hier_collective_cost, hier_psum_mode_costs,
                   square_hier_mesh)
from .topology import (PACKAGE_VARIANTS, HierarchicalMesh, group_by_chip)

__all__ = [
    "HIER_OPS", "HierarchicalMesh", "PACKAGE_VARIANTS", "group_by_chip",
    "HierarchicalSchedule", "HierLane", "HierLevel", "HierResult",
    "plan_hier_collective", "run_hier_schedule", "flat_hier_schedule",
    "HierCost", "hier_collective_cost", "hier_psum_mode_costs",
    "choose_hier_psum_mode", "chip_round_cost", "square_hier_mesh",
]
