"""Collective-capable NoC: in-network reduce/multicast trees as a subsystem.

Layers:

* :mod:`trees`    — XY-/YX-ordered reduction & multicast trees over the mesh
  for any participant set (full mesh, row, column, arbitrary subset).
* :mod:`schedule` — lowers reduce / broadcast / gather / allreduce into
  time-stamped packet programs under in-network-accumulate or
  eject->add->inject router semantics; also emits the paper's WS rounds.
* :mod:`engine`   — replays programs on the discrete-event simulator with
  dependency resolution; returns latency + energy.
* :mod:`cost`     — cached cost facade consumed by ``core.collectives`` and
  ``parallel.tp`` (simulated-mesh PsumMode selection).
"""
from .cost import CollectiveCost, choose_psum_mode, collective_cost, psum_mode_costs
from .engine import ProgramResult, run_program
from .schedule import (ALLREDUCE_ALGORITHMS, COLLECTIVE_OPS, SEMANTICS,
                       PacketOp, delivered_contribs, plan_collective,
                       ws_round_program)
from .trees import (CollectiveTree, full_mesh, mesh_column, mesh_row,
                    multicast_tree, reduction_tree, segments)

__all__ = [
    "ALLREDUCE_ALGORITHMS", "COLLECTIVE_OPS", "SEMANTICS",
    "CollectiveCost", "CollectiveTree", "PacketOp", "ProgramResult",
    "choose_psum_mode", "collective_cost", "delivered_contribs",
    "full_mesh", "mesh_column", "mesh_row", "multicast_tree",
    "plan_collective", "psum_mode_costs", "reduction_tree", "run_program",
    "segments", "ws_round_program",
]
