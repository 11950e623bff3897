"""ExecutionPlan layer (counterpart of ``repro.plan``): one planning pass
for the port's launch-time decisions.

Instead of every ``psum_with_mode(mode="auto")`` call site consulting the
NoC cost model as it runs, the mapper's verdicts ending in a report, and
each ``ina_matmul`` launch chosen call by call, a single pass per (model
config, mesh shape, phase, dtype), :func:`~.builder.build_plan`, decides
all three and emits a frozen, byte-deterministic, persistable
:class:`~.plan.ExecutionPlan`.  Consumers (``ParallelCtx``,
``core.collectives``, ``kernels.ops.matmul``) read the plan; without one
they resolve as before.

Produce and persist: :class:`~.store.PlanStore` (``results/.plans_torch``).
"""
from .builder import (PHASES, PHASE_SHAPES, build_plan, collect_psum_sites,
                      gemm_verdicts, model_span, normalize_mesh, phase_shape,
                      resolve_sites, tile_choices)
from .plan import (PLAN_SCHEMA_VERSION, ExecutionPlan, GemmVerdict,
                   PsumDecision, TileChoice, config_digest, plan_key,
                   plan_schema_hash)
from .store import (PLAN_DIR_ENV, PlanStore, add_plan_cli_args,
                    default_plan_dir, launch_phase, plan_for_launch)
from .tiles import choose_tiles, tile_working_set

__all__ = [
    "ExecutionPlan", "PsumDecision", "GemmVerdict", "TileChoice",
    "PLAN_SCHEMA_VERSION", "plan_key", "plan_schema_hash", "config_digest",
    "PHASES", "PHASE_SHAPES", "build_plan", "collect_psum_sites",
    "gemm_verdicts", "model_span", "normalize_mesh", "phase_shape",
    "resolve_sites", "tile_choices",
    "PlanStore", "PLAN_DIR_ENV", "add_plan_cli_args", "default_plan_dir",
    "launch_phase", "plan_for_launch",
    "choose_tiles", "tile_working_set",
]
