"""Static checks of the port's artifacts (counterpart of ``repro.analysis``):
the findings record and the artifact verifier (:mod:`.verify`), which
checks PacketOp programs, CompiledPrograms, fault-repaired programs, mapper
NetworkSchedules, hierarchical schedules, ExecutionPlans and the paged-KV
free list without running the event loop, and the artifact corpora it is
swept over (:mod:`.corpus`).  Opt-in hooks: ``run_program(verify=True)``,
``search_network(debug=True)``, ``PlanStore.save`` (always).  The
reference's determinism linter and its ``python -m repro.analysis`` CLI
are not copied yet (``ROADMAP.md``)."""
from .findings import Finding, VerificationError
from .verify import (check_program, verify_allocator, verify_collective,
                     verify_compiled, verify_faulted, verify_hier_schedule,
                     verify_kvcache, verify_plan, verify_program,
                     verify_schedule)

__all__ = [
    "Finding", "VerificationError",
    "check_program", "verify_allocator", "verify_collective",
    "verify_compiled", "verify_faulted", "verify_hier_schedule",
    "verify_kvcache", "verify_plan", "verify_program", "verify_schedule",
]
