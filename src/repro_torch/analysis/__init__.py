"""Static checks of the port's artifacts and of its own source
(counterpart of ``repro.analysis``), one findings vocabulary
(:class:`~.findings.Finding`):

* the artifact verifier (:mod:`.verify`), which checks PacketOp programs,
  CompiledPrograms, fault-repaired programs, mapper NetworkSchedules,
  hierarchical schedules, ExecutionPlans and the paged-KV free list
  without running the event loop, and the artifact corpora it is swept
  over (:mod:`.corpus`);
* the determinism lint (:mod:`.lint`), an AST rule registry over
  ``src/repro_torch``: unseeded randomness, wall-clock reads,
  set-iteration order hazards, mutable default arguments, and persisted
  writes bypassing ``atomic_write_text``.

CLI: ``python -m repro_torch.analysis verify`` / ``python -m
repro_torch.analysis lint``.  Opt-in hooks: ``run_program(verify=True)``,
``search_network(debug=True)``, ``PlanStore.save`` (always)."""
from .findings import Finding, VerificationError
from .lint import LINT_RULES, lint_paths
from .verify import (check_program, verify_allocator, verify_collective,
                     verify_compiled, verify_faulted, verify_hier_schedule,
                     verify_kvcache, verify_plan, verify_program,
                     verify_schedule)

__all__ = [
    "Finding", "VerificationError",
    "LINT_RULES", "lint_paths",
    "check_program", "verify_allocator", "verify_collective",
    "verify_compiled", "verify_faulted", "verify_hier_schedule",
    "verify_kvcache", "verify_plan", "verify_program", "verify_schedule",
]
