"""Static checks of the port's artifacts (counterpart of ``repro.analysis``):
the findings record and the execution-plan verifier.  The reference's
packet-program, schedule and fault verifiers and its linter are not
copied (``ROADMAP.md`` Queue 1, item 3.2)."""
from .findings import Finding, VerificationError
from .verify import verify_plan

__all__ = ["Finding", "VerificationError", "verify_plan"]
