"""Machine-readable findings of the plan verifier (a copy of
``repro.analysis.findings``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect located by a named check.

    ``check`` is the check's id ("plan-schema", "plan-mode", "plan-tile",
    "plan-gemm"); ``where`` locates the defect (a plan key and site, tile
    or GEMM); ``message`` says what is wrong in one sentence.
    """

    check: str
    where: str
    message: str
    severity: str = "error"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.check}] {self.where}: {self.message}"


class VerificationError(Exception):
    """Raised by the opt-in hooks when static checks produce findings."""

    def __init__(self, findings) -> None:
        self.findings = list(findings)
        head = "; ".join(str(f) for f in self.findings[:4])
        extra = len(self.findings) - 4
        if extra > 0:
            head += f" (+{extra} more)"
        super().__init__(head or "verification failed")
