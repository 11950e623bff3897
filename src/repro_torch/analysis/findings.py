"""Machine-readable findings of the static verifier (a copy of
``repro.analysis.findings``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect located by a named check.

    ``check`` is the check's id ("dep-dag", "route", "cdg-deadlock",
    "collective-fold", "hier-route", "plan-mode", "kvcache", ...);
    ``where`` locates the defect (an op index, a lane, a plan key and
    site); ``message`` says what is wrong in one sentence.
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
