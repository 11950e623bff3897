"""Machine-readable findings shared by the verifier and the linter (a
copy of ``repro.analysis.findings``)."""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect located by a named check.

    ``check`` is the check's id ("dep-dag", "route", "cdg-deadlock",
    "collective-fold", "hier-route", "plan-mode", "kvcache", ... or a lint
    rule name); ``where`` locates the defect (an op index, a lane, a plan
    key and site, a ``file:line``); ``message`` says what is wrong in one
    sentence.
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


def findings_doc(findings, **meta) -> dict:
    """A deterministic JSON-serializable findings artifact."""
    doc = dict(sorted(meta.items()))
    doc["count"] = len(findings)
    doc["findings"] = [f.to_dict() for f in findings]
    return doc


def dump_findings(path, findings, **meta) -> None:
    from pathlib import Path

    from repro_torch.core.noc.simcache import atomic_write_text
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(
        p, json.dumps(findings_doc(findings, **meta), indent=1,
                      sort_keys=True) + "\n")
