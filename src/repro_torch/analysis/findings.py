"""Findings and reports — the verifier's output vocabulary.

A copy of the JAX package's ``analysis/findings.py``.

Every ``repro_torch.analysis`` pass returns a list of :class:`Finding`s rather
than raising on first failure: a corrupted artifact usually violates
several invariants at once, and the mutation harness / ``launch.check``
sweep want the full picture (and a stable, comparable representation —
verifier determinism is itself a tested property).

Severity: ``error`` findings fail verification (``Report.ok`` is False);
``warn`` findings are surfaced but do not gate — used for invariants
that are suspicious rather than provably wrong (e.g. duplicate in-chain
ranks, which a stable sort still resolves deterministically).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

SEVERITIES = ("error", "warn")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    check    verifier pass ("schedule" | "reorder" | "plan" | "elastic"
             | "rowshard" | "levels" | "lint")
    code     stable machine code, e.g. "PLAN_READ_BEFORE_WRITE"
    message  human-readable description (includes counts / first examples)
    where    sorted (key, value) context pairs — kept hashable so findings
             can be set-compared across verifier runs
    severity "error" (gates) or "warn" (reported only)
    """

    check: str
    code: str
    message: str
    where: Tuple[Tuple[str, str], ...] = ()
    severity: str = "error"

    def as_dict(self) -> dict:
        return {
            "check": self.check,
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "where": dict(self.where),
        }


def finding(
    check: str, code: str, message: str, severity: str = "error", **where
) -> Finding:
    """Build a :class:`Finding` with normalized, hashable context."""
    assert severity in SEVERITIES, severity
    ctx = tuple(sorted((str(k), str(v)) for k, v in where.items()))
    return Finding(
        check=check, code=code, message=message, where=ctx,
        severity=severity,
    )


class VerificationError(ValueError):
    """Raised by ``Report.raise_if_failed`` — carries the full report."""

    def __init__(self, report: "Report"):
        self.report = report
        super().__init__(
            f"static verification failed with "
            f"{len(report.errors)} error finding(s):\n{report.table()}"
        )


@dataclasses.dataclass
class Report:
    """Aggregated verifier output: findings + which passes actually ran
    (a pass that never ran proves nothing — the sweep asserts coverage,
    not just absence of findings)."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    checks_run: List[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def extend(self, check: str, found: List[Finding]) -> "Report":
        self.findings.extend(found)
        if check not in self.checks_run:
            self.checks_run.append(check)
        return self

    def merge(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        for c in other.checks_run:
            if c not in self.checks_run:
                self.checks_run.append(c)
        return self

    def codes(self) -> Tuple[str, ...]:
        return tuple(sorted({f.code for f in self.findings}))

    def table(self) -> str:
        """Fixed-width findings table (empty string when clean)."""
        if not self.findings:
            return ""
        rows = [
            (f.severity.upper(), f.check, f.code, f.message)
            for f in self.findings
        ]
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        w2 = max(len(r[2]) for r in rows)
        return "\n".join(
            f"{r[0]:{w0}s}  {r[1]:{w1}s}  {r[2]:{w2}s}  {r[3]}"
            for r in rows
        )

    def as_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "checks_run": list(self.checks_run),
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "findings": [f.as_dict() for f in self.findings],
        }

    def raise_if_failed(self) -> "Report":
        if not self.ok:
            raise VerificationError(self)
        return self
