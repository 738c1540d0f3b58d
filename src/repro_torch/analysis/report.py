"""Violation / PassResult containers and the JSON report format (the port
of ``repro.analysis.report``, unchanged in meaning).

Every pass produces one ``PassResult`` per analyzed target (a named
hot-path step on a named config). A result is *clean* when it has no
error-severity violations; warnings (e.g. a declared-unbounded trace
domain) are reported but do not fail the run.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Violation:
    """One broken contract instance, attributed to a pass and a target."""

    pass_name: str
    target: str
    message: str
    severity: str = ERROR
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"[{self.severity}] {self.pass_name} @ {self.target}: {self.message}"


@dataclasses.dataclass
class PassResult:
    """Outcome of running one pass over one target."""

    pass_name: str
    target: str
    violations: list[Violation] = dataclasses.field(default_factory=list)
    checked: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(v.severity == ERROR for v in self.violations)

    def add(self, message: str, severity: str = ERROR, **detail: Any) -> Violation:
        v = Violation(self.pass_name, self.target, message, severity, detail)
        self.violations.append(v)
        return v

    def to_dict(self) -> dict[str, Any]:
        return {
            "pass": self.pass_name,
            "target": self.target,
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
            "checked": self.checked,
        }


def report_payload(results: list[PassResult]) -> dict[str, Any]:
    """Machine-readable summary of a full analysis run."""
    return {
        "ok": all(r.ok for r in results),
        "n_passes": len(results),
        "n_violations": sum(len(r.violations) for r in results),
        "results": [r.to_dict() for r in results],
    }


def render_report(results: list[PassResult], as_json: bool = False) -> str:
    """Human (or JSON) rendering of a full analysis run."""
    if as_json:
        return json.dumps(report_payload(results), indent=2, default=str)
    lines = []
    for r in sorted(results, key=lambda r: (r.pass_name, r.target)):
        mark = "ok " if r.ok else "FAIL"
        extras = " ".join(f"{k}={v}" for k, v in r.checked.items())
        lines.append(f"{mark} {r.pass_name:<12} {r.target:<40} {extras}")
        for v in r.violations:
            lines.append(f"     !! [{v.severity}] {v.message}")
    n_err = sum(1 for r in results for v in r.violations if v.severity == ERROR)
    n_warn = sum(1 for r in results for v in r.violations if v.severity == WARNING)
    lines.append(
        f"-- {len(results)} pass runs, {n_err} errors, {n_warn} warnings --"
    )
    return "\n".join(lines)
