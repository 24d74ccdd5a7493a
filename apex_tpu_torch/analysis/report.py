"""Structured findings for the lint (:mod:`apex_tpu_torch.analysis`), the
port's copy of ``apex_tpu/analysis/report.py``.

Every lint pass reports through the same two types so results compose: a
:class:`Finding` is one located fact about the program (pass, severity,
op, bytes, message, source line), a :class:`Report` is the ordered
collection for one analyzed program plus the list of passes that ran.
``to_dict()`` and ``format()`` are JAX's, word for word, so either
package's reports read the same.

Severity semantics are the gate contract:

- ``error`` — fails the lint (``Report.ok`` is False): over-budget
  collective bytes, a collective schedule that diverges across ranks.
- ``warning`` — suspicious but not gated by default.
- ``info`` — measurements worth recording (per-kind collective volume,
  the schedule's fingerprint).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One located fact a lint pass reports about the program."""

    pass_name: str
    severity: str
    message: str
    #: op / object the finding is about (an opcode, a collective kind, an
    #: argument path) — whatever locates it for a human.
    op: Optional[str] = None
    dtype: Optional[str] = None
    #: bytes at stake: wasted HBM for a dropped donation, buffer size for
    #: a replicated array or captured constant, volume for collectives.
    bytes: Optional[int] = None
    count: int = 1
    lineno: Optional[int] = None
    example: Optional[str] = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")

    def to_dict(self) -> dict:
        """JSON-ready dict, ``None`` fields omitted (stable wire shape
        for the JSON output lines)."""
        d = {"pass": self.pass_name, "severity": self.severity,
             "message": self.message}
        for k in ("op", "dtype", "bytes", "count", "lineno", "example"):
            v = getattr(self, k)
            if v is not None and not (k == "count" and v == 1):
                d[k] = v
        return d


@dataclasses.dataclass(frozen=True)
class Report:
    """All findings from one analyzed program.

    ``passes`` records which passes actually ran (a pass that ran and
    found nothing is evidence of cleanliness; a pass that never ran is
    not).
    """

    findings: Tuple[Finding, ...] = ()
    passes: Tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        """No ``error``-severity finding (warnings/info don't gate)."""
        return not any(f.severity == "error" for f in self.findings)

    def by_pass(self, name: str) -> List[Finding]:
        return [f for f in self.findings if f.pass_name == name]

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    def merged(self, other: "Report") -> "Report":
        """Combine reports of two programs linted as one unit (e.g. the
        train step's graph passes + the forward's policy pass)."""
        return Report(self.findings + other.findings,
                      self.passes + tuple(p for p in other.passes
                                          if p not in self.passes))

    def to_dict(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        return {"ok": self.ok, "passes": list(self.passes),
                "counts": counts,
                "findings": [f.to_dict() for f in self.findings]}

    def format(self, max_findings: Optional[int] = None) -> str:
        """Human-readable rendering, errors first."""
        order = {s: i for i, s in enumerate(SEVERITIES)}
        ranked = sorted(self.findings,
                        key=lambda f: (order[f.severity], f.pass_name))
        shown = ranked if max_findings is None else ranked[:max_findings]
        lines = [f"graph lint: {'OK' if self.ok else 'FAIL'} — "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.by_severity('warning'))} warning(s) from "
                 f"passes {', '.join(self.passes) or '(none)'}"]
        for f in shown:
            loc = f" (line {f.lineno})" if f.lineno else ""
            extra = "".join(
                f" {k}={v}" for k, v in (("op", f.op), ("dtype", f.dtype),
                                         ("bytes", f.bytes))
                if v is not None)
            cnt = f" x{f.count}" if f.count != 1 else ""
            lines.append(f"  [{f.severity}] {f.pass_name}: "
                         f"{f.message}{extra}{cnt}{loc}")
        if max_findings is not None and len(ranked) > max_findings:
            lines.append(f"  ... {len(ranked) - max_findings} more")
        return "\n".join(lines)


def make_report(findings: Sequence[Finding],
                passes: Sequence[str]) -> Report:
    return Report(tuple(findings), tuple(passes))
