"""The O1 policy audit (``apex_tpu/amp/audit.py``): it lives behind the
lint's pass API as :mod:`apex_tpu_torch.analysis.policy` (the
``"policy"`` pass of :func:`apex_tpu_torch.analysis.analyze`).

``amp.audit`` / ``amp.audit_records`` / ``amp.format_report`` keep the
JAX report dict (``{ok, violations, fp32_matmul_count,
custom_call_count}``).  JAX's ``audit_text`` parses StableHLO, which an
eager program does not have; ``audit_records`` audits a capture's
records in its place.  The structured API::

    from apex_tpu_torch import analysis
    report = analysis.analyze(forward, *args, passes=("policy",))
"""

from __future__ import annotations

from apex_tpu_torch.analysis.policy import (  # noqa: F401
    BLACKLIST_POINTWISE,
    audit,
    audit_records,
    format_report,
)

__all__ = ["audit", "audit_records", "format_report", "BLACKLIST_POINTWISE"]
