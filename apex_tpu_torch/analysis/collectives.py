"""Collective-volume lint over a capture's schedule, as
``apex_tpu/analysis/collectives.py`` over compiled HLO.

:func:`collective_table` tallies the collectives of one call by kind:
count, bytes, the sync / async spellings (a blocking call against a
batch of point-to-point operations), channel ids (none in torch), the
distinct ``replica_groups`` and the ops with global device ids; the
``collectives`` pass gates the bytes against a budget, per kind or in
total, so a comm-volume regression fails a lint gate.

The JAX module's regular expressions over HLO text (``collective_attrs``,
``shape_bytes`` and the line parsers) are not ported: an eager program
has no HLO.  The schedule comes from the port's collective wrappers
(:func:`apex_tpu_torch.parallel.distributed.issue`), whose entries carry
what JAX's parsers read off a line.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding


def canon_groups(spelling: str) -> str:
    """Canonical ``{{0,1},{2,3}}`` form of a replica_groups spelling,
    accepting the braces form, the StableHLO ``dense<[[0, 1], [2, 3]]>``
    form, and the iota form (kept verbatim, whitespace-stripped)."""
    s = re.sub(r"\s", "", spelling)
    if "<=" in s:                    # iota spelling has no literal groups
        return s
    inner = re.findall(r"[\[{]([0-9,]*)[\]}]", s)
    return "{" + ",".join("{" + g.strip(",") + "}" for g in inner) + "}"


def _schedule_of(program: Any) -> List[Mapping[str, Any]]:
    """A capture's schedule, or a schedule list itself."""
    if isinstance(program, (list, tuple)):
        return list(program)
    sched = getattr(program, "schedule", None)
    if sched is None:
        raise TypeError(f"expected a Capture or a schedule list, got "
                        f"{type(program).__name__}")
    return list(sched)


def collective_table(program: Any) -> Dict[str, dict]:
    """Per-kind ``{count, bytes, sync, async, channels, replica_groups,
    global_ids}`` of a capture (or a schedule list): ``channels`` the
    sorted distinct channel ids, ``replica_groups`` the distinct
    canonical spellings in first-seen order, ``global_ids`` the entries
    with ``use_global_device_ids`` (JAX's table over compiled HLO)."""
    table: Dict[str, dict] = {}
    for e in _schedule_of(program):
        slot = table.setdefault(e["kind"], {"count": 0, "bytes": 0,
                                            "sync": 0, "async": 0,
                                            "channels": [],
                                            "replica_groups": [],
                                            "global_ids": 0})
        slot["count"] += 1
        slot["bytes"] += int(e["bytes"])
        slot["async" if e.get("variant") == "async" else "sync"] += 1
        ch = e.get("channel_id")
        if ch is not None and ch not in slot["channels"]:
            slot["channels"] = sorted(slot["channels"] + [ch])
        groups = e.get("replica_groups")
        if groups is not None and groups not in slot["replica_groups"]:
            slot["replica_groups"].append(groups)
        slot["global_ids"] += int(bool(e.get("use_global_device_ids")))
    return table


def collective_audit(program: Any) -> Dict[str, dict]:
    """Per-kind ``{count, bytes}`` only (the JAX package's dryrun audit
    shape)."""
    return {kind: {"count": rec["count"], "bytes": rec["bytes"]}
            for kind, rec in collective_table(program).items()}


def collectives_pass(ctx: PassContext,
                     budget: Optional[Mapping[str, int]] = None,
                     ) -> List[Finding]:
    """Collective count/bytes per kind, gated against ``budget``.

    ``budget`` maps a collective kind (``"all-reduce"``, ...) or the
    key ``"total"`` to a maximum byte count; exceeding one is an
    ``error``.  ``{"total": 0}`` asserts the program has no collectives
    at all — the right budget for a single-chip step."""
    table = collective_table(ctx.capture)
    findings = [
        Finding("collectives", "info",
                f"{kind}: {rec['count']} op(s), {rec['bytes']} bytes "
                f"({rec['async']} async / {rec['sync']} sync)",
                op=kind, bytes=rec["bytes"], count=rec["count"])
        for kind, rec in sorted(table.items())]
    budget = dict(budget or {})
    total_cap = budget.pop("total", None)
    for kind, cap in budget.items():
        got = table.get(kind, {}).get("bytes", 0)
        if got > cap:
            findings.append(Finding(
                "collectives", "error",
                f"{kind} volume {got} bytes exceeds budget {cap}",
                op=kind, bytes=got))
    if total_cap is not None:
        total = sum(rec["bytes"] for rec in table.values())
        if total > total_cap:
            findings.append(Finding(
                "collectives", "error",
                f"total collective volume {total} bytes exceeds budget "
                f"{total_cap}", op="total", bytes=total))
    return findings


register_pass("collectives", collectives_pass)
