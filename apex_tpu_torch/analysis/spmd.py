"""Cross-rank SPMD consistency lint and collective-deadlock detector, as
``apex_tpu/analysis/spmd.py``.

The distributed story (flat-bucket DDP, SyncBatchNorm's statistics, the
elastic fleet that shrinks and regrows) rests on one invariant: *every
rank issues the same collective schedule*.  One rank issuing a different
collective (the fork's signSGD hack was exactly a one-rank payload
divergence) hangs the whole fleet with no diagnostic.  This module
compares schedules across ranks and turns the hang into a named,
gateable finding.

- :func:`collective_schedule` — the program-order collective entries of
  a capture (:class:`~apex_tpu_torch.analysis.capture.Capture`), each
  with the JAX package's identity keys.  :func:`schedule_fingerprint`
  hashes it canonically: for the same schedule list it is JAX's digest,
  the value the runtime preflight exchanges
  (:func:`apex_tpu_torch.parallel.multiproc.spmd_preflight`).
- :func:`diff_schedules` / :func:`compare_lowerings` (JAX's name, over
  captures or schedule lists) — ``spmd-schedule-mismatch`` (a different
  op sequence: the static deadlock), ``spmd-group-mismatch`` (same
  sequence, different replica_groups / channel / region) and
  ``spmd-bytes-mismatch`` (the signSGD class).  Every mismatch names the
  first diverging op in both spellings.
- the registered ``spmd-consistency`` pass: an ``info`` summary with the
  fingerprint, and with ``peers=`` the diff against each peer.

:func:`reshape_pair_findings` is the elastic-fleet corollary: across a
shrink or regrow the groups and bytes change, the opcode sequence must
not.

JAX's ``conditional_collective_findings`` (a collective under a
rank-divergent predicate, found by a taint walk over StableHLO) has no
eager subject: a Python ``if`` leaves no region to walk.  The same bug
class, a collective only some ranks reach, shows as a schedule that ends
early on the others, which the cross-rank diff at the preflight names
(``<end of schedule>``).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from apex_tpu_torch.analysis.collectives import _schedule_of
from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding


def collective_schedule(program: Any) -> List[Dict[str, Any]]:
    """The program-order collective schedule of a capture (or a schedule
    list, returned as a list): entries ``{kind, variant, channel_id,
    replica_groups, use_global_device_ids, dtypes, bytes, region}``."""
    return [dict(e) for e in _schedule_of(program)]


#: entry keys that define schedule identity across ranks
_IDENTITY_KEYS = ("kind", "variant", "channel_id", "replica_groups",
                  "use_global_device_ids", "dtypes", "bytes", "region")
#: the wiring subset — same op sequence, different plumbing
_WIRING_KEYS = ("channel_id", "replica_groups", "use_global_device_ids",
                "variant", "region")
#: the payload subset — the signSGD class
_PAYLOAD_KEYS = ("dtypes", "bytes")


def serialize_schedule(schedule: Sequence[Mapping[str, Any]]) -> str:
    """Canonical JSON of a schedule's identity (stable across ranks
    whose programs are equal; ``lineno`` excluded)."""
    return json.dumps(
        [{k: e.get(k) for k in _IDENTITY_KEYS} for e in schedule],
        sort_keys=True, separators=(",", ":"))


def schedule_fingerprint(schedule: Sequence[Mapping[str, Any]],
                         opcodes_only: bool = False) -> str:
    """sha256 hex digest of the canonical schedule — the value ranks
    exchange in the preflight barrier.  ``opcodes_only=True`` hashes
    just the ``(kind, variant)`` sequence, the invariant that must
    survive a mesh reshape."""
    if opcodes_only:
        payload = json.dumps([[e.get("kind"), e.get("variant")]
                              for e in schedule],
                             separators=(",", ":"))
    else:
        payload = serialize_schedule(schedule)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def format_entry(entry: Optional[Mapping[str, Any]]) -> str:
    """One collective entry as a human-readable spelling —
    ``all-reduce(f32, 32B, groups={{0,...,7}}, channel=1, global-ids)``
    — or ``<end of schedule>`` for a missing entry (length mismatch)."""
    if entry is None:
        return "<end of schedule>"
    parts = [",".join(entry.get("dtypes") or ["?"]),
             f"{entry.get('bytes', 0)}B"]
    if entry.get("replica_groups") is not None:
        parts.append(f"groups={entry['replica_groups']}")
    if entry.get("channel_id") is not None:
        parts.append(f"channel={entry['channel_id']}")
    if entry.get("use_global_device_ids"):
        parts.append("global-ids")
    if entry.get("variant") == "async":
        parts.append("async")
    if entry.get("region"):
        parts.append(f"in {entry['region']}")
    return f"{entry.get('kind', '?')}({', '.join(parts)})"


def first_divergence(a: Sequence[Mapping[str, Any]],
                     b: Sequence[Mapping[str, Any]],
                     keys: Sequence[str] = _IDENTITY_KEYS,
                     ) -> Optional[Tuple[int, str, str]]:
    """First position where two schedules disagree on ``keys``:
    ``(index, spelling_a, spelling_b)``, or ``None`` when equal."""
    for i in range(max(len(a), len(b))):
        ea = a[i] if i < len(a) else None
        eb = b[i] if i < len(b) else None
        if ea is None or eb is None or \
                any(ea.get(k) != eb.get(k) for k in keys):
            return i, format_entry(ea), format_entry(eb)
    return None


def diff_schedules(label_a: str, sched_a: Sequence[Mapping[str, Any]],
                   label_b: str, sched_b: Sequence[Mapping[str, Any]],
                   ) -> List[Finding]:
    """Structural diff of two collective schedules.

    Tiered: a different opcode *sequence* is ``spmd-schedule-mismatch``
    (the static deadlock — one rank enters a collective the other never
    issues); same sequence but different channel wiring / groups /
    region placement is ``spmd-group-mismatch`` (ranks rendezvous on
    mismatched groups); same wiring but different payload dtypes or
    bytes is ``spmd-bytes-mismatch`` (the signSGD class — the bucket
    travels at a different width on one rank).  Each finding names the
    first diverging op in both spellings."""
    kinds = ("kind",)
    d = first_divergence(sched_a, sched_b, kinds)
    if d is not None:
        i, sa, sb = d
        return [Finding(
            "spmd-consistency", "error",
            f"collective schedules diverge at op #{i}: "
            f"{label_a} issues {sa} but {label_b} issues {sb} "
            f"({len(sched_a)} vs {len(sched_b)} collectives) — "
            f"a fleet mixing these lowerings deadlocks here",
            op="spmd-schedule-mismatch", count=i,
            example=f"{label_a}: {sa} | {label_b}: {sb}")]
    findings: List[Finding] = []
    d = first_divergence(sched_a, sched_b, _WIRING_KEYS)
    if d is not None:
        i, sa, sb = d
        findings.append(Finding(
            "spmd-consistency", "error",
            f"same collective sequence but wiring diverges at op #{i}: "
            f"{label_a} issues {sa} but {label_b} issues {sb} "
            f"(replica_groups / channel / region disagree)",
            op="spmd-group-mismatch", count=i,
            example=f"{label_a}: {sa} | {label_b}: {sb}"))
        return findings
    d = first_divergence(sched_a, sched_b, _PAYLOAD_KEYS)
    if d is not None:
        i, sa, sb = d
        findings.append(Finding(
            "spmd-consistency", "error",
            f"same collective sequence but payload diverges at op #{i}: "
            f"{label_a} sends {sa} but {label_b} sends {sb} "
            f"(the signSGD class: one rank's bucket travels at a "
            f"different width)",
            op="spmd-bytes-mismatch", count=i,
            example=f"{label_a}: {sa} | {label_b}: {sb}"))
    return findings


def compare_lowerings(programs: Mapping[str, Any]) -> List[Finding]:
    """Diff N captures (one per rank / mesh): ``{label: capture |
    schedule list}``.  Every label is compared against the first
    (reference) label; findings are the union."""
    items = list(programs.items())
    if len(items) < 2:
        return []
    ref_label, ref_prog = items[0]
    ref_sched = collective_schedule(ref_prog)
    findings: List[Finding] = []
    for label, prog in items[1:]:
        findings.extend(diff_schedules(
            ref_label, ref_sched, label, collective_schedule(prog)))
    return findings


def reshape_pair_findings(label_a: str, prog_a: Any,
                          label_b: str, prog_b: Any) -> List[Finding]:
    """Reshape-compatibility check for an elastic shrink/regrow pair
    (the step captured at two world sizes).  Across a reshape the group
    sizes and bytes legitimately differ; what must survive is the
    *opcode sequence* — emitted as ``spmd-schedule-mismatch`` when it
    doesn't, an ``info`` confirmation when it does."""
    sa, sb = collective_schedule(prog_a), collective_schedule(prog_b)
    d = first_divergence(sa, sb, ("kind", "variant"))
    if d is not None:
        i, spell_a, spell_b = d
        return [Finding(
            "spmd-consistency", "error",
            f"reshape pair {label_a}->{label_b} changes the collective "
            f"sequence at op #{i}: {spell_a} vs {spell_b} — a fleet "
            f"rewound across this reshape deadlocks on its first step",
            op="spmd-schedule-mismatch", count=i,
            example=f"{label_a}: {spell_a} | {label_b}: {spell_b}")]
    return [Finding(
        "spmd-consistency", "info",
        f"reshape pair {label_a}->{label_b} opcode-consistent "
        f"({len(sa)} collectives, opcode fingerprint "
        f"{schedule_fingerprint(sa, opcodes_only=True)[:12]})",
        op="reshape-pair", count=len(sa))]


def spmd_pass(ctx: PassContext,
              peers: Optional[Mapping[str, Any]] = None) -> List[Finding]:
    """The registered ``spmd-consistency`` pass: an ``info`` schedule
    summary carrying the fingerprint the preflight would exchange, and
    with ``peers`` (``{label: capture | schedule}``) the context's
    schedule diffed against each peer."""
    sched = ctx.memo("spmd_schedule",
                     lambda: collective_schedule(ctx.capture))
    findings = [Finding(
        "spmd-consistency", "info",
        f"collective schedule: {len(sched)} op(s), fingerprint "
        f"{schedule_fingerprint(sched)[:12]}",
        op="schedule", count=len(sched))]
    for label, prog in (peers or {}).items():
        findings.extend(diff_schedules(
            "this", sched, label, collective_schedule(prog)))
    return findings


register_pass("spmd-consistency", spmd_pass)
