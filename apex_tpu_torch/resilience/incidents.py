"""Incident-record schema: the machine-readable record a failure leaves,
as ``apex_tpu/resilience/incidents.py`` (the same schema: a record that
either package writes passes both packages' :func:`validate_incident`
and ``tools/gate_hygiene.py``).

When a run dies, or survives something that should have killed it, the
evidence goes into a JSON record with a fixed minimal shape, so that a
tool can check it instead of reading prose.  The resilience loop and its
watchdog write through :func:`write_incident`.  Standard library only.

Schema:

- ``status``    (required, non-empty str): ``"recovered"``,
  ``"preempted"``, ``"watchdog-timeout"``, ...;
- ``utc`` or ``date`` (required, non-empty str): when it happened;
- evidence      (required): a non-empty list of str / dict entries, under
  top-level ``"evidence"``, nested under ``"incident"``, or under any key
  containing ``"evidence"`` (top level or one dict level down);
- ``metrics``   (optional): a registry snapshot
  (:meth:`apex_tpu_torch.obs.metrics.Registry.snapshot`,
  ``{"metrics": [{"name", "type", ...}, ...]}``): what the counters and
  gauges said when the incident fired;
- ``flight``    (optional): the flight recorder's tail
  (:meth:`apex_tpu_torch.obs.flight.FlightRecorder.dump`,
  ``{"capacity": int, "dropped": int, "events": [{"ts": number, "kind":
  str, ...}, ...]}``), events in ``ts`` order and no more than
  ``capacity`` of them;
- anything else is free-form context (``artifact``, ``summary``, ...).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Sequence

SCHEMA_DOC = "status:str, utc|date:str, *evidence*: non-empty list"


def utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _evidence_lists(d: Dict[str, Any]) -> List[Any]:
    """Every value under a key containing ``evidence``, at the top level
    or one dict level down (``incident.evidence``)."""
    found = []
    for key, val in d.items():
        if "evidence" in str(key).lower():
            found.append(val)
        elif isinstance(val, dict):
            for k2, v2 in val.items():
                if "evidence" in str(k2).lower():
                    found.append(v2)
    return found


def validate_incident(obj: Any) -> List[str]:
    """Problems with ``obj`` as an incident record; ``[]`` when valid."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"incident record must be a JSON object, got {type(obj).__name__}"]
    status = obj.get("status")
    if not (isinstance(status, str) and status.strip()):
        problems.append("missing/empty required field 'status' (str)")
    when = obj.get("utc") or obj.get("date")
    if not (isinstance(when, str) and when.strip()):
        problems.append("missing/empty required field 'utc' (or 'date')")
    ev_lists = _evidence_lists(obj)
    good = [e for e in ev_lists if isinstance(e, (list, tuple)) and len(e)]
    if not good:
        problems.append("no non-empty *evidence* list found (top-level or "
                        "nested one level, e.g. incident.evidence)")
    else:
        for lst in good:
            for i, entry in enumerate(lst):
                if not isinstance(entry, (str, dict)):
                    problems.append(
                        f"evidence[{i}] must be str or object, got "
                        f"{type(entry).__name__}")
    problems.extend(_validate_flight(obj.get("flight")))
    snap = obj.get("metrics")
    if snap is not None:
        rows = snap.get("metrics") if isinstance(snap, dict) else None
        if not isinstance(rows, list) or not all(
                isinstance(r, dict) and isinstance(r.get("name"), str)
                and isinstance(r.get("type"), str) for r in rows):
            problems.append(
                "'metrics' present but not a registry snapshot "
                "({'metrics': [{'name': ..., 'type': ...}, ...]})")
    return problems


def _validate_flight(flight: Any) -> List[str]:
    """Problems with an optional ``flight`` field (``[]`` when absent
    or valid): the :meth:`~apex_tpu_torch.obs.flight.FlightRecorder.dump`
    shape, ring metadata and ordered events, each with a numeric ``ts``
    and a non-empty ``kind``."""
    if flight is None:
        return []
    if not isinstance(flight, dict):
        return [f"'flight' must be an object, got "
                f"{type(flight).__name__}"]
    problems: List[str] = []
    cap = flight.get("capacity")
    if not (isinstance(cap, int) and not isinstance(cap, bool)
            and cap >= 1):
        problems.append("flight.capacity must be an int >= 1")
    dropped = flight.get("dropped")
    if not (isinstance(dropped, int) and not isinstance(dropped, bool)
            and dropped >= 0):
        problems.append("flight.dropped must be an int >= 0")
    events = flight.get("events")
    if not isinstance(events, list):
        problems.append("flight.events must be a list")
        return problems
    if isinstance(cap, int) and not isinstance(cap, bool) \
            and len(events) > cap:
        problems.append(
            f"flight holds {len(events)} events over its stated "
            f"capacity {cap} — a ring that overflows its own bound is "
            f"a contradiction")
    last_ts = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"flight.events[{i}] must be an object")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            problems.append(f"flight.events[{i}] missing numeric 'ts'")
        elif last_ts is not None and ts < last_ts:
            problems.append(
                f"flight.events[{i}] ts {ts} precedes its predecessor "
                f"{last_ts} — ring events must be ordered")
        else:
            last_ts = ts
        kind = ev.get("kind")
        if not (isinstance(kind, str) and kind.strip()):
            problems.append(
                f"flight.events[{i}] missing non-empty str 'kind'")
    return problems


def make_incident(status: str, summary: str,
                  evidence: Sequence[Any], **extra: Any) -> Dict[str, Any]:
    """Assemble a schema-valid incident dict; raises ``ValueError`` on an
    invalid one (a writer must not emit what its validator rejects)."""
    rec: Dict[str, Any] = {
        "artifact": extra.pop("artifact", "apex_tpu_torch.resilience incident record"),
        "status": status,
        "utc": utc_now(),
        "summary": summary,
        "evidence": list(evidence),
    }
    rec.update(extra)
    problems = validate_incident(rec)
    if problems:
        raise ValueError(f"refusing to write invalid incident: {problems}")
    return rec


def write_incident(path: str, status: str, summary: str,
                   evidence: Sequence[Any], **extra: Any) -> Dict[str, Any]:
    """Write an incident record atomically (a temporary file, fsync, then
    a rename: a watchdog firing mid-crash must not leave half a record)
    and return it."""
    rec = make_incident(status, summary, evidence, **extra)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return rec


def validate_incident_file(path: str) -> List[str]:
    """Validate one record on disk; a file that does not parse is a
    schema failure (a truncated record is what this catches)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable incident JSON: {e}"]
    return validate_incident(obj)
