"""Profile attribution over the torch profiler's chrome trace, as
``apex_tpu/obs/xplane.py`` over an XPlane capture.

The source is the chrome-trace JSON that
``torch.profiler.tensorboard_trace_handler`` or ``prof.export_chrome_trace``
writes (``*.pt.trace.json``, or ``.gz``): a directory holding such files,
or one file.  PyTorch writes no XPlane proto, so the JAX package's
``load_planes`` has no counterpart.

- **Device time** is the sum of the device's events: ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` (the ranges that annotate a span of
  kernels on the device, ``gpu_user_annotation``, would count them
  twice).  On a capture with no device event (the CPU), the ``cpu_op``
  events carry the time instead, as the JAX package falls back to the
  host plane: each op's self time (its duration less the ops nested in
  it on its thread), so that nested ops are not counted twice.  That
  fallback is what makes a CPU smoke possible.
- Durations are picoseconds (the JAX package's unit; the trace's are
  microseconds).

API:

- :func:`op_times` / :func:`parse_xplane` / :func:`parse_trace_json`:
  ``(by_name, by_category, total)`` of one capture, the category being
  the event's ``cat``;
- :func:`step_markers`: the ``ProfilerStep#N`` spans that ``prof.step()``
  records under a profiler schedule;
- :func:`bucket_op_times`: an op-time table folded into named buckets
  through a classifier (the JAX package's, unchanged).
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
import os
from typing import Callable, Counter as TCounter, Dict, List, Optional

__all__ = ["OpTimes", "op_times", "parse_xplane", "parse_trace_json",
           "step_markers", "bucket_op_times"]

#: the trace categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_STEP_PREFIX = "ProfilerStep#"


@dataclasses.dataclass
class OpTimes:
    """Aggregated time of one capture (picoseconds)."""

    by_op: TCounter[str]
    by_category: TCounter[str]
    total_ps: int
    source: str                 # trace-device | trace-host


def _trace_files(logdir: str) -> List[str]:
    if os.path.isfile(logdir):
        return [logdir]
    found = []
    for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz"):
        found += glob.glob(os.path.join(logdir, "**", pattern),
                           recursive=True)
    return sorted(found)


def _events(logdir: str) -> List[dict]:
    out = []
    for path in _trace_files(logdir):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            out += json.load(f).get("traceEvents", [])
    return out


def _ps(us: float) -> int:
    return int(round(float(us) * 1e6))


def _self_times(ops: List[dict]) -> List[tuple]:
    """``(name, cat, self ps)`` of each complete host op: its duration
    less the ops nested in it on the same thread."""
    out = []
    by_thread: Dict[tuple, List[dict]] = collections.defaultdict(list)
    for ev in ops:
        by_thread[(ev.get("pid"), ev.get("tid"))].append(ev)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[list] = []    # [end, index into out]
        for ev in evs:
            start, dur = float(ev["ts"]), float(ev["dur"])
            while stack and stack[-1][0] <= start:
                stack.pop()
            if stack:
                out[stack[-1][1]][2] -= _ps(dur)
            out.append([ev.get("name", "?"), ev.get("cat", "?"), _ps(dur)])
            stack.append([start + dur, len(out) - 1])
    return [tuple(r) for r in out]


def op_times(logdir: str) -> OpTimes:
    """One capture's time by op name and by trace category: the device
    events', or, with none, the host ops' self time (module
    docstring)."""
    by_op: TCounter[str] = collections.Counter()
    by_cat: TCounter[str] = collections.Counter()
    total = 0
    host = []
    for ev in _events(logdir):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "?")
        if cat in DEVICE_CATEGORIES:
            d = _ps(ev["dur"])
            by_op[ev.get("name", "?")] += d
            by_cat[cat] += d
            total += d
        elif cat == "cpu_op":
            host.append(ev)
    if total:
        return OpTimes(by_op, by_cat, total, "trace-device")
    for name, cat, d in _self_times(host):
        by_op[name] += d
        by_cat[cat] += d
        total += d
    return OpTimes(by_op, by_cat, total, "trace-host")


def parse_trace_json(logdir: str):
    """``(by_name, by_category, total_ps)`` of :func:`op_times`."""
    t = op_times(logdir)
    return t.by_op, t.by_category, t.total_ps


def parse_xplane(logdir: str):
    """The JAX package's name for :func:`parse_trace_json`: the
    ``(by_name, by_category, total_ps)`` profile tools read."""
    return parse_trace_json(logdir)


def step_markers(logdir: str) -> List[dict]:
    """The ``ProfilerStep#N`` spans of a capture as ``[{"name",
    "start_ps", "duration_ps"}]``, by start (empty when the capture ran
    without a profiler schedule, which records no step spans)."""
    out = [{"name": ev["name"], "start_ps": _ps(ev["ts"]),
            "duration_ps": _ps(ev["dur"])}
           for ev in _events(logdir)
           if ev.get("ph") == "X" and "dur" in ev
           and str(ev.get("name", "")).startswith(_STEP_PREFIX)
           and ev.get("cat") == "user_annotation"]
    out.sort(key=lambda r: r["start_ps"])
    return out


def bucket_op_times(by_op: Dict[str, int],
                    classify: Callable[[str], Optional[str]],
                    buckets: Optional[List[str]] = None) -> dict:
    """Fold an op -> ps table into named buckets: ``classify(op_name)``
    returns a bucket name or ``None`` (-> ``"other"``).  Returns
    ``{"bucket_ps": {...}, "total_ps": n, "matched_ps": n,
    "fractions": {...}}`` with every requested bucket present (zeros
    included) so a schema over the bucket table never sees a partial
    row."""
    bucket_ps: Dict[str, int] = {b: 0 for b in (buckets or [])}
    bucket_ps.setdefault("other", 0)
    total = 0
    matched = 0
    for name, ps in by_op.items():
        b = classify(name)
        total += ps
        if b is None or (buckets is not None and b not in bucket_ps):
            b = "other"
        else:
            matched += ps
        bucket_ps[b] = bucket_ps.get(b, 0) + ps
    fractions = {b: (round(v / total, 4) if total else 0.0)
                 for b, v in bucket_ps.items()}
    return {"bucket_ps": bucket_ps, "total_ps": int(total),
            "matched_ps": int(matched), "fractions": fractions}
