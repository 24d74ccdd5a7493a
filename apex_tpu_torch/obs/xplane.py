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
  through a classifier (the JAX package's, unchanged);
- :func:`keyed_times`: the same capture's time by :class:`OpKey`, each
  device event attributed to the host op that launched it (below): the
  table the step classifiers of :mod:`apex_tpu_torch.obs.stepclass`
  read, where a kernel's name alone cannot tell a forward GEMM from the
  same GEMM in the backward.

**Attribution.** A device event's ``correlation`` names the runtime (or
driver) call that launched it, on the host thread that made the call;
the ranges open on that thread at the call (``record_function`` /
``obs.spans`` ranges, ``cpu_op`` events, the autograd thread's
``autograd::engine::evaluate_function: ...``) are its scopes, outermost
first.  With no such call in the trace, the event's ``External id``
names the innermost op open at the launch, and its scopes are taken
there.  The event's **root** is the innermost range named
``contprof/...`` (:data:`ROOT_PREFIX`), on any thread, whose span holds
the launch: a continuous-profiler window names the step it wraps so, and
the autograd thread's launches fall inside the window's range on the
loop's thread.  On a host capture each ``cpu_op``'s self time is keyed
by its own name under the ranges enclosing it.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
import os
from typing import (Callable, Counter as TCounter, Dict, List, NamedTuple,
                    Optional, Tuple)

__all__ = ["OpTimes", "op_times", "parse_xplane", "parse_trace_json",
           "step_markers", "bucket_op_times", "OpKey", "KeyedTimes",
           "keyed_times", "ROOT_PREFIX"]

#: the trace categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_STEP_PREFIX = "ProfilerStep#"
#: host events that open a range a launch can sit in
_RANGE_CATEGORIES = ("cpu_op", "user_annotation")
#: host events of a launch (the device event's ``correlation``)
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: the name prefix of a window's root range (module docstring)
ROOT_PREFIX = "contprof/"


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



class OpKey(NamedTuple):
    """One attributed op of :func:`keyed_times`: ``root`` (the innermost
    :data:`ROOT_PREFIX` range holding the launch, on any thread; ``""``
    for none), ``scopes`` (the ranges open at the launch on its thread,
    outermost first) and ``name`` (the kernel, memcpy or memset; on a
    host capture the op)."""

    root: str
    scopes: Tuple[str, ...]
    name: str


@dataclasses.dataclass
class KeyedTimes:
    """One capture's time by :class:`OpKey` (picoseconds).  ``total_ps``
    and ``source`` are :func:`op_times`'s; ``unattributed_ps`` is the
    device time whose launch the trace does not hold (keyed with no
    root and no scopes)."""

    by_key: TCounter[OpKey]
    total_ps: int
    source: str                 # trace-device | trace-host
    unattributed_ps: int = 0


#: a host range: (start us, end us, name, the cpu_op event or None)
_Range = Tuple[float, float, str, Optional[dict]]


def _thread(ev: dict) -> tuple:
    return (ev.get("pid"), ev.get("tid"))


def _span(ev: dict) -> Tuple[float, float]:
    start = float(ev["ts"])
    return start, start + float(ev["dur"])


def _enclosing(ranges: Dict[tuple, List[_Range]],
               points: List[tuple]) -> List[Tuple[str, ...]]:
    """For each ``(thread, ts)`` point, the names of the ranges of that
    thread whose span holds ``ts``, outermost first: one sweep a
    thread."""
    out: List[Tuple[str, ...]] = [()] * len(points)
    by_thread: Dict[tuple, List[tuple]] = collections.defaultdict(list)
    for i, (th, ts) in enumerate(points):
        by_thread[th].append((ts, i))
    for th, pts in by_thread.items():
        rs = ranges.get(th, [])
        pts.sort()
        stack: List[tuple] = []       # (end, name)
        j = 0
        for ts, i in pts:
            while j < len(rs) and rs[j][0] <= ts:
                start, end, name, _ = rs[j]
                while stack and stack[-1][0] <= start:
                    stack.pop()
                stack.append((end, name))
                j += 1
            while stack and stack[-1][0] < ts:
                stack.pop()
            out[i] = tuple(n for e, n in stack if e >= ts)
    return out


def _root_of(roots: List[_Range], ts: float) -> str:
    """The innermost root range holding ``ts`` (``""`` for none)."""
    best = None
    for r in roots:
        if r[0] <= ts <= r[1] and (best is None or r[0] >= best[0]):
            best = r
    return best[2] if best is not None else ""


def _keyed_host(ranges: Dict[tuple, List[_Range]],
                roots: List[_Range]) -> TCounter[OpKey]:
    """Each ``cpu_op``'s self time (its duration less the ``cpu_op``
    events nested in it on its thread, as :func:`op_times` counts it),
    keyed under the ranges (annotations too) enclosing it."""
    by_key: TCounter[OpKey] = collections.Counter()
    for rs in ranges.values():
        stack: List[tuple] = []    # (end, name, row index or None)
        rows: List[list] = []      # [scopes, name, self ps, start]
        for start, end, name, ev in rs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            if ev is not None:
                parent = next((f[2] for f in reversed(stack)
                               if f[2] is not None), None)
                if parent is not None:
                    rows[parent][2] -= _ps(ev["dur"])
                rows.append([tuple(f[1] for f in stack), name,
                             _ps(ev["dur"]), start])
            stack.append((end, name, len(rows) - 1 if ev is not None
                          else None))
        for scopes, name, ps, start in rows:
            by_key[OpKey(_root_of(roots, start), scopes, name)] += ps
    return by_key


def keyed_times(logdir: str) -> KeyedTimes:
    """One capture's time by :class:`OpKey`: each device event under the
    host op that launched it, or with no device event each host op's
    self time (module docstring)."""
    events = [ev for ev in _events(logdir)
              if ev.get("ph") == "X" and "dur" in ev]
    ranges: Dict[tuple, List[_Range]] = collections.defaultdict(list)
    roots: List[_Range] = []
    launches: Dict[int, dict] = {}
    ops_by_ext: Dict[int, dict] = {}
    device: List[dict] = []
    for ev in events:
        cat = ev.get("cat", "?")
        args = ev.get("args") or {}
        if cat in DEVICE_CATEGORIES:
            device.append(ev)
        elif cat in _RANGE_CATEGORIES:
            start, end = _span(ev)
            name = ev.get("name", "?")
            ranges[_thread(ev)].append(
                (start, end, name, ev if cat == "cpu_op" else None))
            if cat == "user_annotation" and name.startswith(ROOT_PREFIX):
                roots.append((start, end, name, None))
            if args.get("External id"):
                ops_by_ext.setdefault(args["External id"], ev)
        elif cat in _LAUNCH_CATEGORIES and "correlation" in args:
            launches[args["correlation"]] = ev
    for rs in ranges.values():
        rs.sort(key=lambda r: (r[0], -(r[1] - r[0])))
    if not device:
        by_key = _keyed_host(ranges, roots)
        return KeyedTimes(by_key, int(sum(by_key.values())), "trace-host")
    points: List[Optional[tuple]] = []
    for ev in device:
        args = ev.get("args") or {}
        at = launches.get(args.get("correlation"))
        if at is None:
            at = ops_by_ext.get(args.get("External id"))
        points.append(None if at is None
                      else (_thread(at), float(at["ts"])))
    found = [p for p in points if p is not None]
    scopes = iter(_enclosing(ranges, found))
    by_key: TCounter[OpKey] = collections.Counter()
    total = unattributed = 0
    for ev, pt in zip(device, points):
        d = _ps(ev["dur"])
        total += d
        name = ev.get("name", "?")
        if pt is None:
            unattributed += d
            by_key[OpKey("", (), name)] += d
        else:
            by_key[OpKey(_root_of(roots, pt[1]), next(scopes), name)] += d
    return KeyedTimes(by_key, total, "trace-device", unattributed)
