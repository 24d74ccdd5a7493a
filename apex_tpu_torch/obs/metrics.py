"""Process-local metrics registry: counters, gauges, fixed-bucket
histograms, with **lagged** resolution of device values, as
``apex_tpu/obs/metrics.py``.

A training or serving loop that reads a metric the step it was made
waits for that step: the host stops queueing work exactly where the
card's speed lives.  So the registry takes two kinds of value:

- plain host numbers (``int``, ``float``, ``bool``, numpy), applied at
  once (a dict operation's cost: the serve engines and the router record
  these);
- ``torch.Tensor`` values, deferred: appended to the current group, no
  read.  :meth:`Registry.tick` marks a step boundary and seals the group.
  Sealing queues the group's device-to-host copy on the current stream,
  right behind the step that made the values and before any later
  step's kernels: the tensors detached and stacked as fp32 (scalars), or
  kept whole (an array, e.g. a histogram's ``observe`` of many values),
  copied with ``non_blocking=True`` into pinned host buffers, and a CUDA
  event recorded after the copies.  Groups older than ``lag`` steps
  (default 1) become resolvable, and are resolved in batches of
  ``resolve_every`` (default 8): the host waits on each ripe group's
  event and reads its pinned buffers.  With ``lag >= 1`` the host waits
  at most for the step before the one it has just queued, while that one
  keeps the card busy, and never for work it queued after the values (a
  ``.cpu()`` or ``.item()`` at resolve time would wait for every step
  queued since).  A CPU tensor's copy is made at the seal, with the same
  semantics.  A deferred value is at least ``lag`` and at most ``lag +
  resolve_every - 1`` steps stale;
- :meth:`Registry.flush` resolves everything (end of a run, an incident
  snapshot), :meth:`Registry.discard_pending` drops it (a rewind).

Recording a tensor while ``torch.compile`` traces (an instrument called
inside a compiled function) raises ``TypeError``: record on the step's
outputs.

Histograms are fixed-bucket and quantiles are interpolated from the
cumulated bucket counts as Prometheus's ``histogram_quantile`` does, with
the JAX package's buckets and window rule (``quantile(q,
since=Histogram.state())``), so p50 / p99 mean the same in both.
:meth:`Registry.snapshot` writes the JAX package's JSON rows and
:meth:`Registry.to_prometheus` its text exposition, line for line.
:func:`instrument_step` wraps a train step with the JAX package's
``{name}_*`` instruments.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "HostCopy",
    "DEFAULT", "get_registry", "counter", "gauge", "histogram",
    "instrument_step", "LATENCY_BUCKETS",
]

#: histogram bucket upper bounds in seconds: 100 us .. ~26 s, factor 2;
#: the +inf overflow bucket is implicit
LATENCY_BUCKETS = tuple(1e-4 * 2.0 ** i for i in range(19))

#: scalar dtypes whose every value fp32 holds exactly: stacked into one
#: fp32 copy a device; any other tensor is copied whole
_STACKED = (torch.float32, torch.float16, torch.bfloat16, torch.bool,
            torch.uint8, torch.int8, torch.int16)


class HostCopy:
    """The host values of ``tensors``, copied in the order the work that
    made them was queued.

    Construction queues the copies and returns at once: on the card, on
    each device's current stream, the scalars of :data:`_STACKED` dtypes
    stacked as one fp32 tensor and every other tensor whole (bf16 as
    fp32, which numpy lacks), each copied with ``non_blocking=True`` into
    a pinned host buffer, then one CUDA event recorded a device.  A CPU
    tensor is copied at once.  :meth:`result` waits on the events (the
    copies alone, not the work queued after them) and returns one host
    value a tensor: a numpy scalar or array."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._where: List[Tuple[str, Any, int]] = []
        stacks: Dict[torch.device, List[torch.Tensor]] = {}
        self._whole: List[torch.Tensor] = []
        for t in tensors:
            t = t.detach()
            if t.numel() == 1 and t.dtype in _STACKED:
                rows = stacks.setdefault(t.device, [])
                self._where.append(("s", t.device, len(rows)))
                rows.append(t.reshape(()))
            else:
                self._where.append(("w", None, len(self._whole)))
                self._whole.append(t.float() if t.dtype == torch.bfloat16
                                   else t)
        self._stacked: Dict[torch.device, torch.Tensor] = {}
        self._events: List[Any] = []
        by_device: Dict[torch.device, List[Tuple[Any, torch.Tensor]]] = {}
        for dev, rows in stacks.items():
            by_device.setdefault(dev, []).append(
                (("s", dev), torch.stack([r.to(torch.float32)
                                          for r in rows])))
        for i, t in enumerate(self._whole):
            by_device.setdefault(t.device, []).append((("w", i), t))
        for dev, items in by_device.items():
            for (kind, key), t in items:
                if dev.type == "cuda":
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    host.copy_(t, non_blocking=True)
                else:
                    host = t.clone()
                if kind == "s":
                    self._stacked[key] = host
                else:
                    self._whole[key] = host
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._events.append(ev)

    def result(self) -> List[Any]:
        for ev in self._events:
            ev.synchronize()
        self._events = []
        stacked = {d: t.numpy() for d, t in self._stacked.items()}
        return [stacked[dev][i] if kind == "s" else self._whole[i].numpy()
                for kind, dev, i in self._where]


def _classify(value: Any) -> str:
    """``"host"`` | ``"deferred"``; raises while ``torch.compile`` traces
    (recording there is a bug, not a deferral)."""
    if isinstance(value, (int, float, bool, np.generic, np.ndarray)):
        return "host"
    if isinstance(value, torch.Tensor):
        if torch.compiler.is_compiling():
            raise TypeError(
                "metrics must be recorded on step OUTPUTS (tensors "
                "resolve with the registry's lag), never inside a "
                "function torch.compile traces; use "
                "apex_tpu_torch.obs.spans for named regions there")
        return "deferred"
    return "host"


class _Instrument:
    """Base: a named instrument owned by one :class:`Registry`."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str = ""):
        self._registry = registry
        self.name = name
        self.help = help

    def _record(self, value: Any) -> None:
        # the per-step hot case: a plain host number costs a dict op
        if type(value) in (int, float, bool):
            with self._registry._lock:
                self._apply_scalar(float(value))
        elif _classify(value) == "deferred":
            self._registry._defer(self, value)
        else:
            with self._registry._lock:
                self._apply(value)

    def _apply_scalar(self, value: float) -> None:
        self._apply(value)

    def _apply(self, value: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonic accumulator.  ``inc(v)`` adds ``v`` (default 1); a
    deferred tensor adds the sum of its elements once resolved, so
    ``inc(overflow_flag)`` counts a boolean step output."""

    kind = "counter"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self.value = 0.0

    def inc(self, value: Any = 1.0) -> None:
        self._record(value)

    def _apply_scalar(self, value: float) -> None:
        self.value += value

    def _apply(self, value: Any) -> None:
        self.value += float(np.sum(np.asarray(value, dtype=np.float64)))


class Gauge(_Instrument):
    """Last-write-wins scalar.  A deferred tensor resolves to its mean (a
    scalar stays itself)."""

    kind = "gauge"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self.value = 0.0

    def set(self, value: Any) -> None:
        self._record(value)

    def _apply_scalar(self, value: float) -> None:
        self.value = value

    def _apply(self, value: Any) -> None:
        self.value = float(np.mean(np.asarray(value, dtype=np.float64)))


class Histogram(_Instrument):
    """Fixed-bucket histogram over sorted finite upper bounds plus an
    implicit +inf bucket.  ``observe`` takes a scalar or an array (every
    element observed)."""

    kind = "histogram"

    def __init__(self, registry, name, help="",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(registry, name, help)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)) or \
                not all(math.isfinite(b) for b in bounds):
            raise ValueError(
                f"histogram {name!r}: buckets must be strictly "
                f"increasing finite upper bounds, got {buckets!r}")
        self.bounds = bounds
        self.counts = np.zeros(len(bounds) + 1, np.int64)
        self.sum = 0.0
        self.count = 0
        self._max = -math.inf

    def observe(self, value: Any) -> None:
        self._record(value)

    def _apply_scalar(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1
        if value > self._max:
            self._max = value

    def _apply(self, value: Any) -> None:
        arr = np.asarray(value, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(self.bounds, arr, side="left")
        np.add.at(self.counts, idx, 1)
        self.sum += float(arr.sum())
        self.count += arr.size
        self._max = max(self._max, float(arr.max()))

    def state(self) -> Tuple[np.ndarray, float, int, float]:
        """Opaque snapshot for windowed reads: ``quantile(q,
        since=state)`` reads only what was observed after it."""
        return (self.counts.copy(), self.sum, self.count, self._max)

    def quantile(self, q: float, since=None) -> float:
        """Prometheus-style ``histogram_quantile``: rank-interpolated
        inside the owning bucket (lower edge 0 for the first); the +inf
        bucket interpolates toward the largest value seen.  ``nan`` when
        (the window since ``since``, a :meth:`state`) holds no
        observation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        counts, total, hi_max = self.counts, self.count, self._max
        if since is not None:
            counts = counts - since[0]
            total = self.count - since[2]
            # the window's max is known only where it set the running
            # max; a larger one from before the window (a first step's
            # warm-up) must not stretch the overflow bucket, so it falls
            # back to the last finite bound
            if not self._max > since[3]:
                hi_max = -math.inf
        if total <= 0:
            return math.nan
        rank = q * total
        cum = np.cumsum(counts)
        i = min(int(np.searchsorted(cum, rank, side="left")),
                len(counts) - 1)
        lo = 0.0 if i == 0 else self.bounds[i - 1]
        hi = self.bounds[i] if i < len(self.bounds) else \
            (hi_max if math.isfinite(hi_max) else lo)
        in_bucket = counts[i]
        if in_bucket <= 0 or hi <= lo:
            return float(hi)
        prev = cum[i - 1] if i else 0
        frac = (rank - prev) / in_bucket
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))


class Registry:
    """Named instruments with lagged resolution (the module docstring),
    get-or-create: asking twice for one name gives the same instrument;
    asking for it as another kind raises."""

    def __init__(self, lag: int = 1, resolve_every: int = 8):
        if lag < 0:
            raise ValueError(f"lag={lag}")
        if resolve_every < 1:
            raise ValueError(f"resolve_every={resolve_every}")
        self.lag = lag
        self.resolve_every = resolve_every
        # resolved state; a watchdog thread snapshots while the loop
        # records, and no device wait is ever made under this lock
        self._lock = threading.RLock()
        # one resolver at a time, so batches apply in queue order
        self._resolve_lock = threading.Lock()
        # one sealer at a time, so groups queue in step order
        self._seal_lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        # sealed groups, oldest first: (instruments, their HostCopy)
        self._pending: Deque[Tuple[List[_Instrument], HostCopy]] = deque()
        self._current: List[Tuple[_Instrument, Any]] = []

    # -- instrument creation ------------------------------------------

    def _get(self, cls, name: str, help: str, **kwargs) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(self, name, help, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # -- lagged resolution --------------------------------------------

    def _defer(self, instrument: _Instrument, value: Any) -> None:
        with self._lock:
            self._current.append((instrument, value))

    @property
    def pending_groups(self) -> int:
        """Sealed-but-unresolved groups, plus the open one if it holds a
        value."""
        with self._lock:
            return len(self._pending) + (1 if self._current else 0)

    def _seal(self) -> None:
        """Close the current group and queue its host copy (outside
        ``_lock``: queueing is a device call)."""
        with self._seal_lock:
            with self._lock:
                entries, self._current = self._current, []
            if not entries:
                return
            copy = HostCopy([v for _, v in entries])
            with self._lock:
                self._pending.append(([i for i, _ in entries], copy))

    def tick(self) -> None:
        """Step boundary: seal the current group (its copy queued behind
        the step); once ``resolve_every`` groups have aged past ``lag``,
        resolve them.  Free when nothing was deferred (the engines'
        host-number registries tick every step)."""
        if not self._current and not self._pending:
            return
        self._seal()
        self._drain(keep=self.lag, min_batch=self.resolve_every)

    def flush(self) -> None:
        """Resolve everything pending (end of a run, incident capture)."""
        self._seal()
        self._drain(keep=0, min_batch=1)

    def discard_pending(self) -> None:
        """Drop unresolved deferred values (a rewind queues again the
        steps they came from: resolving them would count the abandoned
        timeline)."""
        with self._lock:
            self._pending.clear()
            self._current = []

    def _drain(self, keep: int, min_batch: int) -> None:
        """Pop every group past the newest ``keep``, wait for their
        copies, apply.  ``_resolve_lock`` is held across pop and apply,
        so concurrent resolvers (a loop's ``tick`` racing an exporter's
        ``flush``) apply in queue order: a stale loss never overwrites a
        newer one.  The wait happens outside ``_lock``: a copy waiting on
        a wedged card must not block :meth:`snapshot`, which the
        watchdog's incident capture reads through that lock."""
        with self._resolve_lock:
            with self._lock:
                ripe = len(self._pending) - keep
                if ripe < min_batch:
                    return
                groups = [self._pending.popleft() for _ in range(ripe)]
            values = [(insts, copy.result()) for insts, copy in groups]
            with self._lock:
                for insts, host in values:
                    for inst, v in zip(insts, host):
                        inst._apply(v)

    # -- export --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable export of every instrument's *resolved*
        state, by name, in the JAX package's rows: ``{"name", "type",
        "help", "value"}`` for a counter or gauge, and for a histogram
        ``"buckets"`` (cumulative counts by upper bound, ``"+Inf"``
        last), ``"sum"`` and ``"count"`` (call :meth:`flush` first to
        include the lag window)."""
        out = []
        with self._lock:
            for name in sorted(self._instruments):
                inst = self._instruments[name]
                rec: dict = {"name": name, "type": inst.kind,
                             "help": inst.help}
                if isinstance(inst, Histogram):
                    rec["buckets"] = {
                        _fmt_le(b): int(c) for b, c in
                        zip(inst.bounds + (math.inf,),
                            np.cumsum(inst.counts).tolist())}
                    rec["sum"] = round(float(inst.sum), 9)
                    rec["count"] = int(inst.count)
                else:
                    rec["value"] = float(inst.value)
                out.append(rec)
        return {"metrics": out}

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the resolved state (histograms
        as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
        ``_count``)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._instruments):
                inst = self._instruments[name]
                if inst.help:
                    lines.append(f"# HELP {name} {inst.help}")
                lines.append(f"# TYPE {name} {inst.kind}")
                if isinstance(inst, Histogram):
                    cum = np.cumsum(inst.counts)
                    for b, c in zip(inst.bounds + (math.inf,), cum):
                        lines.append(
                            f'{name}_bucket{{le="{_fmt_le(b)}"}} '
                            f"{int(c)}")
                    lines.append(f"{name}_sum {_fmt_val(inst.sum)}")
                    lines.append(f"{name}_count {inst.count}")
                else:
                    lines.append(f"{name} {_fmt_val(inst.value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every instrument and all pending values (tests)."""
        with self._lock:
            self._instruments.clear()
            self._pending.clear()
            self._current = []


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else repr(round(bound, 12))


def _fmt_val(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(v)


#: the process-default registry, used unless a caller passes its own
DEFAULT = Registry(lag=1)


def get_registry() -> Registry:
    return DEFAULT


def counter(name: str, help: str = "") -> Counter:
    return DEFAULT.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return DEFAULT.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
    return DEFAULT.histogram(name, help, buckets=buckets)


def instrument_step(step_fn: Callable, registry: Optional[Registry] = None,
                    name: str = "train") -> Callable:
    """Wrap a train step with telemetry that never waits for the card:
    the per-call dispatch-latency histogram and the step counter (host
    numbers, applied at once), and, when the step's metrics carry them,
    ``loss`` (gauge), ``overflow`` (counter), ``fp8_amax_saturation``
    (gauge) and ``fp8_rescales`` (counter) recorded as deferred device
    values, resolved with the registry's lag; ``registry.tick()`` runs
    once a call.

    The step is the port's ``step(*batch) -> metrics``
    (:func:`apex_tpu_torch.amp.make_train_step`, which updates its
    ``Amp`` in place) or the JAX package's form returning ``(state,
    metrics)``; the wrapper returns what the step returns.  A per-scaler
    tuple of overflow flags counts each flag.  ``run_resilient`` records
    its own metrics: do not wrap a step handed to it (double counting).
    """
    reg = registry or DEFAULT
    hist = reg.histogram(f"{name}_step_dispatch_seconds",
                         "wall time to dispatch one step (host side; "
                         "not device latency)")
    steps = reg.counter(f"{name}_steps_total", "steps dispatched")
    loss_g = reg.gauge(f"{name}_loss", "last resolved loss (1-step lag)")
    over_c = reg.counter(f"{name}_overflows_total",
                         "loss-scale overflow skips (1-step lag)")
    # the O4 step's fp8 telemetry, recorded only when its metrics carry
    # it: step outputs deferred like the loss
    fp8_sat = reg.gauge(
        f"{name}_fp8_amax_saturation",
        "fp8 dynamic-range utilization of the worst tensor class "
        "(amax * delayed scale / fp8_max; >1 = clipped, 1-step lag)")
    fp8_resc = reg.counter(
        f"{name}_fp8_rescales_total",
        "fp8 overflow-to-rescale events: tensor classes whose delayed "
        "scale shrank after the step's amax roll (1-step lag)")

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = step_fn(*args, **kwargs)
        hist.observe(time.perf_counter() - t0)
        steps.inc()
        m = out if isinstance(out, dict) else (
            out[1] if isinstance(out, tuple) and len(out) == 2
            and isinstance(out[1], dict) else None)
        if m is not None:
            if "loss" in m:
                loss_g.set(m["loss"])
            if "overflow" in m:
                flags = m["overflow"]
                for f in (flags if isinstance(flags, (tuple, list))
                          else (flags,)):
                    over_c.inc(f)
            if "fp8_amax_saturation" in m:
                fp8_sat.set(m["fp8_amax_saturation"])
            if "fp8_rescales" in m:
                fp8_resc.inc(m["fp8_rescales"])
        reg.tick()
        return out

    wrapped.__name__ = getattr(step_fn, "__name__", "step")
    wrapped.__wrapped__ = step_fn
    return wrapped
