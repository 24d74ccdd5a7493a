"""Process-local metrics: counters, gauges and fixed-bucket histograms,
as the parts of ``apex_tpu/obs/metrics.py`` that the serve engines, the
router and the SLO evaluator use.

Values are host numbers, applied when recorded.  The JAX package defers
device values and resolves them a step late; in eager PyTorch the engine
records host numbers only, so :meth:`Registry.tick` is a no-op kept for
the engine's step-boundary call.  Histogram buckets and quantile
interpolation are the JAX package's (with its window rule,
``quantile(q, since=Histogram.state())``), so p50/p99 mean the same in both,
and :meth:`Registry.snapshot` writes the JAX package's rows, so a
snapshot in an incident record reads the same from either package.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "DEFAULT",
           "LATENCY_BUCKETS"]

#: histogram bucket upper bounds in seconds: 100 us .. ~26 s, factor 2;
#: the +inf overflow bucket is implicit
LATENCY_BUCKETS = tuple(1e-4 * 2.0 ** i for i in range(19))


class Counter:
    """Monotonic accumulator; ``inc(v)`` adds ``v`` (default 1)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        self.value += float(value)


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram over sorted finite upper bounds plus an
    implicit +inf bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)) or \
                not all(math.isfinite(b) for b in bounds):
            raise ValueError(
                f"histogram {name!r}: buckets must be strictly "
                f"increasing finite upper bounds, got {buckets!r}")
        self.name, self.help = name, help
        self.bounds = bounds
        self.counts = np.zeros(len(bounds) + 1, np.int64)
        self.sum = 0.0
        self.count = 0
        self._max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1
        self._max = max(self._max, value)

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
    """Named instruments, get-or-create: asking twice for one name gives
    the same instrument; asking for it as another kind raises."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        # a watchdog thread snapshots while the loop registers
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kwargs)
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, not {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def tick(self) -> None:
        """Step boundary.  Nothing is deferred in eager mode."""

    def snapshot(self) -> dict:
        """JSON-serializable export of every instrument, by name, in the
        JAX package's rows: ``{"name", "type", "help", "value"}`` for a
        counter or gauge, and for a histogram ``"buckets"`` (cumulative
        counts by upper bound, ``"+Inf"`` last), ``"sum"`` and
        ``"count"``."""
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


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else repr(round(bound, 12))


#: the process-default registry, used unless a caller passes its own
DEFAULT = Registry()
