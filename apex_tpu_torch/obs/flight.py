"""Incident flight recorder: a bounded ring of recent host events, as
``apex_tpu/obs/flight.py``.

A watchdog timeout or a divergence rewind leaves an incident record;
the recorder gives that record its history: the overflows, checkpoints,
faults and rewinds that led to it, not only the final gauges.  Subsystems
note host-side events into a fixed-capacity ring as they go (one dict
and one deque append an event); a long run holds the last ``capacity``
events when the incident fires.

:func:`apex_tpu_torch.resilience.run_resilient` notes step resolutions,
overflows, checkpoints, rewinds, watchdog firings and injected faults,
and every incident it writes embeds :meth:`FlightRecorder.dump` under
the incident schema's optional ``flight`` field
(:func:`apex_tpu_torch.resilience.incidents.validate_incident`).

:meth:`FlightRecorder.note` takes host values only: it is called at step
boundaries where every scalar is already a Python number.
:meth:`FlightRecorder.note_metrics` records a registry's snapshot
(counter and gauge values, histogram count and sum), never a device
read.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of ``{"ts", "kind", ...}`` event records.  ``ts`` is
    seconds since the recorder's construction on the monotonic clock
    (incident timelines need order and spacing, not wall-clock
    epochs)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)

    def note(self, kind: str, **data: Any) -> None:
        """Append one event (host values only); a full ring drops the
        oldest and counts it."""
        if not kind:
            raise ValueError("flight event needs a non-empty kind")
        data["kind"] = kind
        # ts is stamped under the lock: a concurrent noter (the watchdog
        # thread beside the loop) must not append out of ts order, which
        # the incident validator rejects
        with self._lock:
            data["ts"] = round(time.perf_counter() - self._t0, 6)
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(data)

    def note_metrics(self, registry) -> None:
        """One ring event holding a compact snapshot of ``registry``
        (:class:`apex_tpu_torch.obs.metrics.Registry`): counter and gauge
        values, histograms as count and sum."""
        compact: Dict[str, Any] = {}
        for row in registry.snapshot()["metrics"]:
            if row["type"] == "histogram":
                compact[row["name"]] = {"count": row["count"],
                                        "sum": row["sum"]}
            else:
                compact[row["name"]] = row["value"]
        self.note("metrics", values=compact)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def dump(self) -> dict:
        """The ring's tail in the incident ``flight`` shape:
        ``{"capacity", "dropped", "events": [...]}``, oldest first."""
        with self._lock:
            return {"capacity": self.capacity,
                    "dropped": int(self.dropped),
                    "events": [dict(e) for e in self._events]}
