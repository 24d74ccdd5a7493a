"""Per-request lifecycle tracing across the serving fleet, as
``apex_tpu/obs/reqtrace.py`` (stdlib only).

One request's life can span four engines: enqueue at the router, chunked
prefill on the prefill worker, a KV shipment, decode steps on a replica,
maybe a preemption or a replica death and a re-prefill elsewhere,
retirement.  :class:`RequestTracer` is its record:

- a **request id is minted at router admission** (:meth:`RequestTracer.
  mint`; a standalone engine's first record begins it), and the SAME uid
  follows the request through preemptions, reroutes and re-prefills;
- **events are host records at the step boundaries**: every value is a
  host number the loop already holds (the sampled tokens it streams, slot
  indices, byte counts); nothing is read from the card for tracing;
- the **event vocabulary is closed** (:data:`EVENT_KINDS`): an unknown
  kind raises;
- :meth:`RequestTracer.to_chrome_trace` exports the lifecycles as
  chrome-trace JSON (``ph`` / ``pid`` / ``tid`` / ``ts`` / ``dur``), one
  process row per fleet component, one thread per request.

Event vocabulary (``data`` fields in parentheses; every token-emitting
event carries ``tokens`` so accounting is a sum):

==================  =====================================================
``enqueue``         request entered a queue (``queue_depth``)
``admit``           installed into a slot + prefill sample drawn
                    (``slot``, ``first_token``, ``prompt_len``,
                    ``tokens=1``)
``prefill_chunk``   one prompt chunk run (``start``, ``n_valid``)
``kv_ship``         prefilled KV left the prefill worker (``to_replica``,
                    ``nbytes``)
``kv_install``      shipment written into a replica's pools (``slot``)
``decode_step``     this request's token of one decode step (``step``,
                    ``token``, ``batch`` = active slots, ``tokens=1``)
``spec_draft``      a speculative draft round for this slot (``step``,
                    ``proposed``)
``spec_verify``     the verify round's outcome (``step``, ``accepted``,
                    ``tokens`` = emitted incl. the target's own draw)
``preempt``         evicted, recompute-on-resume continuation queued
                    (``slot``)
``reroute``         rebuilt from the streamed-token log after a replica
                    death and re-queued (``from_replica``)
``retire``          finished; blocks freed (``tokens_out``)
``cow_fork``        a full-prompt prefix match forked its last block
                    copy-on-write (``src_block``, ``dst_block``)
``prefix_hit``      admission matched cached prefix blocks
                    (``matched_tokens``, ``prompt_len``)
``prefix_direct``   the router sent a prefix-hit request straight to a
                    decode replica (``to_replica``, ``matched_tokens``)
==================  =====================================================

The last three are kinds the JAX package's engine and router record but
its vocabulary lacks (there a traced prefix hit raises); here they are
part of the vocabulary, so a traced fleet with prefix sharing runs.

Cost: one dict and one list append per event under a lock.
``tracer=None`` (the default everywhere) is off: engines guard every hook
with one ``is not None`` check.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List

__all__ = ["EVENT_KINDS", "RequestTracer", "spans_of_events"]

#: the closed event vocabulary (see the module docstring's table)
EVENT_KINDS = (
    "enqueue", "admit", "prefill_chunk", "kv_ship", "kv_install",
    "decode_step", "spec_draft", "spec_verify", "preempt", "reroute",
    "retire", "cow_fork", "prefix_hit", "prefix_direct",
)

_KIND_SET = frozenset(EVENT_KINDS)

#: event kinds that emit tokens (their ``tokens`` fields sum to the
#: request's — and transitively the fleet's — token accounting)
TOKEN_KINDS = ("admit", "decode_step", "spec_verify")


def spans_of_events(events: List[dict]) -> List[dict]:
    """Fold one request's event list into its span tree: a root
    ``request`` span covering the whole lifecycle, with one child per
    contiguous run of events at the same ``where`` (the residency
    segments — ``router`` -> ``prefill`` -> ``replica0`` -> ``router``
    -> ... for a rerouted request).  Children are nested within the
    root by construction."""
    if not events:
        return []
    spans = [{"name": "request", "where": "*",
              "t0": events[0]["ts"], "t1": events[-1]["ts"],
              "parent": -1}]
    run_where = events[0]["where"]
    run_t0 = events[0]["ts"]
    last_ts = events[0]["ts"]
    for ev in events[1:]:
        if ev["where"] != run_where:
            spans.append({"name": run_where, "where": run_where,
                          "t0": run_t0, "t1": last_ts, "parent": 0})
            run_where, run_t0 = ev["where"], ev["ts"]
        last_ts = ev["ts"]
    spans.append({"name": run_where, "where": run_where,
                  "t0": run_t0, "t1": last_ts, "parent": 0})
    return spans


class RequestTracer:
    """Fleet-wide per-request event log (see the module docstring).
    One tracer serves a whole fleet: the router hands itself to the
    prefill worker and every replica, each tagged with a ``where``
    label, and all of them record into this one ordered log.

    Retired traces are retained up to ``max_retired`` (oldest dropped
    and counted in :attr:`dropped`), and TOTAL traces are hard-capped
    at ``2 * max_retired`` — a never-retired request (abandoned
    client, a death with nowhere to reroute) must not hold its event
    list forever; when the cap is hit the oldest-minted trace is
    evicted regardless of state.  A serving process lives for months;
    the tracer must not be the leak."""

    def __init__(self, max_retired: int = 4096):
        if max_retired < 1:
            raise ValueError(f"max_retired={max_retired}")
        self.max_retired = max_retired
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._traces: Dict[str, dict] = {}
        self._retired: Deque[str] = deque()
        self._seq = 0
        self._minted = 0

    # -- recording ----------------------------------------------------

    def mint(self, uid: str) -> str:
        """Begin a trace for ``uid`` (router admission — the id's
        birthplace); returns the trace id.  Re-minting an existing uid
        returns the existing trace id (a continuation is the SAME
        request)."""
        with self._lock:
            return self._begin(uid)["trace_id"]

    def _begin(self, uid: str) -> dict:
        tr = self._traces.get(uid)
        if tr is None:
            self._minted += 1
            tr = {"trace_id": f"t{self._minted:05d}", "events": []}
            self._traces[uid] = tr
            # the hard total cap: evict the oldest-minted trace
            # (dict order = mint order) — retired or not — so
            # never-retired requests cannot leak unboundedly
            while len(self._traces) > 2 * self.max_retired:
                old = next(iter(self._traces))
                del self._traces[old]
                try:
                    self._retired.remove(old)
                except ValueError:
                    pass
                self.dropped += 1
        return tr

    def record(self, kind: str, uid: str, where: str,
               **data: Any) -> None:
        """Append one host-side event.  Unknown kinds raise: the
        vocabulary is the contract every consumer (documents, chrome
        export) shares, and a mistyped kind dropped silently from
        analysis is worse than a loud error."""
        if kind not in _KIND_SET:
            raise ValueError(
                f"unknown trace event kind {kind!r}; the vocabulary is "
                f"{EVENT_KINDS}")
        # the per-event hot path: reuse the **data dict instead of
        # building a second one.  ts is stamped INSIDE the lock, with
        # seq: concurrent recorders must not produce seq-increasing
        # events whose ts go backwards
        data["kind"] = kind
        data["where"] = where
        with self._lock:
            tr = self._traces.get(uid)
            if tr is None:
                tr = self._begin(uid)
            self._seq += 1
            data["ts"] = round(time.perf_counter() - self._t0, 6)
            data["seq"] = self._seq
            tr["events"].append(data)
            if kind == "retire":
                self._retired.append(uid)
                while len(self._retired) > self.max_retired:
                    old = self._retired.popleft()
                    if old in self._traces:
                        del self._traces[old]
                        self.dropped += 1

    # -- reading ------------------------------------------------------

    def events(self, uid: str) -> List[dict]:
        """A copy of one request's event list (``[]`` when unknown or
        already dropped)."""
        with self._lock:
            tr = self._traces.get(uid)
            return [dict(e) for e in tr["events"]] if tr else []

    def uids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def tokens_of(self, uid: str) -> int:
        """Token-emitting events' ``tokens`` summed — the request's
        generated-token count as the trace accounts it."""
        return sum(int(e.get("tokens", 0)) for e in self.events(uid))

    def to_doc_requests(self) -> Dict[str, dict]:
        """The ``requests`` section of a trace document: per uid the
        trace id, events, derived span tree and token total."""
        out: Dict[str, dict] = {}
        with self._lock:
            items = [(uid, tr["trace_id"], [dict(e) for e in
                                            tr["events"]])
                     for uid, tr in self._traces.items()]
        for uid, tid, events in items:
            out[uid] = {
                "trace_id": tid,
                "events": events,
                "spans": spans_of_events(events),
                "tokens": sum(int(e.get("tokens", 0)) for e in events),
            }
        return out

    # -- chrome-trace export ------------------------------------------

    def to_chrome_trace(self) -> dict:
        """The lifecycles as chrome-trace JSON (``chrome://tracing`` /
        Perfetto): one process row per ``where`` component, one thread
        per request; residency spans as ``ph: "X"`` duration events,
        point events (preempt/reroute/ship) as ``ph: "i"`` instants.
        Timestamps are microseconds since the tracer's epoch."""
        doc = self.to_doc_requests()
        wheres: List[str] = []
        events: List[dict] = []
        tid_of: Dict[str, int] = {}
        for tid, uid in enumerate(sorted(doc), start=1):
            tid_of[uid] = tid
            for ev in doc[uid]["events"]:
                if ev["where"] not in wheres:
                    wheres.append(ev["where"])
        pid_of = {w: i + 1 for i, w in enumerate(wheres)}
        for w, pid in pid_of.items():
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid,
                           "args": {"name": f"/fleet:{w}"}})
        for uid, tid in tid_of.items():
            for pid in pid_of.values():
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": uid}})
        for uid, rec in doc.items():
            tid = tid_of[uid]
            for sp in rec["spans"]:
                if sp["parent"] == -1:
                    continue        # the root is implied by the row
                events.append({
                    "ph": "X", "name": f"{uid}:{sp['name']}",
                    "pid": pid_of[sp["where"]], "tid": tid,
                    "ts": round(sp["t0"] * 1e6, 3),
                    "dur": round(max(sp["t1"] - sp["t0"], 1e-6) * 1e6,
                                 3),
                    "args": {"trace_id": rec["trace_id"]}})
            for ev in rec["events"]:
                if ev["kind"] not in ("preempt", "reroute", "kv_ship",
                                      "kv_install", "retire"):
                    continue
                events.append({
                    "ph": "i", "s": "t", "name": ev["kind"],
                    "pid": pid_of[ev["where"]], "tid": tid,
                    "ts": round(ev["ts"] * 1e6, 3),
                    "args": {k: v for k, v in ev.items()
                             if k not in ("ts", "kind", "where")}})
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        return {"traceEvents": events,
                "displayTimeUnit": "ms"}
