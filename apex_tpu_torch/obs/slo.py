"""Declarative SLOs over the live metrics registry, with windowed
burn-rate evaluation, as ``apex_tpu/obs/slo.py``.

An SLO is an objective over instruments the registry already holds
(:mod:`apex_tpu_torch.obs.metrics`): the serve decode-step p99, the
speculative-decoding acceptance rate, block utilization.  The evaluator
reads only the registry's host state (bucket counts, gauge and counter
floats) at the step boundaries, so it reads nothing from the card.

Objective kinds (:class:`SLObjective`):

- ``"quantile"``: over a histogram, ``p_q(metric) <= threshold`` within
  the window.  The objective "p99 <= T" allows ``1 - q`` of observations
  over T (the error budget); ``burn_rate = bad_frac / (1 - q)`` where
  ``bad_frac`` is the windowed fraction of observations over T, and a
  burn above 1 is ``violated``.  ``threshold`` is snapped DOWN to the
  histogram's largest bucket bound at or below it (every observation over
  the threshold is over the snapped bound too, so a violation cannot hide
  between bounds; the objective is judged tighter than declared, never
  looser; the snapped value is recorded);
- ``"gauge"``: the windowed MEAN of a gauge against the threshold
  (``op="le"`` or ``"ge"``); burn = value / threshold (le) or threshold
  / value (ge);
- ``"ratio"``: a windowed counter delta ratio (``ratio_num`` /
  ``ratio_den``), e.g. spec acceptance = accepted / proposed, against the
  threshold with ``op``; burn as for gauges.

Every objective answers ``"met"``, ``"violated"`` or
``"insufficient_window"`` (fewer than ``min_count`` observations or
boundaries in the window: an SLO without data judges nothing).

Consumer: :class:`apex_tpu_torch.serve.DisaggRouter` takes a replica that
violates an objective out of admission (``RouterConfig.slo``).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from apex_tpu_torch.obs import metrics as obs_metrics

__all__ = ["SLObjective", "SLOEvaluator", "STATUS_MET",
           "STATUS_VIOLATED", "STATUS_INSUFFICIENT",
           "serve_objectives"]

STATUS_MET = "met"
STATUS_VIOLATED = "violated"
STATUS_INSUFFICIENT = "insufficient_window"

#: the closed status vocabulary (schemas validate against it)
STATUSES = (STATUS_MET, STATUS_VIOLATED, STATUS_INSUFFICIENT)


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective over a registry instrument.

    ``kind="quantile"``: ``metric`` names a histogram; good means
    ``p_q <= threshold`` (op fixed to ``le`` — latency quantiles).
    ``kind="gauge"``: ``metric`` names a gauge; good means the
    windowed mean ``op`` threshold.  ``kind="ratio"``: good means
    ``delta(ratio_num)/delta(ratio_den)`` ``op`` threshold.  ``window``
    counts EVALUATION BOUNDARIES (one per ``evaluate()`` call — the
    fleet/engine step boundary); ``window=0`` means SINCE-START (the
    evaluator's first boundary is the permanent base — a run-scoped
    objective, quantile/ratio only, that costs one held snapshot
    instead of an unbounded ring).  ``min_count`` is the observations
    (or denominator events, or boundaries for gauges) the window must
    hold before the objective judges at all."""

    name: str
    kind: str
    threshold: float
    metric: str = ""
    op: str = "le"
    q: float = 0.99
    ratio_num: str = ""
    ratio_den: str = ""
    window: int = 32
    min_count: int = 8

    def __post_init__(self):
        if self.kind not in ("quantile", "gauge", "ratio"):
            raise ValueError(f"kind={self.kind!r}: pick 'quantile', "
                             f"'gauge' or 'ratio'")
        if self.op not in ("le", "ge"):
            raise ValueError(f"op={self.op!r}: pick 'le' or 'ge'")
        if self.kind == "quantile" and not 0.0 < self.q < 1.0:
            raise ValueError(f"q={self.q} outside (0, 1)")
        if self.kind == "ratio" and not (self.ratio_num
                                         and self.ratio_den):
            raise ValueError("ratio objectives need ratio_num and "
                             "ratio_den counter names")
        if self.kind in ("quantile", "gauge") and not self.metric:
            raise ValueError(f"{self.kind} objective needs a metric "
                             f"name")
        if self.window < 0 or self.min_count < 1:
            raise ValueError("window must be >= 0 (0 = since-start) "
                             "and min_count >= 1")
        if self.window == 0 and self.kind == "gauge":
            raise ValueError("window=0 (since-start) needs delta/"
                             "bucket semantics — quantile or ratio "
                             "objectives only; give gauges a finite "
                             "window")


def serve_objectives(decode_p99_s: float = 0.5,
                     max_block_util: float = 0.97,
                     min_acceptance: Optional[float] = None,
                     window: int = 32,
                     min_count: int = 8) -> Tuple[SLObjective, ...]:
    """The serving vocabulary: decode-step p99, block-utilization
    headroom, and (for spec engines) the acceptance-rate floor —
    objectives over exactly the instruments the engines already
    export."""
    objs = [
        SLObjective(name="decode_p99", kind="quantile",
                    metric="serve_decode_step_seconds", q=0.99,
                    threshold=decode_p99_s, window=window,
                    min_count=min_count),
        SLObjective(name="block_util", kind="gauge",
                    metric="serve_block_utilization", op="le",
                    threshold=max_block_util, window=window,
                    min_count=min_count),
    ]
    if min_acceptance is not None:
        objs.append(SLObjective(
            name="spec_acceptance", kind="ratio",
            ratio_num="serve_spec_accepted_total",
            ratio_den="serve_spec_proposed_total", op="ge",
            threshold=min_acceptance, window=window,
            min_count=min_count))
    return tuple(objs)


def _snap_threshold(bounds: Sequence[float],
                    threshold: float) -> "Tuple[int, float]":
    """``(bucket_index, bound)`` of the LARGEST bucket bound <=
    threshold — the conservative countable bar: every observation
    truly over the threshold is over the snapped bound too, so a
    violation can never hide between bounds (observations in
    ``(snapped, threshold]`` over-count as bad — tighter, never
    looser).  Index −1 when the threshold sits under the whole
    ladder: nothing is provably under it, so every observation
    counts as exceeding."""
    i = bisect.bisect_right(bounds, threshold) - 1
    return (i, bounds[i]) if i >= 0 else (-1, threshold)


class SLOEvaluator:
    """Evaluate a set of objectives against ONE registry's state, once
    per step boundary.

    Call :meth:`evaluate` at the boundary, after ``Registry.tick()``:
    every read is host state, nothing is fetched from the card.  Keeps a
    bounded ring of
    per-boundary snapshots (histogram states, counter values) so each
    objective is judged over its trailing ``window`` boundaries."""

    def __init__(self, registry: obs_metrics.Registry,
                 objectives: Sequence[SLObjective]):
        self.registry = registry
        self.objectives = tuple(objectives)
        if not self.objectives:
            raise ValueError("no objectives — an empty SLO set judges "
                             "nothing")
        # per-boundary snapshot ring for FINITE windows (bounded at
        # the largest one); since-start objectives (window=0) pin the
        # first boundary's snapshot instead — one held copy, however
        # long the run
        finite = [o.window for o in self.objectives if o.window > 0]
        self._snaps: deque = deque(maxlen=(max(finite) if finite
                                           else 0) + 1)
        self._first: "dict | None" = None
        self.last: Dict[str, dict] = {}

    # -- snapshotting --------------------------------------------------

    def _instrument(self, name: str):
        return self.registry._instruments.get(name)

    def _take_snapshot(self) -> dict:
        snap: dict = {}
        for o in self.objectives:
            if o.kind == "quantile":
                inst = self._instrument(o.metric)
                if isinstance(inst, obs_metrics.Histogram):
                    snap[o.metric] = inst.state()
            elif o.kind == "gauge":
                inst = self._instrument(o.metric)
                if isinstance(inst, obs_metrics.Gauge):
                    snap[o.metric] = float(inst.value)
            else:
                for cname in (o.ratio_num, o.ratio_den):
                    inst = self._instrument(cname)
                    if isinstance(inst, obs_metrics.Counter):
                        snap[cname] = float(inst.value)
        return snap

    def _window_base(self, objective: SLObjective) -> "dict | None":
        """The snapshot ``window`` boundaries ago (or the oldest held
        one while the ring is still priming); for a since-start
        objective the FIRST boundary's snapshot; ``None`` before any
        boundary."""
        if objective.window == 0:
            return self._first
        if not self._snaps:
            return None
        idx = max(0, len(self._snaps) - objective.window)
        return self._snaps[idx]

    # -- evaluation ----------------------------------------------------

    def _eval_quantile(self, o: SLObjective, base) -> dict:
        inst = self._instrument(o.metric)
        rec = {"objective": o.name, "kind": o.kind, "metric": o.metric,
               "q": o.q, "threshold": o.threshold, "window": o.window}
        if not isinstance(inst, obs_metrics.Histogram) or base is None \
                or o.metric not in base:
            rec.update(status=STATUS_INSUFFICIENT, observations=0)
            return rec
        since = base[o.metric]
        counts = inst.counts - since[0]
        total = int(inst.count - since[2])
        rec["observations"] = total
        if total < o.min_count:
            rec["status"] = STATUS_INSUFFICIENT
            return rec
        # exceed count: observations strictly above the bound the
        # threshold snapped DOWN to (buckets are upper-inclusive:
        # value <= bound lands at/under its bucket index).  Snapping
        # down means every true violation is counted and borderline
        # observations in (snapped, threshold] over-count as bad —
        # the objective can only be judged TIGHTER than declared,
        # never looser (the never-fail-open direction); a threshold
        # under the whole ladder counts everything as exceeding.
        i, snapped = _snap_threshold(inst.bounds, o.threshold)
        bad = int(total - counts[:i + 1].sum()) if i >= 0 else total
        bad_frac = bad / total
        budget = 1.0 - o.q
        burn = bad_frac / budget
        rec.update(
            value=round(float(inst.quantile(o.q, since=since)), 9),
            snapped_threshold=snapped,
            bad_frac=round(bad_frac, 6), burn_rate=round(burn, 4),
            status=STATUS_VIOLATED if burn > 1.0 else STATUS_MET)
        return rec

    def _eval_gauge(self, o: SLObjective, base) -> dict:
        rec = {"objective": o.name, "kind": o.kind, "metric": o.metric,
               "op": o.op, "threshold": o.threshold,
               "window": o.window}
        inst = self._instrument(o.metric)
        if not isinstance(inst, obs_metrics.Gauge):
            rec.update(status=STATUS_INSUFFICIENT, observations=0)
            return rec
        # windowed mean over the held per-boundary reads + the live one
        idx = max(0, len(self._snaps) - o.window)
        vals = [s[o.metric] for s in list(self._snaps)[idx:]
                if o.metric in s]
        vals.append(float(inst.value))
        rec["observations"] = len(vals)
        if len(vals) < o.min_count:
            rec["status"] = STATUS_INSUFFICIENT
            return rec
        value = sum(vals) / len(vals)
        rec["value"] = round(value, 9)
        good, burn = _judge(value, o.threshold, o.op)
        rec.update(burn_rate=burn,
                   status=STATUS_MET if good else STATUS_VIOLATED)
        return rec

    def _eval_ratio(self, o: SLObjective, base) -> dict:
        rec = {"objective": o.name, "kind": o.kind, "op": o.op,
               "num": o.ratio_num, "den": o.ratio_den,
               "threshold": o.threshold, "window": o.window}
        num = self._instrument(o.ratio_num)
        den = self._instrument(o.ratio_den)
        if not isinstance(num, obs_metrics.Counter) or \
                not isinstance(den, obs_metrics.Counter) or base is None:
            rec.update(status=STATUS_INSUFFICIENT, observations=0)
            return rec
        dnum = float(num.value) - base.get(o.ratio_num, 0.0)
        dden = float(den.value) - base.get(o.ratio_den, 0.0)
        rec["observations"] = int(dden)
        if dden < o.min_count:
            rec["status"] = STATUS_INSUFFICIENT
            return rec
        value = dnum / dden
        rec["value"] = round(value, 6)
        good, burn = _judge(value, o.threshold, o.op)
        rec.update(burn_rate=burn,
                   status=STATUS_MET if good else STATUS_VIOLATED)
        return rec

    def evaluate(self) -> Dict[str, dict]:
        """One boundary: judge every objective over its trailing
        window of RESOLVED registry state, then append this boundary's
        snapshot to the ring.  Returns (and stores in :attr:`last`)
        ``{objective_name: record}`` with the closed status
        vocabulary."""
        out: Dict[str, dict] = {}
        for o in self.objectives:
            base = self._window_base(o)
            if o.kind == "quantile":
                out[o.name] = self._eval_quantile(o, base)
            elif o.kind == "gauge":
                out[o.name] = self._eval_gauge(o, base)
            else:
                out[o.name] = self._eval_ratio(o, base)
        snap = self._take_snapshot()
        if self._first is None:
            self._first = snap
        self._snaps.append(snap)
        self.last = out
        return out

    def violated(self) -> bool:
        """Any objective in the LAST evaluation violated (insufficient
        windows never count as violations — an SLO without data must
        not de-rank a fresh replica)."""
        return any(r.get("status") == STATUS_VIOLATED
                   for r in self.last.values())

    def summary(self) -> dict:
        """JSON-ready verdict block for artifacts: per-objective
        records + an ``ok`` that is true exactly when nothing is
        violated (insufficient windows are named, not passed off as
        met)."""
        return {"objectives": dict(self.last),
                "ok": not self.violated()}


def _judge(value: float, threshold: float, op: str):
    """``(good, burn_rate)`` for direct-comparison objectives: burn is
    budget utilization — value/threshold for an upper bound,
    threshold/value for a lower one; > 1 means over budget."""
    if op == "le":
        good = value <= threshold
        burn = value / threshold if threshold > 0 else math.inf
    else:
        good = value >= threshold
        burn = threshold / value if value > 0 else math.inf
    return good, round(burn, 4) if math.isfinite(burn) else burn
