"""Fleet-level registry merging, as ``apex_tpu/obs/fleet.py``: the one
implementation of cross-replica metric aggregation.

A disaggregated fleet runs one registry per engine (the prefill worker
and every decode replica own their counters, gauges and
``serve_decode_step_seconds`` histogram).  A fleet-level answer ("the
fleet's decode p99", "the tokens the fleet emitted") merges them:

- **counters sum**: each emission increments exactly one engine's;
- **histograms union buckets**: one fixed bucket ladder, counts added,
  then ONE :meth:`~apex_tpu_torch.obs.metrics.Histogram.quantile`
  interpolation over the union (:func:`merged_quantile`), never an
  average of per-replica percentiles, which is not a percentile of
  anything;
- **gauges tabulate**: a last-write-wins scalar has no meaningful sum,
  so gauges come back as a per-replica table (:func:`gauge_table`).

The merges read resolved state only: flush each registry first if its
lag window matters.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.obs.metrics import Counter, Gauge, Histogram, Registry

__all__ = ["merge_histograms", "merged_quantile", "merge_registries",
           "gauge_table", "counter_sum"]


def _window(hist: Histogram, mark) -> Tuple:
    """``(counts, sum, count, max)`` of the window since ``mark``
    (``None`` = the histogram's whole history).  The window's max is
    only known when it SET the running max — the same stale-max guard
    :meth:`Histogram.quantile(since=)` applies, or an excluded
    pre-mark compile step would stretch the overflow bucket."""
    if mark is None:
        return hist.counts.copy(), hist.sum, hist.count, hist._max
    counts = hist.counts - mark[0]
    hi_max = hist._max if hist._max > mark[3] else -math.inf
    return counts, hist.sum - mark[1], hist.count - mark[2], hi_max


def merge_histograms(pairs: Sequence[Tuple[Histogram, Optional[Tuple]]],
                     name: str = "_merged") -> Histogram:
    """Bucket-union of histogram windows: ``pairs`` is
    ``[(histogram, mark-or-None), ...]`` where a mark is a
    :meth:`Histogram.state` snapshot bounding the window (``None``
    takes the whole history).  Every histogram must share the same
    bucket bounds — a union across different ladders silently
    misattributes observations, so it is an error instead."""
    if not pairs:
        raise ValueError("merge_histograms: need at least one histogram")
    bounds = pairs[0][0].bounds
    merged = Histogram(Registry(), name, buckets=bounds)
    for hist, mark in pairs:
        if hist.bounds != bounds:
            raise ValueError(
                f"merge_histograms: {hist.name!r} has different bucket "
                f"bounds than {pairs[0][0].name!r} — a bucket union "
                f"across ladders is not a histogram")
        counts, hsum, count, hi_max = _window(hist, mark)
        merged.counts = merged.counts + counts
        merged.sum += hsum
        merged.count += count
        if hi_max > merged._max:
            merged._max = hi_max
    return merged


def merged_quantile(pairs: Sequence[Tuple[Histogram, Optional[Tuple]]],
                    q: float) -> float:
    """Fleet-level quantile: union the replicas' histogram windows
    (same fixed bucket ladder) and interpolate through the SAME
    :meth:`~apex_tpu_torch.obs.metrics.Histogram.quantile` math a
    single engine's percentiles use, never an average of per-replica
    percentiles."""
    return merge_histograms(pairs).quantile(q)


def counter_sum(registries: Sequence[Registry], name: str) -> float:
    """Sum of one counter across a fleet's registries (a registry
    without the counter contributes 0 — a prefill worker has no
    ``serve_spec_rounds_total``)."""
    total = 0.0
    for reg in registries:
        inst = reg._instruments.get(name)
        if inst is None:
            continue
        if not isinstance(inst, Counter):
            raise TypeError(
                f"counter_sum: {name!r} is a {inst.kind}, not a counter")
        total += inst.value
    return total


def merge_registries(registries: Sequence[Registry]) -> Registry:
    """Merge a fleet's registries into one FRESH registry: counters
    SUM, histograms bucket-union (full history — window one level up
    with :func:`merged_quantile` when marks matter), gauges are
    SKIPPED (a last-write-wins scalar has no meaningful cross-replica
    merge; read them as a table with :func:`gauge_table`).  The
    result is a snapshot, not a sink: a periodic scrape merges into a
    NEW registry each time (merging twice into one would double-count
    — which is why there is no ``into=``).  Pending deferred values
    are NOT resolved here — flush each registry first if the lag
    window matters for the read."""
    out = Registry()
    names: Dict[str, List[Tuple[Registry, object]]] = {}
    for reg in registries:
        with reg._lock:
            for name, inst in reg._instruments.items():
                names.setdefault(name, []).append((reg, inst))
    for name in sorted(names):
        insts = [i for _, i in names[name]]
        kinds = {i.kind for i in insts}
        if len(kinds) != 1:
            raise TypeError(
                f"merge_registries: {name!r} registered as {sorted(kinds)}"
                f" across the fleet — the metric vocabulary must agree")
        first = insts[0]
        if isinstance(first, Counter):
            out.counter(name, first.help)._apply_scalar(
                sum(i.value for i in insts))
        elif isinstance(first, Histogram):
            merged = merge_histograms([(i, None) for i in insts],
                                      name=name)
            tgt = out.histogram(name, first.help, buckets=first.bounds)
            tgt.counts = tgt.counts + merged.counts
            tgt.sum += merged.sum
            tgt.count += merged.count
            if merged._max > tgt._max:
                tgt._max = merged._max
        # gauges: intentionally skipped (see docstring / gauge_table)
    return out


def gauge_table(registries: Sequence[Registry],
                labels: Optional[Sequence[str]] = None
                ) -> Dict[str, Dict[str, float]]:
    """Per-replica gauge values: ``{gauge_name: {label: value}}`` over
    every gauge any registry carries (absent = not listed for that
    replica).  ``labels`` names the columns (default ``"r0"``,
    ``"r1"``, ...) — the disagg tools pass ``["prefill", "replica0",
    ...]``."""
    if labels is None:
        labels = [f"r{i}" for i in range(len(registries))]
    if len(labels) != len(registries):
        raise ValueError(
            f"gauge_table: {len(labels)} labels for "
            f"{len(registries)} registries")
    table: Dict[str, Dict[str, float]] = {}
    for label, reg in zip(labels, registries):
        with reg._lock:
            for name, inst in reg._instruments.items():
                if isinstance(inst, Gauge):
                    table.setdefault(name, {})[label] = float(inst.value)
    return {name: table[name] for name in sorted(table)}
