"""Always-on continuous profiler + online op-level drift sentinel, as
``apex_tpu/obs/contprof.py``.

Two cooperating pieces:

- :class:`ContinuousProfiler` — every ``capture_every`` steps, wraps
  ``capture_steps`` consecutive step dispatches in one ``torch.profiler``
  capture, exports its chrome trace, parses it through
  :func:`apex_tpu_torch.obs.xplane.keyed_times` (each device event under
  the host op that launched it), buckets the step's keys with the lane's
  classifier (:mod:`apex_tpu_torch.obs.stepclass`), and hands the window
  to the sentinel.  Integration contract (the serve engines, the router
  and ``run_resilient`` follow it): the host loop calls
  :meth:`~ContinuousProfiler.step_begin` before a step dispatch and
  :meth:`~ContinuousProfiler.step_end` after — a ``True`` from
  ``step_begin`` means the step is inside a capture window and its
  latency must be EXCLUDED from the gated latency histogram
  (``serve_decode_step_seconds``).  Inside a window each captured step
  runs in the profiler's root range (``contprof/<name>``,
  :func:`~apex_tpu_torch.obs.stepclass.window_scope`), which the
  classifier's ``step_ops()`` selects.

  **One capture a process.** ``torch.profiler`` is process-wide, as
  ``jax.profiler`` is: a window holds
  :data:`apex_tpu_torch.utils.profiling.capture_lock` (shared with
  ``profiler_start``), and a due window that finds it held, or finds
  another ``torch.profiler`` capture running, is skipped and counted,
  never queued.

  **The card.** On a CUDA device a window captures
  ``ProfilerActivity.CUDA`` beside the host, synchronizes the device when
  it opens (the capture holds only the window's work) and before it
  stops (the capture holds all of it: JAX's ``block_on``), and a window
  whose capture holds no device event is discarded and counted: a card's
  window is never classified by host times.  Steps outside a window pay
  one comparison.  On the CPU the windows classify the host ops' self
  times (the CPU tests).

  The window cost is gated (≤ :data:`~apex_tpu_torch.analysis.obs.
  CONTPROF_BUDGET_PCT`% of the inter-capture step wall) by an
  auto-throttle that widens ``capture_every`` when a window runs over
  budget;

- :class:`DriftSentinel` — compares each window's bucket fractions and
  step wall against the baseline using the ONE sentinel rule in
  :mod:`apex_tpu_torch.analysis.profile_drift` (band = variance-derived
  width when recorded, else the 0.03 default).  A drift is CONFIRMED only
  after ``k`` consecutive out-of-band windows, and on confirmation the
  sentinel notes the flight recorder, writes a schema-valid incident
  naming the drifting bucket and the top offending ops, and flips the
  ``{name}_profile_drift`` gauge the SLO evaluator and the router's
  admission consume.

Two measured departures from the JAX package, both in the window record
(the sentinel rule is JAX's).  The fractions are recorded unrounded (they
sum to 1 to float precision; JAX rounds them to 4 places; the rule
rounds its deltas as JAX's does).  And the window's ``step_wall_s``, the
step time the sentinel judges, is the attributed time of a captured step
(on a card its kernels' device time), measured before any seeding: an
eager decode step is host-bound, and on an H100's shared host
(``chip_smoke.py``'s ``contprof`` phase) its host wall moved by 20–60%
between windows, captured or not, while its device time moved by under
2%, so a band that can see a bucket's move cannot hold the host wall.
The host walls stay in the record: ``host_step_wall_s`` (the captured
steps', JAX's ``step_wall_s``) and ``stream_step_wall_s`` (the mean of
the ``stream_steps`` unprofiled steps since the previous window, the
inter-capture wall the auto-throttle budgets against).

Baselines: :func:`baseline_from_profile` builds one from a
DECODE_PROFILE-shaped document; ``baseline=None`` seeds from the
session's own first clean window (``"first-window"``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from apex_tpu_torch.analysis.profile_drift import (
    DEFAULT_BAND,
    confirm_bucket,
    out_of_band,
)
from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs import xplane
from apex_tpu_torch.obs.stepclass import (
    DECODE_BUCKETS,
    TRAIN_BUCKETS,
    ServeStepClassifier,
    TrainStepClassifier,
    kernel_group,
    window_scope,
)
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.utils import profiling

__all__ = ["ContProfConfig", "ContinuousProfiler", "DriftSentinel",
           "serve_profiler", "train_profiler", "serve_classifier_builder",
           "train_classifier_builder", "baseline_from_profile",
           "drift_objective", "DECODE_BUCKETS", "TRAIN_BUCKETS"]

#: one ``torch.profiler`` capture a process — a profiler whose window
#: comes due while another holds the capture SKIPS it (counted), never
#: queues behind it
_capture_lock = profiling.capture_lock

#: the file a window's chrome trace is exported to, in its directory
TRACE_FILE = "window.pt.trace.json"


@dataclasses.dataclass(frozen=True)
class ContProfConfig:
    """Cadence and bounds of the continuous profiler.

    ``capture_every`` steps between window STARTS (the auto-throttle can
    only widen it); ``capture_steps`` dispatches per window;
    ``warmup_steps`` skipped before the cadence counter starts (the first
    steps must never seed a baseline); ``phase`` offsets the cadence
    (per-replica staggering so fleet windows don't collide on the
    process-wide capture); ``max_overhead_pct`` is the auto-throttle
    budget (window cost as a percentage of the inter-capture step wall;
    ``None`` pins the cadence); ``max_windows`` stops capturing after N
    windows (scripted sessions, tests)."""

    capture_every: int = 256
    capture_steps: int = 2
    warmup_steps: int = 1
    phase: int = 0
    logdir: Optional[str] = None
    keep_top_ops: int = 5
    max_overhead_pct: Optional[float] = 1.0
    max_windows: Optional[int] = None

    def __post_init__(self):
        if self.capture_steps < 1:
            raise ValueError(f"capture_steps={self.capture_steps}")
        if self.capture_every <= self.capture_steps:
            raise ValueError(
                f"capture_every={self.capture_every} must exceed "
                f"capture_steps={self.capture_steps} — a window may "
                f"not overlap the next window's start")
        if self.phase < 0:
            raise ValueError(f"phase={self.phase}")


class DriftSentinel:
    """Online drift confirmation over profile windows (see the module
    docstring).  The observation machine is EXACTLY
    :func:`apex_tpu_torch.analysis.profile_drift.replay_sentinel` run
    incrementally — the validator replays it over the recorded windows
    and must derive the same verdicts."""

    def __init__(self, baseline: Optional[dict] = None,
                 band: float = DEFAULT_BAND,
                 band_source: str = "default",
                 k: int = 2,
                 name: str = "serve",
                 registry: Optional[obs_metrics.Registry] = None,
                 flight: Optional[Any] = None,
                 incident_path: Optional[str] = None):
        if k < 2:
            raise ValueError(
                f"k={k}: a sentinel confirming on a single window "
                f"alarms on every noisy capture — k >= 2")
        if not 0.0 < band < 1.0:
            raise ValueError(f"band={band} outside (0, 1)")
        self.baseline = baseline
        self.band = float(band)
        self.band_source = band_source
        self.k = k
        self.name = name
        self.flight = flight
        self.incident_path = incident_path
        self.drifts: List[dict] = []
        self.incidents: List[dict] = []
        self._run: List[List[dict]] = []
        self._active = False
        self._gauge = None
        if registry is not None:
            self._gauge = registry.gauge(
                f"{name}_profile_drift",
                "1 = the continuous profiler confirmed an op-level "
                "drift (k consecutive out-of-band windows) that has "
                "not yet recovered; consumed by SLO objectives and "
                "router admission")
            self._gauge.set(0.0)

    @property
    def drifting(self) -> bool:
        """A confirmed drift that has not yet recovered (no fully
        in-band window since) — what router admission de-ranks on."""
        return self._active

    def observe(self, window: dict) -> dict:
        """Judge one window; annotates it with ``out_of_band`` and
        returns it.  On the ``k``-th consecutive out-of-band window,
        confirms the drift (incident + flight note + gauge)."""
        if self.baseline is None:
            # first clean window seeds the baseline: in-band by
            # construction, recorded so the validator's replay agrees
            self.baseline = {"source": "first-window",
                             "fractions": dict(window["fractions"]),
                             "step_wall_s": window.get("step_wall_s")}
            window["out_of_band"] = []
            return window
        exc = out_of_band(window["fractions"],
                          window.get("step_wall_s"),
                          self.baseline, self.band)
        window["out_of_band"] = exc
        if not exc:
            self._run = []
            if self._active and self._gauge is not None:
                self._gauge.set(0.0)
            self._active = False
            return window
        self._run.append(exc)
        if not self._active and len(self._run) >= self.k:
            self._confirm(window)
        return window

    def _confirm(self, window: dict) -> None:
        bucket = confirm_bucket(self._run[-self.k:])
        top = [op for op in window.get("top_ops", ())
               if op.get("bucket") == bucket] or \
            list(window.get("top_ops", ()))[:3]
        drift = {"window": window["index"], "bucket": bucket,
                 "windows_out": len(self._run),
                 "band": self.band, "top_ops": top}
        self.drifts.append(drift)
        self._active = True
        if self._gauge is not None:
            self._gauge.set(1.0)
        if self.flight is not None:
            self.flight.note("profile_drift", name=self.name,
                             bucket=bucket, window=window["index"],
                             windows_out=len(self._run))
        self._write_incident(drift)

    def _write_incident(self, drift: dict) -> None:
        # lazy import: resilience.loop imports apex_tpu_torch.obs
        from apex_tpu_torch.resilience import incidents as incidents_lib
        summary = (
            f"continuous profiler confirmed an op-level drift on "
            f"{self.name!r}: bucket {drift['bucket']!r} out of band "
            f"({self.band} {self.band_source}) for "
            f"{drift['windows_out']} consecutive window(s)")
        evidence: List[Any] = [
            f"bucket {drift['bucket']} drifted at window "
            f"{drift['window']} (k={self.k})",
            {"excursions": self._run[-1],
             "baseline": self.baseline,
             "top_ops": drift["top_ops"]}]
        extra: Dict[str, Any] = {"drift": drift}
        if self.flight is not None:
            extra["flight"] = self.flight.dump()
        try:
            if self.incident_path:
                rec = incidents_lib.write_incident(
                    self.incident_path, "profile-drift", summary,
                    evidence, **extra)
            else:
                rec = incidents_lib.make_incident(
                    "profile-drift", summary, evidence, **extra)
            self.incidents.append(rec)
        except Exception:   # forensics must not kill the serving loop
            import traceback
            traceback.print_exc()


class ContinuousProfiler:
    """Sampled capture windows around a host loop's step dispatches (see
    the module docstring for the ``step_begin`` / ``step_end``
    contract).  ``device`` is where the watched steps run (the card by
    default); ``scope`` the root range of each captured step (default
    ``contprof/<name>``)."""

    def __init__(self, buckets=DECODE_BUCKETS,
                 classifier_builder: Optional[Callable[[], Any]] = None,
                 config: Optional[ContProfConfig] = None,
                 sentinel: Optional[DriftSentinel] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 name: str = "serve",
                 device: DeviceLike = None,
                 scope: Optional[str] = None):
        self.config = config or ContProfConfig()
        self.buckets = tuple(buckets)
        self.sentinel = sentinel
        self.name = name
        self.device = resolve_device(device)
        self.scope = scope or window_scope(name)
        self._builder = classifier_builder
        self._clf = None
        self._clf_error: Optional[str] = None
        self.classifier_build_s = 0.0
        #: clean windows, in capture order (what the sentinel judged)
        self.windows: List[dict] = []
        #: windows discarded before the sentinel: an admission dispatch
        #: inside the window, a failed close or parse, or a card's
        #: capture with no device event
        self.discarded: List[dict] = []
        self.skipped_windows = 0
        #: open windows ended unjudged (abort_window: a drain, a failing
        #: step, a dead replica, a rewind's suppress)
        self.aborted_windows = 0
        self._step = 0
        self._in_window = False
        self._owns_capture = False
        self._prof = None
        self._range = None
        self._win_walls: List[float] = []
        #: walls of the steps outside windows since the last window opened
        #: (sum, count), and the interval's the open window samples
        self._stream = [0.0, 0]
        self._win_stream = (0.0, 0)
        self._win_start_step = 0
        self._open_marker = None
        self._capture_t0 = 0.0
        self._logdir = None
        self.effective_every = self.config.capture_every
        #: the step index the next window may open at, RELATIVE to the
        #: last window start/skip/suppression — never an absolute cadence
        #: grid, so a throttle-widened interval (or a skipped or
        #: suppressed window) always buys the FULL new interval
        self._next_start = self.config.warmup_steps + 1 \
            + self.config.phase
        self._m_windows = None
        self._m_skipped = None
        self._m_discarded = None
        if registry is not None:
            self._m_windows = registry.counter(
                f"{name}_profile_windows_total",
                "continuous-profiler capture windows parsed")
            self._m_skipped = registry.counter(
                f"{name}_profile_windows_skipped_total",
                "due windows skipped because another capture held the "
                "process's torch.profiler")
            self._m_discarded = registry.counter(
                f"{name}_profile_windows_discarded_total",
                "capture windows discarded unjudged (admission inside "
                "the window, a failed close or parse, no device event "
                "in a card's capture)")

    # -- classifier ----------------------------------------------------

    @property
    def has_classifier_builder(self) -> bool:
        """True when a classifier source exists — a builder still
        pending, a classifier already built, or a build that failed and
        was recorded.  The loop integrations use this to supply a builder
        exactly once."""
        return (self._builder is not None or self._clf is not None
                or self._clf_error is not None)

    def set_classifier_builder(self, builder: Callable[[], Any]) -> None:
        self._builder = builder

    def _classifier(self):
        if self._clf is None and self._clf_error is None \
                and self._builder is not None:
            t0 = time.perf_counter()
            try:
                self._clf = self._builder()
            except Exception as e:  # noqa: BLE001 — profiling must
                # degrade, not kill the loop it watches
                self._clf_error = f"{type(e).__name__}: {e}"[:200]
            finally:
                # one build per profiler: drop the closure
                self._builder = None
            self.classifier_build_s = round(
                time.perf_counter() - t0, 4)
        return self._clf

    # -- the step hooks ------------------------------------------------

    @property
    def in_window(self) -> bool:
        return self._in_window

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _window_due(self) -> bool:
        cfg = self.config
        if cfg.max_windows is not None and \
                len(self.windows) + len(self.discarded) >= \
                cfg.max_windows:
            return False
        return self._step >= self._next_start

    def _enter_range(self) -> None:
        self._range = torch.profiler.record_function(self.scope)
        self._range.__enter__()

    def _exit_range(self) -> None:
        if self._range is not None:
            rf, self._range = self._range, None
            rf.__exit__(None, None, None)

    def _skip(self) -> bool:
        self.skipped_windows += 1
        if self._m_skipped is not None:
            self._m_skipped.inc()
        # a full interval before the next attempt — skipped, never
        # queued behind the holder
        self._next_start = self._step + self.effective_every
        return False

    def step_begin(self, marker: Any = None) -> bool:
        """Called before a step dispatch; True = this step is inside a
        capture window (EXCLUDE its latency from gated histograms).
        ``marker`` is an opaque contamination cursor (the engine's
        admission-dispatch count): the window is discarded when it moved
        between open and close."""
        self._step += 1
        if self._in_window:
            self._enter_range()
            return True
        if self._step <= self.config.warmup_steps or \
                not self._window_due():
            return False
        if not _capture_lock.acquire(blocking=False):
            return self._skip()
        if profiling.capturing():
            # a torch.profiler capture of the caller's own is running
            _capture_lock.release()
            return self._skip()
        self._owns_capture = True
        if self.config.logdir is not None:
            # a FIXED logdir must be cleared of the previous window's
            # capture before this one writes
            self._logdir = self.config.logdir
            shutil.rmtree(self._logdir, ignore_errors=True)
            os.makedirs(self._logdir, exist_ok=True)
        else:
            self._logdir = tempfile.mkdtemp(
                prefix="apex_tpu_torch_contprof_")
        # ``capture_every`` steps between window STARTS
        self._next_start = self._step + self.effective_every
        self._win_walls = []
        self._win_stream, self._stream = tuple(self._stream), [0.0, 0]
        self._win_start_step = self._step
        self._open_marker = marker
        activities = [torch.profiler.ProfilerActivity.CPU]
        try:
            if self._on_card:
                # the capture holds only the window's work
                torch.cuda.synchronize(self.device)
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._capture_t0 = time.perf_counter()
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        except Exception as e:  # noqa: BLE001 — degrade, never kill
            self._prof = None
            self._discard_unparsed(f"capture start failed: "
                                   f"{type(e).__name__}: {e}")
            return False
        self._in_window = True
        self._enter_range()
        return True

    def step_end(self, wall_s: float, marker: Any = None
                 ) -> Optional[dict]:
        """Called after a step dispatch with its wall seconds; closes
        the window (stop → parse → bucket → sentinel) on the
        ``capture_steps``-th step and returns the window record."""
        if not self._in_window:
            if self._step > self.config.warmup_steps:
                self._stream[0] += float(wall_s)
                self._stream[1] += 1
            return None
        self._exit_range()
        self._win_walls.append(float(wall_s))
        if len(self._win_walls) < self.config.capture_steps:
            return None
        return self._close_window(marker)

    def abort_window(self) -> None:
        """Abort an open capture window without judging it (the loop
        drained, stopped, failed or rewound mid-window): stop the
        capture, release ownership, discard the partial trace.  The
        engines' ``run()``, the router and ``run_resilient``'s exit path
        call this so a half-open window can never leak the capture into
        the next loop."""
        if not self._in_window:
            return
        self._exit_range()
        try:
            self._prof.stop()
        except Exception:  # noqa: BLE001 — the abort path must finish
            pass
        self._prof = None
        self._release()
        self._in_window = False
        self.aborted_windows += 1
        if self._logdir and self.config.logdir is None:
            shutil.rmtree(self._logdir, ignore_errors=True)

    def suppress(self) -> None:
        """Abort any open window and restart the cadence from here — the
        rewind path: a loop re-dispatching an abandoned timeline must not
        feed the sentinel a half-rewound capture.  A full interval must
        elapse before the next window opens."""
        self.abort_window()
        self._next_start = self._step + self.effective_every

    def _release(self) -> None:
        if self._owns_capture:
            self._owns_capture = False
            _capture_lock.release()

    def _discard_unparsed(self, why: str) -> dict:
        """A window that ends before its capture could be judged: the
        capture released, the record discarded and counted."""
        self._release()
        self._in_window = False
        if self._logdir and self.config.logdir is None:
            shutil.rmtree(self._logdir, ignore_errors=True)
        window = {"index": len(self.windows) + len(self.discarded),
                  "start_step": self._win_start_step,
                  "steps": len(self._win_walls),
                  "discarded": why[:200]}
        self._discard(window)
        return window

    def _discard(self, window: dict) -> None:
        self.discarded.append(window)
        if self._m_discarded is not None:
            self._m_discarded.inc()

    def _close_window(self, marker: Any) -> dict:
        # profiling must degrade, not kill the loop it watches: a
        # failing stop/parse becomes a discarded window — and the lock
        # is ALWAYS released, or every later step would be misrouted
        # into the profiled histogram
        stop_err = None
        try:
            if self._on_card:
                # the capture must hold the device work it wraps
                torch.cuda.synchronize(self.device)
        except Exception as e:  # noqa: BLE001
            stop_err = e
        try:
            # ALWAYS attempted, even after a failed synchronize: a
            # capture left open would poison the process's profiler
            prof, self._prof = self._prof, None
            prof.stop()
            if stop_err is None:
                prof.export_chrome_trace(os.path.join(self._logdir,
                                                      TRACE_FILE))
        except Exception as e:  # noqa: BLE001
            stop_err = stop_err or e
        if stop_err is not None:
            return self._discard_unparsed(
                f"capture stop failed: {type(stop_err).__name__}: "
                f"{stop_err}")
        self._release()
        self._in_window = False
        capture_s = time.perf_counter() - self._capture_t0
        t1 = time.perf_counter()
        try:
            window = self._parse_window()
        except Exception as e:  # noqa: BLE001 — a corrupt/empty capture
            # must not propagate into the hot loop
            return self._discard_unparsed(
                f"capture parse failed: {type(e).__name__}: {e}")
        window["capture_s"] = round(capture_s, 6)
        window["parse_s"] = round(time.perf_counter() - t1, 6)
        if self._logdir and self.config.logdir is None:
            shutil.rmtree(self._logdir, ignore_errors=True)
        if self._on_card and window["source"] != "trace-device":
            window["discarded"] = "no device event in a card's capture " \
                "(a card's window is never classified by host times)"
            self._discard(window)
        elif marker != self._open_marker:
            window["discarded"] = "admission/prefill dispatch inside " \
                "the capture window (its launches would misattribute " \
                "time)"
            self._discard(window)
        else:
            t2 = time.perf_counter()
            if self.sentinel is not None:
                self.sentinel.observe(window)
            window["sentinel_s"] = round(time.perf_counter() - t2, 6)
            self.windows.append(window)
            if self._m_windows is not None:
                self._m_windows.inc()
        self._throttle(window)
        return window

    def _parse_window(self) -> dict:
        times = xplane.keyed_times(self._logdir)
        clf = self._classifier()
        walls = self._win_walls
        steps = max(len(walls), 1)
        stream_s, n = self._win_stream
        window: dict = {
            "index": len(self.windows) + len(self.discarded),
            "start_step": self._win_start_step,
            "steps": len(walls),
            "host_step_wall_s": round(sum(walls) / steps, 6),
            "stream_steps": n,
            "stream_step_wall_s": round(stream_s / n, 6) if n else None,
            "total_ps": int(times.total_ps),
            "unattributed_ps": int(times.unattributed_ps),
            "source": times.source,
        }
        if clf is None:
            # degraded mode (no classifier): everything lands in
            # "other"; the sentinel still watches the step time
            window["step_wall_s"] = round(times.total_ps / 1e12 / steps, 6)
            window["fractions"] = {b: 0.0 for b in self.buckets}
            window["fractions"]["other"] = 1.0 if times.total_ps else 0.0
            window["matched_frac"] = 0.0
            window["top_ops"] = []
            if self._clf_error:
                window["classifier_error"] = self._clf_error
            return window
        step_ops = clf.step_ops()
        step_times = {k: ps for k, ps in times.by_key.items()
                      if k in step_ops}
        # the step time judged: measured, never seeded
        window["step_wall_s"] = round(
            sum(step_times.values()) / 1e12 / steps, 6)
        step_times = self._seed(step_times, clf)
        named = [b for b in self.buckets if b not in ("other", "host_gap")]
        table = xplane.bucket_op_times(step_times, clf, buckets=named)
        bucket_ps = dict(table["bucket_ps"])
        total = table["total_ps"]
        window["attributed_ps"] = int(total)
        if "host_gap" in self.buckets:
            # the derived residual: measured wall not attributed to any
            # op (a CPU capture's thread-summed times can exceed the
            # wall — clamp at zero)
            gap = max(0, int(sum(walls) * 1e12) - total)
            bucket_ps["host_gap"] = gap
            total += gap
        window["fractions"] = {
            b: bucket_ps.get(b, 0) / total if total else 0.0
            for b in self.buckets}
        window["matched_frac"] = round(
            table["matched_ps"] / max(table["total_ps"], 1), 4)
        if window["source"] == "trace-device":
            # each kernel group's time by bucket: where the port's kernels
            # landed
            groups: Dict[str, Dict[str, int]] = {}
            for key, ps in step_times.items():
                g = groups.setdefault(kernel_group(key.name), {})
                b = clf(key) or "other"
                g[b] = g.get(b, 0) + int(ps)
            window["groups"] = groups
        top = sorted(step_times.items(), key=lambda kv: -kv[1])
        window["top_ops"] = [
            {"op": key.name[:120], "scopes": list(key.scopes[-3:]),
             "ps": int(ps), "bucket": clf(key) or "other"}
            for key, ps in top[:self.config.keep_top_ops]]
        return window

    def _seed(self, step_times: dict, clf) -> dict:
        """Hook for a scripted seeded-regression session (a subclass
        inflates one bucket's measured op times); identity in
        production."""
        return step_times

    def _throttle(self, window: dict) -> None:
        budget = self.config.max_overhead_pct
        if budget is None:
            return
        cost = window.get("capture_s", 0.0) + \
            window.get("parse_s", 0.0) + window.get("sentinel_s", 0.0)
        # the inter-capture step wall: the unprofiled steps', else the
        # captured steps' own
        wall = window.get("stream_step_wall_s") or \
            window.get("host_step_wall_s") or 0.0
        if wall <= 0 or cost <= 0:
            return
        needed = int(math.ceil(cost / (budget / 100.0 * wall)))
        if needed > self.effective_every:
            self.effective_every = needed
            # re-anchor off the window that just proved the wider
            # interval is needed — the FULL new interval after this
            # window's start
            self._next_start = max(self._next_start,
                                   self._win_start_step + needed)
            window["throttled_to"] = needed


# ---------------------------------------------------------------------------
# integration factories
# ---------------------------------------------------------------------------

def serve_classifier_builder(engine) -> Callable[[], Any]:
    """A lazy :class:`~apex_tpu_torch.obs.stepclass.ServeStepClassifier`
    builder for one engine: the keys under the engine's window range
    (``contprof/<trace_name>``).  A speculative engine's draft launches
    land in ``other``, its verify round's in the buckets."""
    scope = window_scope(engine.trace_name)

    def build():
        return ServeStepClassifier(scope)
    return build


def serve_profiler(engine,
                   config: Optional[ContProfConfig] = None,
                   sentinel: Optional[DriftSentinel] = None,
                   attach: bool = True) -> ContinuousProfiler:
    """A decode-vocabulary profiler for one
    :class:`~apex_tpu_torch.serve.engine.ServeEngine` (or ``SpecEngine``)
    on the engine's device, its windows' root range named after the
    engine's ``trace_name``.  ``attach=True`` sets ``engine.profiler`` so
    the engine's ``step()`` drives the hooks and excludes profiled steps
    from ``serve_decode_step_seconds``."""
    prof = ContinuousProfiler(
        buckets=DECODE_BUCKETS,
        classifier_builder=serve_classifier_builder(engine),
        config=config, sentinel=sentinel, registry=engine.metrics,
        name="serve", device=engine.device,
        scope=window_scope(engine.trace_name))
    if attach:
        engine.profiler = prof
    return prof


def train_profiler(config: Optional[ContProfConfig] = None,
                   sentinel: Optional[DriftSentinel] = None,
                   registry: Optional[obs_metrics.Registry] = None,
                   device: DeviceLike = None) -> ContinuousProfiler:
    """A train-vocabulary profiler for :func:`apex_tpu_torch.resilience.
    run_resilient` (pass it as ``profiler=``) on ``device`` (the card by
    default): the loop supplies the classifier builder on first dispatch
    (:func:`train_classifier_builder`), captures are suppressed across
    rewinds, and the sentinel (when given) gates on the
    fwd / bwd / optimizer / collectives / host_gap vocabulary."""
    return ContinuousProfiler(
        buckets=TRAIN_BUCKETS, classifier_builder=None, config=config,
        sentinel=sentinel, registry=registry, name="train", device=device)


def train_classifier_builder(scope: str = window_scope("train")
                             ) -> Callable[[], Any]:
    """A lazy :class:`~apex_tpu_torch.obs.stepclass.TrainStepClassifier`
    builder over the keys under ``scope`` (the profiler's window range).
    JAX's builder lowers the jitted step; an eager step has nothing to
    lower, so the builder holds no reference to the step or its state."""
    def build():
        return TrainStepClassifier(scope)
    return build


def baseline_from_profile(doc: dict) -> dict:
    """A sentinel baseline from a DECODE_PROFILE-shaped document (its
    ``device_time_fractions``): a stable device makes such fractions
    directly comparable window to window."""
    return {"source": "DECODE_PROFILE",
            "fractions": dict(doc.get("device_time_fractions") or {}),
            "step_wall_s": None}


def drift_objective(name: str = "serve"):
    """An :class:`apex_tpu_torch.obs.slo.SLObjective` over the sentinel's
    ``{name}_profile_drift`` gauge — wire it into ``RouterConfig.slo``
    and a drift-confirmed replica loses admission eligibility until its
    windows recover."""
    from apex_tpu_torch.obs.slo import SLObjective
    return SLObjective(
        name=f"{name}_no_profile_drift", kind="gauge",
        metric=f"{name}_profile_drift", threshold=0.5, op="le",
        window=4, min_count=1)
