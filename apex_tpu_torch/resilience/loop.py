"""Self-healing training loop: watchdog, IO retry, divergence rewind, as
``apex_tpu/resilience/loop.py``, in PyTorch's idiom: the state lives on
an :class:`~apex_tpu_torch.amp.Amp` (its model, optimizer, scalers and
step count), and the step is the port's ``step(*batch) -> metrics``
(:func:`apex_tpu_torch.amp.make_train_step`), which updates that state
in place.  :func:`run_resilient` checkpoints, rewinds and re-scales the
``Amp`` itself.

- **step watchdog**: a monitor thread tracks the wall clock of each step;
  a step that neither dispatches nor resolves within the budget writes an
  incident record (with the loop thread's stack as evidence) and ends the
  run with :class:`WatchdogTimeout` instead of a silent wedge.  The
  monitor can only interrupt a wait in Python (``interrupt_main``); a
  wedged CUDA call still gets its incident written within the budget:
  the record, not the unstick, is the contract.
- **IO retry**: checkpoint save and restore run through :func:`retry_io`
  (bounded attempts, exponential backoff), so a flaky filesystem is
  absorbed instead of ending the run.
- **divergence sentinel**: tells amp's normal overflow skip (the scale
  halves, training goes on) from a pathological state: ``K`` overflows
  in a row with the scale pinned at its floor
  (``metrics["pinned_at_floor"]``), or a non-finite loss outside an
  overflow skip.  Response: rewind to the last good checkpoint with a
  re-initialized scaler; after ``max_rewinds`` rewinds, fail with a
  structured incident instead of looping.

The loop adds no host sync on the step path: it queues steps back to
back, and right after each step queues that step's metrics (loss,
overflow, pinned) for one device-to-host copy into pinned memory with a
CUDA event behind it (:class:`~apex_tpu_torch.obs.metrics.HostCopy`), on
the current stream, before any later step's kernels.  It reads them one
step later (``sentinel_lag``): the wait is for that copy alone, while
the next step keeps the card busy.  Only a checkpoint step reads a
device value more: whether the masters are all finite (one K15 launch).
The loop's overhead on the card is measured by ``chip_smoke.py``'s
``resilience`` phase (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.obs.flight import FlightRecorder
from apex_tpu_torch.resilience import incidents as incidents_lib
from apex_tpu_torch.resilience.durable import host_copies
from apex_tpu_torch.resilience.faults import FaultInjector, SimulatedPreemption


class WatchdogTimeout(RuntimeError):
    """A step exceeded the wall-clock budget; an incident was recorded."""


class DivergenceError(RuntimeError):
    """A pathological state persisted past the rewind budget (or there was
    nothing to rewind to); an incident was recorded."""


def retry_io(fn: Callable[[], Any], retries: int = 3,
             backoff_s: float = 0.05,
             on_retry: Optional[Callable[[int, BaseException], None]] = None
             ) -> Any:
    """Run ``fn`` with bounded retries and exponential backoff on
    ``OSError`` (the checkpoint IO failure class; anything else is a bug
    and propagates at once)."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2.0 ** (attempt - 1)))


@dataclasses.dataclass
class ResilienceConfig:
    watchdog_timeout_s: float = 300.0
    watchdog_poll_s: float = 0.05
    checkpoint_every: int = 0          # 0: no checkpointing
    io_retries: int = 3
    io_backoff_s: float = 0.05
    max_rewinds: int = 2
    overflow_patience: int = 4         # K pinned-at-floor overflows
    sentinel_lag: int = 1              # steps to lag metric resolution
    incident_path: Optional[str] = None  # where incident records go
    #: called as ``preflight(state)`` after every rewind, before the loop
    #: steps again: a check that the restored state still fits the run
    #: (a raise aborts the run with a ``preflight-failed`` incident)
    preflight: Optional[Callable[[Any], Any]] = None


@dataclasses.dataclass
class RunResult:
    state: Any
    steps_completed: int
    losses: List[Tuple[int, float]]
    rewinds: int
    events: List[dict]
    incidents: List[dict]
    #: the loop's flight recorder (step, overflow, checkpoint, fault and
    #: rewind events); a caller's own incident records embed its dump()
    flight: Optional[FlightRecorder] = None


def _tensors_of(state: Any) -> List[torch.Tensor]:
    """The tensors of a state that is not an ``Amp``: a module's
    ``state_dict()`` values, or the tensors of a (nested) container."""
    import torch.utils._pytree as pytree
    if isinstance(state, torch.nn.Module):
        return list(state.state_dict().values())
    return [t for t in pytree.tree_leaves(state)
            if isinstance(t, torch.Tensor)]


def _host_scalars(m: Dict[str, Any]
                  ) -> Callable[[], Tuple[float, bool, bool]]:
    """Queue the copy of a step's ``(loss, overflow, pinned)`` now, right
    behind the step, and return the function that reads them later; a
    per-scaler tuple counts when any of its scalers does."""
    def items(v):
        return list(v) if isinstance(v, (tuple, list)) else [v]
    over = items(m.get("overflow", False))
    pinned = items(m.get("pinned_at_floor", False))
    parts = [m["loss"]] + over + pinned
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    copy = obs_metrics.HostCopy(tensors) if tensors else None

    def read() -> Tuple[float, bool, bool]:
        host = iter(copy.result() if copy is not None else [])
        vals = [np.asarray(next(host) if isinstance(p, torch.Tensor) else p,
                           dtype=np.float64).reshape(-1) for p in parts]
        flags = [bool(v.any()) for v in vals[1:]]
        return (float(vals[0][0]), any(flags[:len(over)]),
                any(flags[len(over):]))
    return read


def run_resilient(
    step_fn: Callable,
    state: Any,
    batches: Union[Sequence[Any], Callable[[int], Any]],
    num_steps: int,
    manager: Any = None,
    config: Optional[ResilienceConfig] = None,
    injector: Optional[FaultInjector] = None,
    registry: Optional[obs_metrics.Registry] = None,
    flight: Optional[FlightRecorder] = None,
    start_step: int = 0,
    fleet_metrics: Optional[Any] = None,
    profiler: Optional[Any] = None,
) -> RunResult:
    """Drive ``step_fn(*batch) -> metrics`` over steps ``start_step`` to
    ``num_steps - 1`` with the protections of the module docstring.

    ``state`` is what the steps change in place: an
    :class:`~apex_tpu_torch.amp.Amp` (checkpointed through
    :mod:`apex_tpu_torch.checkpoint`; a rewind also re-initializes its
    loss scalers), or a module or container of tensors (snapshotted as
    host copies of its tensors, restored by ``copy_``).  ``batches`` is a
    sequence or a ``step -> batch`` callable (a batch is a tuple of step
    arguments or one tensor).  ``metrics`` holds ``loss`` and, from an
    amp step, ``overflow`` and ``pinned_at_floor`` (device tensors; read
    one step later).  ``manager`` (a
    :class:`~apex_tpu_torch.resilience.durable.DurableCheckpointManager`)
    enables checkpoints on disk and checksum-verified rewinds; without
    one, a host copy taken at the same cadence backs the rewind.
    ``start_step`` resumes a run at that step (after a restore).
    ``fleet_metrics`` (a
    :class:`~apex_tpu_torch.resilience.fleet.FleetMetrics`) hooks the
    elastic fleet's ``train_fleet_*`` instruments: ``on_resolve()`` at
    each lag-resolved step, ``on_rewind()`` at a rewind.

    The loop records into ``registry`` (default: the shared
    :data:`apex_tpu_torch.obs.metrics.DEFAULT`) the counters
    ``train_steps/overflows/rewinds/checkpoints_total``, the gauge
    ``train_loss`` and ``train_watchdog_margin_s`` (the budget minus a
    step's observed wall at resolve time), at the points where those
    values are already host numbers.  Incident records embed the
    registry's snapshot and the ``flight`` recorder's tail (``flight=``
    to share one across restarts; default a fresh 256-event ring,
    returned on :attr:`RunResult.flight` either way).

    On a :class:`~apex_tpu_torch.resilience.faults.SimulatedPreemption`
    (or a ``KeyboardInterrupt`` that is not the watchdog's), queued saves
    are flushed and an incident recorded (status ``preempted`` /
    ``interrupted``) before the exception propagates: the next process's
    ``manager.restore`` lands on the last good snapshot.

    ``profiler`` (a :class:`apex_tpu_torch.obs.contprof.ContinuousProfiler`,
    usually from :func:`apex_tpu_torch.obs.contprof.train_profiler`) turns
    on continuous profiling: every ``capture_every`` dispatches a short
    window is captured around the step dispatch and bucketed into the
    train vocabulary (fwd / bwd / optimizer / collectives / host_gap);
    the loop supplies the classifier, built at the first window close.
    A rewind SUPPRESSES capture (an open window is aborted and the
    cadence restarts: the sentinel never judges a half-rewound capture),
    and a window still open when the loop exits is aborted.  Outside a
    window the step path is unchanged (the metrics' copy is queued right
    behind the step as before).
    """
    cfg = config or ResilienceConfig()
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.amp.frontend import Amp
    from apex_tpu_torch.amp.scaler import all_finite

    is_amp = isinstance(state, Amp)
    if callable(batches):
        batch_fn = batches
    else:
        batch_fn = lambda i: batches[i]  # noqa: E731

    events: List[dict] = []
    written_incidents: List[dict] = []
    losses: List[Tuple[int, float]] = []

    fr = flight if flight is not None else FlightRecorder()
    seen_inj = len(injector.events) if injector is not None else 0

    reg = registry if registry is not None else obs_metrics.DEFAULT
    m_steps = reg.counter("train_steps_total",
                          "train steps resolved (1-step lag)")
    m_over = reg.counter("train_overflows_total",
                         "loss-scale overflow skips")
    m_rewinds = reg.counter("train_rewinds_total",
                            "divergence rewinds executed")
    m_ckpts = reg.counter("train_checkpoints_total",
                          "checkpoints committed (or snapshotted)")
    m_loss = reg.gauge("train_loss", "last resolved loss (1-step lag)")
    m_margin = reg.gauge(
        "train_watchdog_margin_s",
        "watchdog budget minus observed step wall at resolve")

    # -- watchdog ---------------------------------------------------------
    inflight: Dict[int, float] = {}
    lock = threading.Lock()
    abort = threading.Event()
    stop = threading.Event()
    # the thread driving this loop: its stack is the hang evidence, and
    # interrupt_main only helps when it is the main thread
    entry_thread = threading.current_thread()

    def _note_new_faults() -> None:
        """Mirror newly fired injector events into the flight ring (after
        each dispatch and before every incident write)."""
        nonlocal seen_inj
        if injector is None:
            return
        # under the loop lock: the watchdog thread mirrors too
        with lock:
            fresh = injector.events[seen_inj:]
            seen_inj = len(injector.events)
        for ev in fresh:
            # the injector's keys may collide with the ring's own
            # (CorruptCheckpoint records kind="truncate"): prefix those
            fr.note("fault", **{
                ("fault_" + k if k in ("kind", "ts") else k): v
                for k, v in ev.items() if k != "utc"})

    def _write_incident(status: str, summary: str,
                        evidence: List[Any], **extra: Any) -> None:
        try:
            # the registry's host state (never a device read: the device
            # may be the thing that hung) and the flight ring's tail
            _note_new_faults()
            extra.setdefault("metrics", reg.snapshot())
            extra.setdefault("flight", fr.dump())
            if cfg.incident_path:
                rec = incidents_lib.write_incident(
                    cfg.incident_path, status, summary, evidence, **extra)
            else:
                rec = incidents_lib.make_incident(status, summary, evidence,
                                                  **extra)
            written_incidents.append(rec)
        except Exception:  # writing a record must not mask the failure
            traceback.print_exc()

    def _monitor() -> None:
        while not stop.wait(cfg.watchdog_poll_s):
            with lock:
                if not inflight:
                    continue
                step_i, t0 = min(inflight.items(), key=lambda kv: kv[1])
            elapsed = time.monotonic() - t0
            if elapsed <= cfg.watchdog_timeout_s:
                continue
            frame = sys._current_frames().get(entry_thread.ident)
            frames = traceback.format_stack(frame) if frame is not None \
                else None
            fr.note("watchdog", step=step_i,
                    elapsed_s=round(elapsed, 3),
                    budget_s=cfg.watchdog_timeout_s)
            _write_incident(
                "watchdog-timeout",
                f"step {step_i} exceeded the {cfg.watchdog_timeout_s}s "
                "wall-clock budget; aborting instead of wedging (r02 "
                "mitigation)",
                [f"step {step_i} in flight {elapsed:.3f}s > budget "
                 f"{cfg.watchdog_timeout_s}s"]
                + ([{"main_thread_stack": frames[-6:]}] if frames else []),
            )
            abort.set()
            if entry_thread is threading.main_thread():
                # break a wait in Python; a loop driven from another
                # thread sees the abort flag at its next step
                import _thread
                _thread.interrupt_main()
            return

    monitor = threading.Thread(target=_monitor, daemon=True,
                               name="apex-tpu-torch-watchdog")
    monitor.start()

    # -- rewind machinery -------------------------------------------------
    rewinds = 0
    consecutive_pinned = 0
    # (step, ("amp", checkpoint state_dict) | ("tensors", host copies))
    mem_snapshot: Optional[Tuple[int, Any]] = None

    def _reinit_scaler() -> None:
        if is_amp:
            dev = state.step.device
            state.scaler_states = [state.scaler.init_state(dev)
                                   for _ in state.scaler_states]

    def _save(step_i: int) -> None:
        watched = list(state.masters.values()) if is_amp \
            else _tensors_of(state)
        if not bool(all_finite(watched)):
            events.append({"event": "checkpoint_skipped_nonfinite",
                           "step": step_i})
            fr.note("checkpoint_skipped_nonfinite", step=step_i)
            return
        nonlocal mem_snapshot
        if manager is not None:
            retry_io(lambda: manager.save(step_i, state),
                     retries=cfg.io_retries, backoff_s=cfg.io_backoff_s,
                     on_retry=lambda a, e: events.append(
                         {"event": "save_retry", "step": step_i,
                          "attempt": a, "error": repr(e)}))
        elif is_amp:    # managerless runs rewind from a host copy
            mem_snapshot = (step_i, ("amp", ckpt.state_dict(state)))
        else:
            mem_snapshot = (step_i, ("tensors", host_copies(watched)))
        events.append({"event": "checkpoint", "step": step_i})
        m_ckpts.inc()
        fr.note("checkpoint", step=step_i)
        # the resolved metrics riding the checkpoint cadence
        fr.note_metrics(reg)

    def _rewind(reason: str) -> int:
        nonlocal rewinds, consecutive_pinned
        rewinds += 1
        consecutive_pinned = 0
        if rewinds > cfg.max_rewinds:
            _write_incident(
                "diverged",
                f"pathological state persisted past max_rewinds="
                f"{cfg.max_rewinds}: {reason}",
                [reason] + events[-8:],
                rewinds=rewinds - 1)
            raise DivergenceError(
                f"exceeded max_rewinds={cfg.max_rewinds}: {reason}")
        if manager is not None:
            try:        # flush queued saves before deciding whether
                manager.wait()   # there is anything to rewind to
            except RuntimeError as e:
                events.append({"event": "rewind_flush_error",
                               "error": repr(e)})
        if manager is not None and manager.all_steps():
            retry_io(lambda: manager.restore(state),
                     retries=cfg.io_retries, backoff_s=cfg.io_backoff_s)
            restored = manager.last_restore["step"]
        elif mem_snapshot is not None:
            restored, (kind, payload) = mem_snapshot
            if kind == "amp":
                ckpt.load_state_dict(state, payload)
            else:
                with torch.no_grad():
                    for t, saved in zip(_tensors_of(state), payload):
                        t.copy_(saved)
        else:
            _write_incident(
                "diverged", f"{reason} — and no checkpoint to rewind to",
                [reason], rewinds=rewinds)
            raise DivergenceError(f"{reason}; no checkpoint to rewind to")
        _reinit_scaler()
        if cfg.preflight is not None:
            try:
                cfg.preflight(state)
            except Exception as e:
                _write_incident(
                    "preflight-failed",
                    f"post-rewind SPMD preflight rejected the restored "
                    f"step (rewind to step {restored}): {e}",
                    [reason, repr(e)] + events[-8:],
                    rewinds=rewinds)
                raise
            events.append({"event": "preflight", "to_step": restored})
            fr.note("preflight", to_step=restored)
        events.append({"event": "rewind", "to_step": restored,
                       "reason": reason, "rewind_count": rewinds})
        m_rewinds.inc()
        if fleet_metrics is not None:
            fleet_metrics.on_rewind()
        fr.note("rewind", to_step=restored, reason=reason,
                rewind_count=rewinds)
        return restored + 1

    # -- main loop --------------------------------------------------------
    pending: deque = deque()   # (step, metrics reader) awaiting resolution
    i = int(start_step)
    steps_completed = i

    def _resolve(entry: Tuple[int, Callable]) -> Optional[int]:
        """Consume one lagged metrics record (its copy was queued right
        behind its step); returns a step to jump to."""
        nonlocal consecutive_pinned, steps_completed
        j, read = entry
        loss, overflow, pinned = read()
        with lock:
            t0 = inflight.pop(j, None)
        losses.append((j, loss))
        steps_completed = max(steps_completed, j + 1)
        m_steps.inc()
        m_loss.set(loss)
        if fleet_metrics is not None:
            fleet_metrics.on_resolve()
        if overflow:
            m_over.inc()
        if t0 is not None:
            m_margin.set(cfg.watchdog_timeout_s
                         - (time.monotonic() - t0))
        fr.note("step", step=j, loss=round(loss, 6), overflow=overflow)
        if overflow:
            fr.note("overflow", step=j, pinned_at_floor=pinned)
        if overflow and pinned:
            consecutive_pinned += 1
        else:
            consecutive_pinned = 0
        if consecutive_pinned >= cfg.overflow_patience:
            return _rewind(f"{consecutive_pinned} consecutive overflows "
                           "with loss scale pinned at min_loss_scale")
        if not math.isfinite(loss) and not overflow:
            return _rewind(f"non-finite loss {loss} at step {j} outside "
                           "an overflow skip")
        return None

    normal_exit = False
    try:
        try:
            while i < num_steps or pending:
                if abort.is_set():
                    raise WatchdogTimeout(
                        "watchdog aborted the run; see incident record")
                if i < num_steps:
                    batch = batch_fn(i)
                    if not isinstance(batch, tuple):
                        batch = (batch,)
                    with lock:
                        inflight[i] = time.monotonic()
                    if injector is not None:
                        injector.on_step_start(i)
                        batch = injector.poison_batch(i, batch)
                        _note_new_faults()
                    if profiler is None:
                        metrics = step_fn(*batch)
                    else:
                        if not profiler.has_classifier_builder:
                            # built lazily, at the first window close
                            from apex_tpu_torch.obs.contprof import (
                                train_classifier_builder)
                            profiler.set_classifier_builder(
                                train_classifier_builder(profiler.scope))
                        profiler.step_begin()
                        t_disp = time.perf_counter()
                        metrics = step_fn(*batch)
                        # a window's close synchronizes the device; other
                        # steps record the dispatch's wall only
                        profiler.step_end(time.perf_counter() - t_disp)
                    pending.append((i, _host_scalars(metrics)))
                # resolve lagged metrics (all of them once dispatch is done)
                lag = cfg.sentinel_lag if i < num_steps else 0
                jump = None
                while len(pending) > lag and jump is None:
                    jump = _resolve(pending.popleft())
                if jump is not None:
                    pending.clear()
                    with lock:
                        inflight.clear()
                    if profiler is not None:
                        # capture suppressed while rewinding: the
                        # re-dispatched timeline must not feed the
                        # sentinel a half-rewound capture
                        profiler.suppress()
                    i = jump
                    continue
                if i < num_steps and cfg.checkpoint_every \
                        and (i + 1) % cfg.checkpoint_every == 0:
                    _save(i)
                i += 1
            normal_exit = True
        except KeyboardInterrupt:
            if abort.is_set():
                raise WatchdogTimeout(
                    "watchdog aborted the run; see incident record") from None
            raise
    except (SimulatedPreemption, KeyboardInterrupt) as e:
        flush = []
        if manager is not None:
            try:
                manager.wait()
            except Exception as flush_err:   # recorded, then e propagates
                flush = [{"checkpoint_flush_error": repr(flush_err)}]
                events.append({"event": "preempt_flush_error",
                               "error": repr(flush_err)})
        if isinstance(e, SimulatedPreemption):
            _write_incident(
                "preempted",
                f"SIGTERM at step {e.step}; in-flight checkpoints flushed — "
                "restart restores the last good snapshot",
                [str(e)] + ([{"injector_events": injector.events[-6:]}]
                            if injector else []) + flush)
        else:   # an operator's interrupt still leaves a record
            _write_incident(
                "interrupted",
                f"KeyboardInterrupt around step {i}; in-flight checkpoints "
                "flushed — restart restores the last good snapshot",
                [f"interrupted at step {i} of {num_steps}"] + flush)
        raise
    finally:
        stop.set()
        monitor.join(timeout=1.0)
        if profiler is not None:
            # a window still open on any exit path must not leak the
            # process's capture
            profiler.abort_window()
        if manager is not None:
            try:
                manager.wait()
            except Exception as e:
                # a late background-save failure surfaces, unless another
                # exception is already propagating (recorded, then that
                # one propagates)
                events.append({"event": "final_wait_error", "error": repr(e)})
                if normal_exit:
                    raise
        # a fault fired on an async commit (checkpoint corruption) can
        # land after the last dispatch: sweep it into the ring
        _note_new_faults()

    return RunResult(state=state, steps_completed=steps_completed,
                     losses=losses, rewinds=rewinds, events=events,
                     incidents=written_incidents, flight=fr)
