"""Profiling annotations, as ``apex_tpu/utils/profiling.py``.

The reference put NVTX ranges at hot spots and drove Nsight through
``cudaProfilerStart`` / ``cudaProfilerStop``.  Here:

- :func:`nvtx_range` names a region for ``torch.profiler``
  (``record_function``: the host-side section, and the device kernels
  launched inside it in a trace) and, once CUDA is initialised, for
  Nsight (``torch.cuda.nvtx.range_push`` / ``range_pop``).  It only
  annotates: nothing inside it runs anywhere else;
- :func:`range_push` / :func:`range_pop` are the imperative NVTX shape;
- :func:`annotate` is the decorator form;
- :func:`profile_range` names a region only while a ``torch.profiler``
  capture runs (one flag check outside one): the ranges the step
  classifiers of :mod:`apex_tpu_torch.obs.stepclass` read;
- :func:`profiler_start` / :func:`profiler_stop` bracket one
  ``torch.profiler`` capture (the host and, with a card, the device),
  written to ``logdir`` as a chrome trace for TensorBoard's profile
  plugin or Perfetto.

``torch.profiler`` is one capture a process.  :data:`capture_lock` is
held by whoever runs the port's capture (:func:`profiler_start`, or a
window of :class:`apex_tpu_torch.obs.contprof.ContinuousProfiler`): a
continuous-profiler window that finds it held is skipped, and
:func:`profiler_start` raises.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
from typing import Callable, List, Optional

import torch


def _nvtx_on() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def nvtx_range(name: str):
    """A named region in ``torch.profiler`` traces and, with CUDA
    initialised, an NVTX range."""
    nvtx = _nvtx_on()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def capturing() -> bool:
    """Whether a ``torch.profiler`` capture is running in this process
    (any owner: this module, a continuous-profiler window, a
    ``torch.profiler.profile`` of the caller's)."""
    return torch._C._autograd._profiler_enabled()


#: the context :func:`profile_range` returns outside a capture (reusable)
_NO_RANGE = contextlib.nullcontext()


def profile_range(name: str):
    """A ``record_function`` range named ``name`` while a capture runs,
    else a shared no-op context: a named region for the trace that costs
    one flag check outside a capture (no NVTX range)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


_range_stack: List[contextlib.ExitStack] = []


def range_push(name: str) -> None:
    """Imperative begin (``torch.cuda.nvtx.range_push`` shape)."""
    es = contextlib.ExitStack()
    es.enter_context(nvtx_range(name))
    _range_stack.append(es)


def range_pop() -> None:
    """Imperative end (``torch.cuda.nvtx.range_pop``)."""
    if _range_stack:
        _range_stack.pop().close()


def annotate(name: Optional[str] = None) -> Callable:
    """Decorator: run the function inside a named range."""
    def deco(fn):
        label = name or fn.__name__

        def wrapped(*args, **kwargs):
            with nvtx_range(label):
                return fn(*args, **kwargs)

        wrapped.__name__ = fn.__name__
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco


#: the process's one ``torch.profiler`` capture: held while
#: :func:`profiler_start`'s capture or a continuous-profiler window runs
capture_lock = threading.Lock()

_profile: Optional[torch.profiler.profile] = None


def profiler_start(logdir: Optional[str] = None) -> None:
    """Begin a ``torch.profiler`` capture (``cudaProfilerStart`` analog)
    of the host and, with a card, the device.  ``logdir`` defaults to
    ``apex_tpu_torch_trace`` under the temporary directory.  A second
    call while this capture runs does nothing; a call while another
    holds :data:`capture_lock` (a continuous-profiler window) raises
    ``RuntimeError``."""
    global _profile
    if _profile is not None:
        return
    if not capture_lock.acquire(blocking=False):
        raise RuntimeError(
            "profiler_start: the process's torch.profiler capture is held "
            "(a continuous-profiler window is open)")
    try:
        logdir = logdir or os.path.join(tempfile.gettempdir(),
                                        "apex_tpu_torch_trace")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
        prof.start()
    except BaseException:
        capture_lock.release()
        raise
    _profile = prof


def profiler_stop() -> None:
    """End the capture and write its trace (``cudaProfilerStop``)."""
    global _profile
    if _profile is not None:
        prof, _profile = _profile, None
        try:
            prof.stop()
        finally:
            capture_lock.release()
