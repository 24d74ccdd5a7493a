"""Structured trace spans over the profiling annotations, as
``apex_tpu/obs/spans.py``.

:func:`apex_tpu_torch.utils.profiling.nvtx_range` names a region for
``torch.profiler`` and Nsight.  This module adds structure:

- spans **nest** and the emitted name is the slash-joined path
  (``serve/step/decode``); :func:`current_path` returns the live path
  (a stack per thread);
- leaving a span observes its wall duration in the registry histogram
  ``span_seconds__<path>`` (every character but letters and digits made
  ``_``), so every named region has p50 / p99 through
  :class:`~apex_tpu_torch.obs.metrics.Histogram`;
- while ``torch.compile`` traces a function
  (``torch.compiler.is_compiling()``) the timing is suppressed: the wall
  clock there measures compilation, not the run.

On the card a span's wall time is the host's: the kernels launched
inside it may still be running when it closes.

Names: ``<subsystem>/<region>``, lowercase snake segments —
``serve/decode_step``, ``serve/prefill_chunk``, ``serve/spec_verify``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional

import torch

from apex_tpu_torch.obs import metrics as metrics_mod
from apex_tpu_torch.utils.profiling import nvtx_range

__all__ = ["span", "current_path", "traced_span", "metric_name"]

_state = threading.local()


def _stack() -> List[str]:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_path() -> str:
    """Slash-joined path of the live span stack (``""`` outside any)."""
    return "/".join(_stack())


def _tracing() -> bool:
    """True while ``torch.compile`` traces (span timings suppressed)."""
    return torch.compiler.is_compiling()


def metric_name(path: str) -> str:
    """``serve/decode_step`` -> ``span_seconds__serve_decode_step``."""
    safe = "".join(c if c.isalnum() else "_" for c in path)
    return f"span_seconds__{safe}"


@contextlib.contextmanager
def span(name: str, registry: Optional[metrics_mod.Registry] = None,
         record: bool = True):
    """Named region: a profiler / NVTX range over the span's path and
    (outside tracing) a wall-duration observation into the registry
    histogram of that path (``registry`` or the process default)."""
    stack = _stack()
    stack.append(name)
    path = "/".join(stack)
    tracing = _tracing()
    t0 = time.perf_counter()
    try:
        with nvtx_range(path):
            yield
    finally:
        stack.pop()
        if record and not tracing:
            reg = registry or metrics_mod.DEFAULT
            reg.histogram(metric_name(path),
                          f"wall seconds inside span {path!r}"
                          ).observe(time.perf_counter() - t0)


def traced_span(name: Optional[str] = None,
                registry: Optional[metrics_mod.Registry] = None
                ) -> Callable:
    """Decorator form (the :func:`apex_tpu_torch.utils.annotate` shape,
    with span structure and timing)."""
    def deco(fn):
        label = name or fn.__name__

        def wrapped(*args, **kwargs):
            with span(label, registry=registry):
                return fn(*args, **kwargs)

        wrapped.__name__ = fn.__name__
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco
