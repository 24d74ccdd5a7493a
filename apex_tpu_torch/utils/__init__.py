"""Logging and profiling helpers, as ``apex_tpu/utils``."""

from apex_tpu_torch.utils.logging import maybe_print, set_verbosity, warn_or_err
from apex_tpu_torch.utils.profiling import (
    annotate,
    nvtx_range,
    profiler_start,
    profiler_stop,
    range_pop,
    range_push,
)

__all__ = ["maybe_print", "set_verbosity", "warn_or_err",
           "nvtx_range", "range_push", "range_pop", "annotate",
           "profiler_start", "profiler_stop"]
