"""Runtime telemetry (the port of ``apex_tpu/obs``):

- :mod:`~apex_tpu_torch.obs.metrics`: counters, gauges and fixed-bucket
  histograms whose device values resolve with a lag (a copy queued
  behind the step, read a step later), Prometheus text and JSON export,
  and :func:`instrument_step`;
- :mod:`~apex_tpu_torch.obs.spans`: nesting trace spans over
  :mod:`apex_tpu_torch.utils.profiling`, their wall durations into the
  registry's histograms;
- :mod:`~apex_tpu_torch.obs.xplane`: the torch profiler's chrome trace
  by op and category, step markers, named buckets;
- :mod:`~apex_tpu_torch.obs.reqtrace`: per-request lifecycle traces;
- :mod:`~apex_tpu_torch.obs.flight`: the incident flight recorder;
- :mod:`~apex_tpu_torch.obs.fleet`: fleet-level registry merges
  (counter sums, bucket-union quantiles, per-replica gauge tables);
- :mod:`~apex_tpu_torch.obs.exposition`: the stdlib HTTP scrape target
  (``/metrics``, ``/fleet``, ``/healthz``);
- :mod:`~apex_tpu_torch.obs.slo`: declarative SLO objectives over the
  registry;
- :mod:`~apex_tpu_torch.obs.stepclass`: the step classifiers (the decode
  and train bucket vocabularies) over the profiler's trace, each device
  event under the host op that launched it;
- :mod:`~apex_tpu_torch.obs.contprof`: the continuous profiler (sampled
  capture windows inside the serve and train loops, profiled steps kept
  out of the gated latency histograms) and its drift sentinel.
"""

from apex_tpu_torch.obs import (
    contprof,
    exposition,
    fleet,
    reqtrace,
    slo,
    spans,
    stepclass,
    xplane,
)
from apex_tpu_torch.obs.contprof import (
    ContinuousProfiler,
    ContProfConfig,
    DriftSentinel,
    serve_profiler,
    train_profiler,
)
from apex_tpu_torch.obs.exposition import MetricsServer
from apex_tpu_torch.obs.flight import FlightRecorder
from apex_tpu_torch.obs.metrics import (
    DEFAULT,
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    get_registry,
    histogram,
    instrument_step,
)
from apex_tpu_torch.obs.reqtrace import EVENT_KINDS, RequestTracer
from apex_tpu_torch.obs.slo import SLObjective, SLOEvaluator, serve_objectives
from apex_tpu_torch.obs.spans import current_path, span, traced_span

__all__ = ["ContProfConfig", "ContinuousProfiler", "Counter", "DEFAULT",
           "DriftSentinel", "EVENT_KINDS", "FlightRecorder", "Gauge",
           "Histogram", "LATENCY_BUCKETS", "MetricsServer", "Registry",
           "RequestTracer", "SLOEvaluator", "SLObjective", "contprof",
           "counter", "current_path", "exposition", "fleet", "gauge",
           "get_registry", "histogram", "instrument_step", "reqtrace",
           "serve_objectives", "serve_profiler", "slo", "span", "spans",
           "stepclass", "traced_span", "train_profiler", "xplane"]
