"""Runtime telemetry (the port of ``apex_tpu/obs``): the metrics
registry, trace spans, per-request lifecycle traces, SLO objectives and
the incident flight recorder."""

from apex_tpu_torch.obs import reqtrace, slo, spans
from apex_tpu_torch.obs.flight import FlightRecorder
from apex_tpu_torch.obs.metrics import (
    DEFAULT,
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from apex_tpu_torch.obs.reqtrace import EVENT_KINDS, RequestTracer
from apex_tpu_torch.obs.slo import SLObjective, SLOEvaluator, serve_objectives
from apex_tpu_torch.obs.spans import current_path, span, traced_span

__all__ = ["Counter", "DEFAULT", "EVENT_KINDS", "FlightRecorder", "Gauge",
           "Histogram", "LATENCY_BUCKETS", "Registry", "RequestTracer",
           "SLOEvaluator", "SLObjective", "current_path", "reqtrace",
           "serve_objectives", "slo", "span", "spans", "traced_span"]
