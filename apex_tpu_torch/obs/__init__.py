from apex_tpu_torch.obs.flight import FlightRecorder
from apex_tpu_torch.obs.metrics import (
    DEFAULT,
    Counter,
    Gauge,
    Histogram,
    Registry,
)

__all__ = ["Counter", "DEFAULT", "FlightRecorder", "Gauge", "Histogram",
           "Registry"]
