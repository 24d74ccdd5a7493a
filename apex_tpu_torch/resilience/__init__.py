"""apex_tpu_torch.resilience: fault tolerance for training, as
``apex_tpu/resilience``:

- :mod:`~apex_tpu_torch.resilience.durable`: crash-atomic,
  checksum-verified, device-portable checkpointing
  (:class:`DurableCheckpointManager`), in the JAX package's format;
- :mod:`~apex_tpu_torch.resilience.faults`: seeded, composable fault
  injection (:class:`FaultInjector` and the fault dataclasses);
- :mod:`~apex_tpu_torch.resilience.loop`: the self-healing train loop
  (:func:`run_resilient`: watchdog, IO retry, divergence rewind);
- :mod:`~apex_tpu_torch.resilience.incidents`: the incident record's
  schema, shared with the JAX package;
- :mod:`~apex_tpu_torch.resilience.fleet`: the elastic training fleet
  (per-rank supervisors over a file ledger of leases and generation
  plans; shrink on a rank's death, regrow on its return).

The names load with their module on first use, so that the fleet's
supervisors, which only read and write the ledger, never import torch.
"""

import importlib
from typing import Any

_EXPORTS = {
    "durable": ("CheckpointCorruptError", "DurableCheckpointManager",
                "read_snapshot", "verify_snapshot", "write_snapshot"),
    "faults": ("CorruptCheckpoint", "FaultInjector", "FlakyIO", "HangStep",
               "NaNStorm", "Preempt", "RankKill", "SimulatedPreemption",
               "SlowIO", "parse_fault"),
    "incidents": ("make_incident", "utc_now", "validate_incident",
                  "validate_incident_file", "write_incident"),
    "loop": ("DivergenceError", "ResilienceConfig", "RunResult",
             "WatchdogTimeout", "retry_io", "run_resilient"),
    "fleet": ("EXIT_MEMBERSHIP", "FleetError", "FleetMembershipChange",
              "FleetConfig", "FleetLedger", "HeartbeatLease",
              "FleetMetrics", "latest_verified_step", "load_snapshot_state",
              "snapshot_digest", "state_digest", "membership_gate",
              "run_generation", "supervise"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name: str) -> Any:
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
