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
  schema, shared with the JAX package.

The JAX package's elastic fleet (``resilience/fleet.py``) is not ported
yet.
"""

from apex_tpu_torch.resilience.durable import (CheckpointCorruptError,
                                               DurableCheckpointManager,
                                               read_snapshot,
                                               verify_snapshot,
                                               write_snapshot)
from apex_tpu_torch.resilience.faults import (CorruptCheckpoint,
                                              FaultInjector, FlakyIO,
                                              HangStep, NaNStorm, Preempt,
                                              RankKill, SimulatedPreemption,
                                              SlowIO, parse_fault)
from apex_tpu_torch.resilience.incidents import (make_incident, utc_now,
                                                 validate_incident,
                                                 validate_incident_file,
                                                 write_incident)
from apex_tpu_torch.resilience.loop import (DivergenceError,
                                            ResilienceConfig, RunResult,
                                            WatchdogTimeout, retry_io,
                                            run_resilient)

__all__ = [
    "CheckpointCorruptError", "DurableCheckpointManager", "read_snapshot",
    "verify_snapshot", "write_snapshot",
    "CorruptCheckpoint", "FaultInjector", "FlakyIO", "HangStep", "NaNStorm",
    "Preempt", "RankKill", "SimulatedPreemption", "SlowIO", "parse_fault",
    "make_incident", "utc_now", "validate_incident",
    "validate_incident_file", "write_incident",
    "DivergenceError", "ResilienceConfig", "RunResult", "WatchdogTimeout",
    "retry_io", "run_resilient",
]
