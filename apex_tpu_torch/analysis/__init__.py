"""Analysis over the port's runs (the port of ``apex_tpu/analysis``, in
progress):

- :mod:`~apex_tpu_torch.analysis.profile_drift`: the PROFILE_DRIFT
  schema and the drift-sentinel rule the continuous profiler
  (:mod:`apex_tpu_torch.obs.contprof`) shares with it;
- :mod:`~apex_tpu_torch.analysis.obs`: the telemetry budgets
  (:data:`~apex_tpu_torch.analysis.obs.CONTPROF_BUDGET_PCT`).

The JAX package's lint passes over lowered and compiled programs (the
harness, ``collectives``, ``spmd`` and the rest) are not ported yet
(``ROADMAP.md`` Queue 1).
"""

from apex_tpu_torch.analysis import obs, profile_drift
from apex_tpu_torch.analysis.obs import CONTPROF_BUDGET_PCT

__all__ = ["CONTPROF_BUDGET_PCT", "obs", "profile_drift"]
