"""Analysis over the port's programs and runs (the port of
``apex_tpu/analysis``, in progress):

- the lint harness (:mod:`~apex_tpu_torch.analysis.core`:
  :func:`analyze`, :func:`run_passes`, :func:`register_pass`) with
  :class:`Finding` / :class:`Report`, over a capture of one call
  (:mod:`~apex_tpu_torch.analysis.capture`: its collective schedule, its
  dispatched ops, its inputs and outputs), the port's subject in the
  place of JAX's lowering;
- the ``collectives`` pass (:mod:`~apex_tpu_torch.analysis.collectives`)
  and the ``spmd-consistency`` pass with the cross-rank schedule diff
  (:mod:`~apex_tpu_torch.analysis.spmd`), which the runtime preflight
  (:func:`apex_tpu_torch.parallel.multiproc.spmd_preflight`) uses;
- the whole-program passes over the capture's records, kernel launches,
  free tensors and live bytes: ``constant-capture``
  (:mod:`~apex_tpu_torch.analysis.constants`), ``memory``, ``cost`` and
  ``syncs`` (:mod:`~apex_tpu_torch.analysis.memory`, ``cost``,
  ``syncs``), and the opt-in O1 audit ``policy``
  (:mod:`~apex_tpu_torch.analysis.policy`, re-exported as
  ``apex_tpu_torch.amp.audit``);
- :mod:`~apex_tpu_torch.analysis.profile_drift`: the PROFILE_DRIFT
  schema and the drift-sentinel rule the continuous profiler
  (:mod:`apex_tpu_torch.obs.contprof`) shares with it;
- :mod:`~apex_tpu_torch.analysis.obs`: the telemetry budgets
  (:data:`~apex_tpu_torch.analysis.obs.CONTPROF_BUDGET_PCT`).

The JAX package's other passes (``precision``, the kernel lints,
``determinism``, ``export``) are not ported yet (``ROADMAP.md``
Queue 1); ``donation`` and ``sharding`` have no eager subject.

Usage::

    from apex_tpu_torch import analysis

    report = analysis.analyze(ddp.reduce, zero_grads,
                              passes=("collectives",),
                              options={"collectives":
                                       {"budget": {"total": 1 << 30}}})
    if not report.ok:
        raise RuntimeError(report.format())

    # a train step: host syncs, its peak against the card, its flops
    report = analysis.analyze(step, ids,
                              passes=("syncs", "memory", "cost"),
                              options={"memory": {"budget_bytes": "device"}})
"""

from apex_tpu_torch.analysis.core import (
    DEFAULT_PASSES,
    PASSES,
    ArgInfo,
    OutInfo,
    PassContext,
    analyze,
    build_context,
    register_pass,
    run_passes,
)
from apex_tpu_torch.analysis.report import SEVERITIES, Finding, Report
from apex_tpu_torch.analysis.capture import (Capture, FreeTensor, Record,
                                             capture)

# importing a pass module registers its pass, in JAX's order
from apex_tpu_torch.analysis import collectives  # noqa: F401  (registers)
from apex_tpu_torch.analysis import constants    # noqa: F401  (registers)
from apex_tpu_torch.analysis import policy       # noqa: F401  (registers)
from apex_tpu_torch.analysis import memory       # noqa: F401  (registers)
from apex_tpu_torch.analysis import cost         # noqa: F401  (registers)
from apex_tpu_torch.analysis import syncs        # noqa: F401  (registers)
from apex_tpu_torch.analysis import spmd         # noqa: F401  (registers)

from apex_tpu_torch.analysis import obs, profile_drift
from apex_tpu_torch.analysis.collectives import (collective_audit,
                                                 collective_table)
from apex_tpu_torch.analysis.cost import roofline_expectation
from apex_tpu_torch.analysis.obs import CONTPROF_BUDGET_PCT
from apex_tpu_torch.analysis.spmd import (
    collective_schedule,
    compare_lowerings,
    diff_schedules,
    reshape_pair_findings,
    schedule_fingerprint,
)

__all__ = [
    "analyze", "build_context", "run_passes", "register_pass",
    "ArgInfo", "OutInfo", "PassContext", "Finding", "Report",
    "PASSES", "DEFAULT_PASSES", "SEVERITIES",
    "Capture", "FreeTensor", "Record", "capture",
    "collective_audit", "collective_table",
    "collective_schedule", "compare_lowerings", "diff_schedules",
    "reshape_pair_findings", "schedule_fingerprint",
    "roofline_expectation",
    "collectives", "constants", "cost", "memory", "policy", "spmd",
    "syncs",
    "CONTPROF_BUDGET_PCT", "obs", "profile_drift",
]
