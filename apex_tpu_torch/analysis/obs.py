"""Telemetry budgets, as ``apex_tpu/analysis/obs.py``'s constants (the
port's own copy; the OBS document schema is not ported)."""

#: acceptance bar: the continuous profiler's amortized cost — one
#: capture window (capture + parse + sentinel) as a percentage of the
#: step wall over the whole inter-capture interval
#: (``capture_every × step_wall``)
CONTPROF_BUDGET_PCT = 1.0
