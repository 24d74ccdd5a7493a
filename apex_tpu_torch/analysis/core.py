"""Pass harness for the lint, as ``apex_tpu/analysis/core.py``.

The JAX package lints the program a user will run as text: lowered
StableHLO and compiled HLO.  An eager PyTorch program has neither, so the
port's subject is a capture of one call
(:class:`~apex_tpu_torch.analysis.capture.Capture`: its collective
schedule, its dispatched ops, its flat inputs and outputs).
:func:`analyze` captures a function on example arguments, builds a
:class:`PassContext` and runs the named passes; each pass is a plain
function ``(ctx, **options) -> [Finding]`` looked up in :data:`PASSES`.

The passes registered so far:

===================== ==================================================
pass                  catches
===================== ==================================================
``collectives``       per-kind collective count / bytes against a byte
                      budget (:mod:`~apex_tpu_torch.analysis.collectives`)
``constant-capture``  weight-sized tensors read from a closure instead of
                      passed, or held as a parameter or buffer
                      (:mod:`~apex_tpu_torch.analysis.constants`)
``policy``            FP32-list work executing in 16-bit, the O1 audit
                      (opt-in, on the forward:
                      :mod:`~apex_tpu_torch.analysis.policy`)
``memory``            the call's peak bytes against a device budget;
                      the largest buffers
                      (:mod:`~apex_tpu_torch.analysis.memory`)
``cost``              the dispatched ops' flops and bytes and the
                      roofline they imply
                      (:mod:`~apex_tpu_torch.analysis.cost`)
``syncs``             host reads of device values and blocking uploads
                      inside the call (:mod:`~apex_tpu_torch.analysis.
                      syncs`)
``spmd-consistency``  a schedule that diverges from its peers' (opt-in,
                      as in JAX: :mod:`~apex_tpu_torch.analysis.spmd`)
===================== ==================================================

:data:`DEFAULT_PASSES` is JAX's tuple restricted to what is registered,
in JAX's order.  JAX's ``lower_quiet`` and ``analyze_lowered`` have no
counterpart: there is no lowering to take.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from apex_tpu_torch.analysis.capture import (ArgInfo, Capture,  # noqa: F401
                                             OutInfo, capture)
from apex_tpu_torch.analysis.report import Finding, Report, make_report


@dataclasses.dataclass(frozen=True)
class PassContext:
    """Everything a lint pass may look at: the capture (its schedule,
    records, kernel launches, free tensors and live bytes), and the
    resolved mixed-precision policy when the caller knows it."""

    capture: Capture
    policy: Optional[Any] = None
    #: derived-table memo shared across passes (see :meth:`memo`)
    _memo: Dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def memo(self, key: str, compute: Callable[[], Any]) -> Any:
        """``compute()`` once per context under ``key`` (``None``
        results are cached too)."""
        if key not in self._memo:
            self._memo[key] = compute()
        return self._memo[key]


#: registry: pass name -> ``fn(ctx, **options) -> [Finding]``.  Pass
#: modules register themselves on import (see ``analysis/__init__.py``).
PASSES: Dict[str, Callable[..., List[Finding]]] = {}

#: JAX's ``("donation", "sharding", "collectives", "constant-capture")``
#: restricted to the passes the port registers, in JAX's order
DEFAULT_PASSES = ("collectives", "constant-capture")


def register_pass(name: str, fn: Callable[..., List[Finding]],
                  replace: bool = False) -> None:
    if name in PASSES and not replace:
        raise ValueError(f"pass {name!r} already registered")
    PASSES[name] = fn


def run_passes(ctx: PassContext,
               passes: Optional[Sequence[str]] = None,
               options: Optional[Mapping[str, Mapping[str, Any]]] = None,
               ) -> Report:
    """Run the named passes (default :data:`DEFAULT_PASSES`) over a
    prepared context.  ``options`` maps pass name -> keyword options for
    that pass (e.g. ``{"collectives": {"budget": {"total": 0}}}``)."""
    names = tuple(passes) if passes is not None else DEFAULT_PASSES
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        raise KeyError(f"unknown lint pass(es) {unknown}; registered: "
                       f"{sorted(PASSES)}")
    findings: List[Finding] = []
    for name in names:
        findings.extend(PASSES[name](ctx, **dict((options or {})
                                                 .get(name, {}))))
    return make_report(findings, names)


def build_context(subject: Capture, policy=None) -> PassContext:
    """One :class:`PassContext` over one capture, shared by every pass."""
    return PassContext(capture=subject, policy=policy)


def analyze(fn: Callable, *args,
            passes: Optional[Sequence[str]] = None,
            options: Optional[Mapping] = None,
            dry: bool = True,
            policy=None,
            world: Optional[int] = None,
            **kwargs) -> Report:
    """Capture ``fn`` once on example ``args`` (dry by default; ``world``
    declares a world size, :func:`~apex_tpu_torch.analysis.capture.
    capture`) and lint the capture with every requested pass."""
    ctx = build_context(capture(fn, *args, dry=dry, world=world, **kwargs),
                        policy=policy)
    return run_passes(ctx, passes=passes, options=options)
