"""Constant-capture lint: weights read from a closure, as
``apex_tpu/analysis/constants.py``.

A jitted JAX function that *closes over* an array bakes it into the
program as a literal; the JAX pass finds the weight-sized non-splat
``stablehlo.constant`` ops of the lowered text.  An eager call bakes
nothing, but the hazard is the same one: a weight reached through a
closure or a global rather than passed, or held as a module's parameter
or buffer, is outside every owner's state (``state_dict``, the
optimizer, a checkpoint, device placement) and changes behind the
caller's back.  The capture lists it
(:attr:`~apex_tpu_torch.analysis.capture.Capture.free`: a tensor an op
read that is no flat input, no owner's state and no output of an earlier
op).  A splat (one value repeated, e.g. an all-zeros init cache) is
exempt, as in JAX.
"""

from __future__ import annotations

from typing import List

from apex_tpu_torch.analysis.capture import DEFAULT_MIN_BYTES, hlo_dtype
from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding


def _type(shape, dtype: str) -> str:
    return "x".join([str(d) for d in shape] + [dtype])


def constant_capture_pass(ctx: PassContext,
                          min_bytes: int = DEFAULT_MIN_BYTES,
                          ) -> List[Finding]:
    """Flag free tensors of ``min_bytes`` or more that are not splats
    (one under the capture's ``DEFAULT_MIN_BYTES`` was not checked and
    counts as no splat): tensors that should be arguments or an owner's
    state."""
    findings: List[Finding] = []
    for ft in ctx.capture.free:
        if ft.nbytes < min_bytes or ft.splat:
            continue
        dtype = hlo_dtype(ft.dtype)
        findings.append(Finding(
            "constant-capture", "error",
            f"weight-sized tensor<{_type(ft.shape, dtype)}> "
            f"({ft.nbytes} bytes) read by {ft.op} is closed over — no "
            f"argument, parameter or buffer: it belongs to no owner's "
            f"state (state_dict, checkpoint, device placement) and "
            f"changes behind the caller's back",
            op="constant", dtype=dtype, bytes=ft.nbytes,
            lineno=ft.index + 1, example=ft.op))
    return findings


register_pass("constant-capture", constant_capture_pass)
