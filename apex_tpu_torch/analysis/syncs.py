"""Host-sync lint over a capture, as ``apex_tpu/analysis/syncs.py`` over
the lowered step.

A step is only as fast as its quietest iteration: one hidden host
round-trip (an ``.item()`` in a metrics helper, a ``bool()`` of a device
flag, a read-back of the sampled tokens) serializes every step against
the Python thread.  JAX sees callbacks and infeed in the HLO text; the
port sees the ops themselves (:attr:`~apex_tpu_torch.analysis.capture.
Capture.records`, with the ``file:line`` of the code that called each).

Finding codes (``op`` field), JAX's:

=====================  ==================================================
``host-callback``      error: a value of the subject's device read on
                       the host inside the call — ``_local_scalar_dense``
                       (``.item()``, ``bool()``, ``float()``, ``int()``),
                       a blocking copy from the card to the CPU, an op
                       whose output size the host must read (``nonzero``,
                       ``masked_select``, ``unique``, ``bincount``,
                       ``equal``, ``repeat_interleave``, indexing by a
                       mask): the host waits for every op queued before
                       it
``pure-callback``      warning: a blocking copy from the CPU to the card
                       inside the call (a host-made value entering the
                       step: the host waits for the stream before the
                       copy); a ``non_blocking`` copy is no finding
=====================  ==================================================

The subject's device is
:attr:`~apex_tpu_torch.analysis.capture.Capture.device`: on a CPU subject
a read of a CPU tensor is a host read (the lint holds a CPU run to the
card's rules), on a card subject a read of a CPU tensor is not.

JAX's ``debug-callback``, ``static-scalar``, ``weak-scalar`` and
``inplace-read-race`` have no eager subject: nothing is traced, bound
statically, weak-typed, donated or compiled.
"""

from __future__ import annotations

import math
from typing import List

import torch

from apex_tpu_torch.analysis.capture import HOST_READ_OPS, Record
from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding


def _packet(name: str) -> str:
    return name.rsplit(".", 1)[0]


def classify(r: Record, device: str) -> "str | None":
    """``"read"`` (a host read of a ``device`` value), ``"upload"`` (a
    blocking copy onto a non-CPU ``device``) or None."""
    packet = _packet(r.name)
    if packet in HOST_READ_OPS or r.mask_index:
        return "read" if device in r.in_devices else None
    if r.non_blocking is None or r.non_blocking:
        return None
    src = r.in_devices[-1] if packet == "aten.copy_" else r.in_devices[0]
    dst = r.in_devices[0] if packet == "aten.copy_" else r.out_devices[0]
    if src == device and dst == "cpu" and device != "cpu":
        return "read"
    if src == "cpu" and dst == device and device != "cpu":
        return "upload"
    return None


def syncs_pass(ctx: PassContext) -> List[Finding]:
    """Host reads and blocking uploads inside the call (the module
    docstring)."""
    out = []
    for r in ctx.capture.records:
        kind = classify(r, ctx.capture.device)
        if kind == "read":
            out.append(Finding(
                "syncs", "error",
                f"{r.name} reads a device value on the host at "
                f"{r.site or 'an unknown site'} — the call waits for "
                f"every op queued before it, every iteration",
                op="host-callback", lineno=r.index + 1,
                example=r.site or r.name))
        elif kind == "upload":
            i = len(r.in_shapes) - 1 if _packet(r.name) == "aten.copy_" \
                else 0
            nbytes = math.prod(r.in_shapes[i]) \
                * getattr(torch, r.in_dtypes[i]).itemsize
            out.append(Finding(
                "syncs", "warning",
                f"blocking host-to-device copy ({r.name}, {nbytes} bytes) "
                f"at {r.site or 'an unknown site'} — the host waits for "
                f"the stream before the copy; stage it before the step or "
                f"copy with non_blocking=True",
                op="pure-callback", bytes=nbytes, lineno=r.index + 1,
                example=r.site or r.name))
    return out


register_pass("syncs", syncs_pass)
