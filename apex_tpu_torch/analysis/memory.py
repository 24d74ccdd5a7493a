"""Memory lint over a capture: the call's peak bytes against a device
budget, as ``apex_tpu/analysis/memory.py`` over XLA's
``memory_analysis()``.

The capture tracks the call's bytes
(:attr:`~apex_tpu_torch.analysis.capture.Capture.memory`): the storages
resident through it (flat inputs, the owners' state, free tensors;
JAX's argument bytes), the running peak of the storages it allocated
while they were alive (JAX's outputs and temps), and on a CUDA subject
the caching allocator's peak over the call, which also holds what no
owner of the call holds (other models, the allocator's rounding).  So
a lane fails lint before it runs out of memory on the card.

Finding codes (``op`` field), JAX's:

=====================  ==================================================
``peak-hbm``           info: the peak (arguments + the call's live peak)
                       with the breakdown; the allocator's peak beside it
``hbm-budget``         error: the larger of the two peaks exceeds
                       ``budget_bytes``
``large-buffer``       info: the largest argument / state / output
                       buffers, the attribution for an over-budget peak
=====================  ==================================================

``budget_bytes="device"`` is the subject device's total memory
(``torch.cuda.get_device_properties(d).total_memory``); a CPU subject
needs a number.  JAX's ``donation-dropped`` and ``donation-alias`` have no
eager subject: nothing is donated (the optimizers update in place).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


def device_budget(device: str) -> int:
    """The total memory of a CUDA ``device``; ``ValueError`` on the CPU."""
    if not device.startswith("cuda"):
        raise ValueError(f"budget_bytes='device' needs a CUDA subject, not "
                         f"{device!r}: give a number")
    return int(torch.cuda.get_device_properties(device).total_memory)


def memory_pass(ctx: PassContext,
                budget_bytes: Union[None, int, str] = None,
                top_k: int = 5) -> List[Finding]:
    """Peak bytes, the budget gate and the largest buffers (the module
    docstring).  Without ``budget_bytes`` the pass only measures."""
    mem = ctx.capture.memory
    if budget_bytes == "device":
        budget_bytes = device_budget(ctx.capture.device)
    peak = mem["peak_bytes"]
    alloc: Optional[int] = mem["allocator_peak_bytes"]
    findings = [Finding(
        "memory", "info",
        f"peak {_fmt_bytes(peak)} (arguments and state "
        f"{_fmt_bytes(mem['argument_bytes'])} + the call's live peak "
        f"{_fmt_bytes(mem['allocated_peak_bytes'])}; outputs "
        f"{_fmt_bytes(mem['output_bytes'])})"
        + ("" if alloc is None else
           f"; the caching allocator's peak {_fmt_bytes(alloc)}"),
        op="peak-hbm", bytes=peak)]
    worst = max(peak, alloc or 0)
    if budget_bytes is not None and worst > budget_bytes:
        findings.append(Finding(
            "memory", "error",
            f"peak {_fmt_bytes(worst)} exceeds the device budget "
            f"{_fmt_bytes(budget_bytes)} — this lane runs out of memory "
            f"on the card; shard, recompute or free more (the call's "
            f"live peak {_fmt_bytes(mem['allocated_peak_bytes'])})",
            op="hbm-budget", bytes=worst))
    for role, path, dtype, nbytes in mem["largest"][:top_k]:
        if nbytes <= 0:
            continue
        findings.append(Finding(
            "memory", "info",
            f"largest live buffers: {role} {path} holds "
            f"{_fmt_bytes(nbytes)}",
            op="large-buffer", dtype=dtype, bytes=nbytes))
    return findings


register_pass("memory", memory_pass)
