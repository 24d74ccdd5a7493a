"""Rank-0-aware, verbosity-gated logging, as ``apex_tpu/utils/logging.py``
(the reference's ``maybe_print`` / ``master_print``): with several
processes only rank 0 prints, and messages are gated on a global
verbosity (:func:`set_verbosity`)."""

from __future__ import annotations

import sys
import warnings

_verbosity = 1


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def _is_rank0() -> bool:
    """Rank 0 of the default process group when ``torch.distributed`` is
    initialised, else this (only) process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def maybe_print(message: str, rank0_only: bool = True, min_verbosity: int = 1,
                file=None) -> None:
    """Print gated on verbosity and (by default) the rank."""
    if _verbosity < min_verbosity:
        return
    if rank0_only and not _is_rank0():
        return
    print(message, file=file or sys.stdout)


def warn_or_err(condition: bool, message: str, strict: bool = False) -> None:
    """Warn (or raise under strict mode) on a policy inconsistency."""
    if condition:
        return
    if strict:
        raise RuntimeError(message)
    warnings.warn(message)
