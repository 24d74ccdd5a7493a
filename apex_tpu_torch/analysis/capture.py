"""A capture of one call: the port's subject for the lint, in the place of
the JAX package's lowering (``jitted.lower(...)``).

The JAX passes read lowered StableHLO or compiled HLO; an eager PyTorch
program has neither.  :func:`capture` runs ``fn`` once and keeps what
the passes need of that run:

- the collective schedule: one entry a logical collective, in order,
  from the port's wrappers
  (:func:`apex_tpu_torch.parallel.distributed.recording`), with the JAX
  package's schedule keys;
- the aten ops the call dispatched, as ``(name, dtypes, shapes)`` of
  their tensor inputs (a ``TorchDispatchMode``), outside the
  collectives; their canonical hash (:attr:`Capture.module_hash`)
  stands where JAX hashes the module text;
- the flat inputs and outputs (:class:`ArgInfo`, :class:`OutInfo`,
  JAX's fields: ``donated`` is ``False`` and ``kept`` ``True``, since
  eager code neither donates nor prunes).

A **dry** capture (the default) records each collective and issues none,
so that a rank captures its schedule without entering a collective, as
JAX lowers without running; its outputs have the right shapes and dtypes
and meaningless values.  ``world=`` declares a world of that size for
the axis ``"data"`` when a dry capture should speak of a world that is
not formed (one process capturing what a rank of 8 would issue).

``fn`` runs on the tensors given: a capture of an optimizer step would
update the parameters in place, dry or not.  Capture the communicating
part only (a ``Reducer`` over zero gradients of the step's shapes and
dtypes, say), or give ``fn`` copies.

Every ``c10d`` op the dispatch mode sees outside a recorded collective
escaped the recorder: a raw ``torch.distributed`` call.  The capture then
raises ``RuntimeError`` naming the ops (dry or not: under a dry capture
such a call would communicate, or fail, for real).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class ArgInfo:
    """One flat tensor input of the captured call (JAX's fields)."""

    index: int
    path: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    donated: bool = False
    kept: bool = True
    weak_type: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class OutInfo:
    """One flat tensor output of the captured call."""

    index: int
    path: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int


#: one dispatched op: ``(name, dtypes, shapes)`` of its tensor inputs
Op = Tuple[str, Tuple[str, ...], Tuple[Tuple[int, ...], ...]]


@dataclasses.dataclass(frozen=True)
class Capture:
    """What one call did (:func:`capture`)."""

    schedule: Tuple[Dict[str, Any], ...]
    ops: Tuple[Op, ...]
    args: Tuple[ArgInfo, ...]
    outputs: Tuple[OutInfo, ...]
    dry: bool
    world: Optional[int] = None
    #: what ``fn`` returned (meaningless values under a dry capture)
    value: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def module_hash(self) -> str:
        """sha256 hex digest of the canonical op list: equal for two
        calls that dispatched the same ops on the same shapes and
        dtypes."""
        payload = json.dumps([[n, list(d), [list(s) for s in sh]]
                              for n, d, sh in self.ops],
                             separators=(",", ":"))
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _dtype_name(dtype: torch.dtype) -> str:
    """JAX's spelling of a dtype (``float32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def _flat_tensors(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    leaves, _ = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(path), t) for path, t in leaves
            if isinstance(t, torch.Tensor)]


def _infos(tree: Any, cls) -> tuple:
    return tuple(cls(index=i, path=path, shape=tuple(t.shape),
                     dtype=_dtype_name(t.dtype),
                     nbytes=t.numel() * t.element_size())
                 for i, (path, t) in enumerate(_flat_tensors(tree)))


class _OpRecorder(TorchDispatchMode):
    """Records each dispatched op outside a recorded collective; counts
    the ``c10d`` ops that ran outside one (escapes)."""

    def __init__(self, rec: "distributed.Recording"):
        super().__init__()
        self.rec = rec
        self.ops: List[Op] = []
        self.escaped: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.rec.depth == 0:
            name = str(func)
            if name.startswith("c10d."):
                self.escaped.append(name)
            else:
                ts = [t for t in pytree.tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
                self.ops.append((name,
                                 tuple(_dtype_name(t.dtype) for t in ts),
                                 tuple(tuple(t.shape) for t in ts)))
        return func(*args, **kwargs)


def capture(fn: Callable, *args, dry: bool = True,
            world: Optional[int] = None, **kwargs) -> Capture:
    """Run ``fn(*args, **kwargs)`` once and return what it did
    (:class:`Capture`).  ``dry`` (the default): record the collectives
    and issue none.  ``world`` (dry only): a declared world size for the
    axis ``"data"``.  Raises ``RuntimeError`` when a collective escaped
    the port's wrappers."""
    arg_info = _infos((args, kwargs), ArgInfo)
    with distributed.recording(dry=dry, world=world) as rec:
        mode = _OpRecorder(rec)
        with mode:
            value = fn(*args, **kwargs)
    if mode.escaped:
        raise RuntimeError(
            f"{len(mode.escaped)} collective(s) escaped the port's "
            f"recorder ({sorted(set(mode.escaped))}): a raw "
            f"torch.distributed call, which no schedule shows")
    return Capture(schedule=tuple(rec.schedule), ops=tuple(mode.ops),
                   args=arg_info, outputs=_infos(value, OutInfo),
                   dry=bool(dry), world=world, value=value)


__all__ = ["ArgInfo", "Capture", "OutInfo", "capture"]
