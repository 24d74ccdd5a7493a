"""A capture of one call: the port's subject for the lint, in the place of
the JAX package's lowering (``jitted.lower(...)``).

The JAX passes read lowered StableHLO, compiled HLO and XLA's
``memory_analysis()`` / ``cost_analysis()``; an eager PyTorch program has
none of these.  :func:`capture` runs ``fn`` once and keeps what the
passes need of that run:

- the collective schedule: one entry a logical collective, in order,
  from the port's wrappers
  (:func:`apex_tpu_torch.parallel.distributed.recording`), with the JAX
  package's schedule keys;
- the aten ops the call dispatched, as ``(name, dtypes, shapes)`` of
  their tensor inputs (a ``TorchDispatchMode``), outside the
  collectives; their canonical hash (:attr:`Capture.module_hash`)
  stands where JAX hashes the module text;
- the same ops in full (:attr:`Capture.records`, :class:`Record`): the
  input dtypes, shapes and devices, the result dtypes and shapes,
  ``non_blocking`` of a copy, the identities of the storages read and
  written, the op's flops (``torch.utils.flop_counter``'s formulas) and
  bytes, and for an op that makes the host wait the ``file:line`` of
  the port's code that called it.  The autograd engine runs a CUDA
  backward on a thread of its own; the mode reaches it there, so a train
  step's capture holds its backward;
- the hand-written kernels' launches (:attr:`Capture.launches`, the
  difference of :func:`apex_tpu_torch.ops.cuda.launch_counts` around the
  call): the kernels are launched through ``ctypes``, out of the mode's
  sight, as a Pallas kernel is an opaque ``custom_call`` to XLA.  On the
  CPU the wrappers take their plain versions and the counts stay 0;
- the free tensors (:attr:`Capture.free`, :class:`FreeTensor`): tensors
  an op read whose storage is none of a flat input, the state of an
  owner among ``fn`` and the arguments (below), or an output of an
  earlier op of the call.  That is the eager form of an array closed
  over instead of passed;
- the live bytes (:attr:`Capture.memory`): the bytes resident through the
  call (the flat inputs, the owners' state, which the kernels read by
  pointer out of the mode's sight, and the free tensors), the running
  peak of the storages the call allocated that were still alive, and on
  a CUDA subject the caching allocator's
  peak over the call (``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``, which moves the peak any other reader of
  it holds);
- the flat inputs and outputs (:class:`ArgInfo`, :class:`OutInfo`,
  JAX's fields: ``donated`` is ``False`` and ``kept`` ``True``, since
  eager code neither donates nor prunes).

**Owners and their state.**  An eager step keeps its state where JAX
passes it as an argument: in modules, optimizers and the objects that
hold them (an ``Amp``, a serving engine).  The owners are found among
``fn`` (a module, a bound method's ``__self__``, a ``functools.partial``,
the cells of a closure, through nested closures), the arguments, and the
attributes of the plain objects found there (two levels down).  A
module's state is its parameters and buffers (a raw tensor attribute of
a module is not: that is the hazard the lint names); an optimizer's is
its parameters and its per-parameter state; a plain object's is every
tensor among its attributes.  A tensor that is itself a closure cell or a
global is never state.

A **dry** capture (the default) records each collective and issues none,
so that a rank captures its schedule without entering a collective, as
JAX lowers without running; its outputs have the right shapes and dtypes
and meaningless values.  Every other op runs, so the passes see the
whole call.  ``world=`` declares a world of that size for the axis
``"data"`` when a dry capture should speak of a world that is not formed
(one process capturing what a rank of 8 would issue).

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
import functools
import hashlib
import json
import os
import sys
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from apex_tpu_torch.ops.cuda import launch_counts
from apex_tpu_torch.parallel import distributed

#: "weight-sized": a free tensor of 1 MiB or more is a captured
#: parameter, not a mask or an eps table (the JAX package's
#: ``constants.DEFAULT_MIN_BYTES``); the capture checks splats from here
DEFAULT_MIN_BYTES = 1 << 20

#: ops whose result the host reads, or whose output size it must read,
#: before the call can go on (``.item()``, ``bool()``, ``float()`` are
#: ``_local_scalar_dense``)
HOST_READ_OPS = frozenset((
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
    "aten.bincount", "aten.equal", "aten.repeat_interleave"))
#: ops that read their output size when an index is a mask
_MASK_INDEX_OPS = frozenset(("aten.index", "aten.index_put",
                             "aten.index_put_", "aten._index_put_impl_"))
_COPY_OPS = frozenset(("aten._to_copy", "aten.copy_"))
_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
_ROOT = os.path.dirname(os.path.dirname(_ANALYSIS_DIR[:-1])) + os.sep


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
class Record:
    """One dispatched aten op of the call, outside the collectives.
    Storages are numbered in the order the capture first saw them."""

    index: int
    name: str
    in_dtypes: Tuple[str, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_devices: Tuple[str, ...]
    out_dtypes: Tuple[str, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_devices: Tuple[str, ...]
    in_storages: Tuple[int, ...]
    out_storages: Tuple[int, ...]
    #: ``non_blocking`` of a copy (``_to_copy``, ``copy_``), else None
    non_blocking: Optional[bool] = None
    flops: int = 0
    #: tensor bytes of the inputs plus the outputs (0 for a view)
    nbytes: int = 0
    #: ``file:line`` of the code that called an op making the host wait
    site: Optional[str] = None
    #: an index of ``aten.index`` / ``index_put`` is a mask
    mask_index: bool = False
    #: the Python numbers among the positional arguments (a ``pow``'s
    #: exponent, a norm's order)
    scalars: Tuple[Any, ...] = ()


@dataclasses.dataclass(frozen=True)
class FreeTensor:
    """A tensor the call read that it neither was given nor made."""

    index: int                  #: the first op that read it
    op: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int                 #: its storage's bytes
    #: one value repeated (checked from :data:`DEFAULT_MIN_BYTES` on;
    #: None below)
    splat: Optional[bool]


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
    records: Tuple[Record, ...] = ()
    #: hand-written kernel launches of the call, by kernel name (nonzero)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    free: Tuple[FreeTensor, ...] = ()
    #: ``argument_bytes``, ``allocated_peak_bytes``, ``peak_bytes`` (the
    #: two summed), ``output_bytes``, ``allocator_peak_bytes`` (CUDA
    #: subject) or None, and ``largest``: ``(role, path, dtype, nbytes)``
    #: of the flat inputs, the owners' state and the outputs
    memory: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: the subject's device: the first non-CPU device among the flat
    #: inputs, the owners' state and the ops, else ``"cpu"``
    device: str = "cpu"

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


_HLO_DTYPES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
               "float64": "f64", "int8": "i8", "uint8": "ui8",
               "int16": "i16", "int32": "i32", "int64": "i64",
               "bool": "i1", "complex64": "complex"}


def hlo_dtype(name: str) -> str:
    """The element type as StableHLO spells it, as the JAX passes' findings
    carry it (``float32`` -> ``f32``, ``bfloat16`` -> ``bf16``)."""
    return _HLO_DTYPES.get(name, name)


def _flat_tensors(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    leaves, _ = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(path), t) for path, t in leaves
            if isinstance(t, torch.Tensor)]


def _infos(tree: Any, cls) -> tuple:
    return tuple(cls(index=i, path=path, shape=tuple(t.shape),
                     dtype=_dtype_name(t.dtype),
                     nbytes=t.numel() * t.element_size())
                 for i, (path, t) in enumerate(_flat_tensors(tree)))


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):   # sparse, functional
        return None


def owner_state(fn: Any, args: Any) -> Dict[int, Tuple[str, torch.Tensor]]:
    """``{storage cdata: (path, tensor)}`` of the state of the owners
    among ``fn`` and ``args`` (the module docstring)."""
    found: Dict[int, Tuple[str, torch.Tensor]] = {}
    seen = set()

    def take(path, t):
        st = _storage(t)
        if st is not None:
            found.setdefault(st._cdata, (path, t))

    def visit(obj, path, depth, raw_ok):
        if id(obj) in seen or obj is None or depth > 2:
            return
        if isinstance(obj, torch.Tensor):
            if raw_ok:
                take(path, obj)
            return
        if isinstance(obj, (str, bytes, int, float, bool, type)) \
                or isinstance(obj, type(sys)):
            return
        seen.add(id(obj))
        if isinstance(obj, torch.nn.Module):
            for n, t in obj.named_parameters():
                take(f"{path}.{n}", t)
            for n, t in obj.named_buffers():
                take(f"{path}.{n}", t)
        elif isinstance(obj, torch.optim.Optimizer):
            for g in obj.param_groups:
                for i, p in enumerate(g["params"]):
                    take(f"{path}.params[{i}]", p)
            for i, st in enumerate(obj.state.values()):
                for k, t in st.items():
                    if isinstance(t, torch.Tensor):
                        take(f"{path}.state[{i}].{k}", t)
        elif isinstance(obj, functools.partial):
            visit(obj.func, path, depth, False)
            for i, a in enumerate(obj.args):
                visit(a, f"{path}.args[{i}]", depth, True)
            for k, a in obj.keywords.items():
                visit(a, f"{path}.{k}", depth, True)
        elif callable(obj) and hasattr(obj, "__code__"):
            visit(getattr(obj, "__self__", None), f"{path}.__self__",
                  depth, False)
            for name, cell in zip(obj.__code__.co_freevars,
                                  obj.__closure__ or ()):
                try:
                    value = cell.cell_contents
                except ValueError:        # an empty cell
                    continue
                visit(value, f"{path}.<{name}>", depth, False)
        elif hasattr(obj, "__self__") and not isinstance(obj, type):
            visit(obj.__self__, f"{path}.__self__", depth, False)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                visit(v, f"{path}[{i}]", depth, raw_ok)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                visit(v, f"{path}[{k!r}]", depth, raw_ok)
        elif hasattr(obj, "__dict__"):
            for k, v in vars(obj).items():
                visit(v, f"{path}.{k}", depth + 1, True)

    visit(fn, "fn", 0, False)
    visit(args, "args", 0, True)
    return found


def _site() -> Optional[str]:
    """``file:line`` of the innermost caller outside torch and this
    package's analysis modules (relative to the checkout when inside)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if not (path.startswith(_TORCH_DIR) or path.startswith(
                _ANALYSIS_DIR) or path.startswith("<")):
            if path.startswith(_ROOT):
                path = path[len(_ROOT):]
            return f"{path}:{f.f_lineno}"
        f = f.f_back
    return None


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpRecorder(TorchDispatchMode):
    """Records each dispatched op outside a recorded collective; counts
    the ``c10d`` ops that ran outside one (escapes); tracks storages."""

    def __init__(self, rec: "distributed.Recording",
                 roots: Dict[int, Tuple[str, torch.Tensor]],
                 inputs: set):
        super().__init__()
        self.rec = rec
        self.ops: List[Op] = []
        self.records: List[Record] = []
        self.escaped: List[str] = []
        self.roots = roots
        self.inputs = inputs
        #: storage cdata -> (number, weak ref); the weak refs keep every
        #: seen StorageImpl's address from being reused during the call
        self.ids: Dict[int, Tuple[int, StorageWeakRef]] = {}
        self.made: set = set()         # storages the call produced
        self.read: Dict[int, int] = {}  # pre-existing storage -> bytes
        self.free: Dict[int, Tuple[FreeTensor, Optional[torch.Tensor]]] = {}
        self.live = 0
        self.peak = 0
        self.lock = threading.Lock()
        self.finalizers: List[weakref.finalize] = []

    def _number(self, st) -> int:
        c = st._cdata
        got = self.ids.get(c)
        if got is None:
            got = (len(self.ids), StorageWeakRef(st))
            self.ids[c] = got
        return got[0]

    def _freed(self, nbytes: int) -> None:
        with self.lock:
            self.live -= nbytes

    def _read(self, t, st, index, name) -> None:
        c = st._cdata
        if c in self.made:
            return
        if c not in self.read:
            self.read[c] = st.nbytes()
        if c in self.roots or c in self.inputs or c in self.free:
            return
        big = st.nbytes() >= DEFAULT_MIN_BYTES
        self.free[c] = (FreeTensor(index, name, tuple(t.shape),
                                   _dtype_name(t.dtype), st.nbytes(),
                                   None), t if big else None)

    def _made(self, st) -> None:
        c = st._cdata
        if c in self.made or c in self.roots or c in self.inputs \
                or c in self.read:
            return
        self.made.add(c)
        n = st.nbytes()
        with self.lock:
            self.live += n
            self.peak = max(self.peak, self.live)
        self.finalizers.append(weakref.finalize(st, self._freed, n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if self.rec.depth == 0 and not name.startswith("c10d."):
            # under inference mode the mode sees composite ops (``to``,
            # ``linear``, ``softmax``) before their decomposition: take
            # it here, so a call records the same ops in either mode
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self.rec.depth != 0:
            return out
        if name.startswith("c10d."):
            self.escaped.append(name)
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self.ops.append((name, tuple(_dtype_name(t.dtype) for t in ins),
                         tuple(tuple(t.shape) for t in ins)))
        index = len(self.records)
        packet = name.rsplit(".", 1)[0]
        lifted = packet == "aten.lift_fresh"
        in_ids = []
        for t in ins:
            st = _storage(t)
            if st is None:
                in_ids.append(-1)
                continue
            in_ids.append(self._number(st))
            if lifted:
                self._made(st)          # host data made inside the call
            else:
                self._read(t, st, index, name)
        out_ids = []
        for t in outs:
            st = _storage(t)
            if st is None:
                out_ids.append(-1)
                continue
            out_ids.append(self._number(st))
            self._made(st)
        schema = func._schema
        view = bool(schema.returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in schema.returns)
        flops = 0
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            flops = int(count(*args, **kwargs, out_val=out))
        in_dev = tuple(str(t.device) for t in ins)
        out_dev = tuple(str(t.device) for t in outs)
        mask = packet in _MASK_INDEX_OPS and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in pytree.tree_leaves(args[1:2]))
        non_blocking = None
        if packet in _COPY_OPS:
            non_blocking = bool(kwargs.get("non_blocking",
                                           args[2] if len(args) > 2
                                           and packet == "aten.copy_"
                                           else False))
        crosses = len(set(in_dev) | set(out_dev)) > 1
        site = _site() if (packet in HOST_READ_OPS or mask
                           or (non_blocking is not None and crosses)) \
            else None
        self.records.append(Record(
            index=index, name=name,
            in_dtypes=tuple(_dtype_name(t.dtype) for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins), in_devices=in_dev,
            out_dtypes=tuple(_dtype_name(t.dtype) for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_devices=out_dev, in_storages=tuple(in_ids),
            out_storages=tuple(out_ids), non_blocking=non_blocking,
            flops=flops, nbytes=0 if view else sum(
                _tensor_bytes(t) for t in ins + outs),
            site=site, mask_index=mask,
            scalars=tuple(a for a in args if isinstance(a, (int, float)))))
        return out


def _is_splat(t: torch.Tensor) -> bool:
    flat = t.detach().reshape(-1)
    return bool(flat.numel() == 0 or torch.equal(
        flat, flat[:1].expand_as(flat)))


def _subject_device(tensors, records) -> str:
    for t in tensors:
        if t.device.type != "cpu":
            return str(t.device)
    for r in records:
        for d in r.in_devices + r.out_devices:
            if d != "cpu":
                return d
    return "cpu"


def capture(fn: Callable, *args, dry: bool = True,
            world: Optional[int] = None, **kwargs) -> Capture:
    """Run ``fn(*args, **kwargs)`` once and return what it did
    (:class:`Capture`).  ``dry`` (the default): record the collectives
    and issue none.  ``world`` (dry only): a declared world size for the
    axis ``"data"``.  The free tensors of :data:`DEFAULT_MIN_BYTES` or
    more are checked for a single repeated value after the call.
    Raises ``RuntimeError`` when a collective escaped the port's
    wrappers."""
    arg_info = _infos((args, kwargs), ArgInfo)
    flat_in = [t for _, t in _flat_tensors((args, kwargs))]
    inputs = {st._cdata for st in map(_storage, flat_in) if st is not None}
    roots = {c: v for c, v in owner_state(fn, (args, kwargs)).items()
             if c not in inputs}
    pre = [t for _, t in roots.values()] + flat_in
    device = _subject_device(pre, ())
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    with distributed.recording(dry=dry, world=world) as rec:
        mode = _OpRecorder(rec, roots, inputs)
        try:
            with mode:
                value = fn(*args, **kwargs)
        finally:
            for f in mode.finalizers:
                f.detach()
    after = launch_counts()
    allocator_peak = None
    if on_card:
        torch.cuda.synchronize(device)
        allocator_peak = int(torch.cuda.max_memory_allocated(device))
    if mode.escaped:
        raise RuntimeError(
            f"{len(mode.escaped)} collective(s) escaped the port's "
            f"recorder ({sorted(set(mode.escaped))}): a raw "
            f"torch.distributed call, which no schedule shows")
    free = tuple(dataclasses.replace(ft, splat=None if t is None
                                     else _is_splat(t))
                 for ft, t in mode.free.values())
    records = tuple(mode.records)
    outputs = _infos(value, OutInfo)
    # resident through the call: the flat inputs, every owner's state
    # (the kernels read it by pointer, out of the mode's sight) and the
    # other pre-existing storages the call read
    resident = dict(mode.read)
    for t in flat_in + [t for _, t in roots.values()]:
        st = _storage(t)
        if st is not None:
            resident.setdefault(st._cdata, st.nbytes())
    argument_bytes = sum(resident.values())
    largest = ([("argument", a.path or f"arg{a.index}", a.dtype, a.nbytes)
                for a in arg_info]
               + [("state", path, _dtype_name(t.dtype), _tensor_bytes(t))
                  for path, t in roots.values()]
               + [("output", o.path or f"out{o.index}", o.dtype, o.nbytes)
                  for o in outputs])
    largest.sort(key=lambda r: -r[3])
    memory = {"argument_bytes": argument_bytes,
              "allocated_peak_bytes": mode.peak,
              "peak_bytes": argument_bytes + mode.peak,
              "output_bytes": sum(o.nbytes for o in outputs),
              "allocator_peak_bytes": allocator_peak,
              "largest": tuple(largest)}
    return Capture(schedule=tuple(rec.schedule), ops=tuple(mode.ops),
                   args=arg_info, outputs=outputs,
                   dry=bool(dry), world=world, value=value,
                   records=records,
                   launches={k: after[k] - before.get(k, 0) for k in after
                             if after[k] != before.get(k, 0)},
                   free=free, memory=memory,
                   device=device if device != "cpu"
                   else _subject_device((), records))


__all__ = ["ArgInfo", "Capture", "DEFAULT_MIN_BYTES", "FreeTensor",
           "HOST_READ_OPS", "OutInfo", "Record", "capture", "hlo_dtype",
           "owner_state"]
