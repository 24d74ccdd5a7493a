"""The native host runtime (``csrc/host_runtime.cpp``) through ``ctypes``,
as ``apex_tpu/_native/__init__.py``: multithreaded flatten / unflatten of
host (numpy) buffers, DDP bucket planning, and the FNV-1a digest.

The library is built from the checkout's source with the host C++
compiler (``$CXX``, else ``g++``; ``-O3 -std=c++17 -fPIC -shared
-pthread``) at first use, under ``build/apex_tpu_torch/`` at the root of
the checkout, with a name that carries a hash of the source and flags, as
``ops/cuda/build.py`` names the kernel library.  A build goes to a
temporary name and is renamed into place (``os.replace``), so processes
that build at once (test workers, a fleet's ranks) each load a whole
library.  A failed build raises; there is no fallback.

The ``*_plain`` functions are the numpy versions the library is held
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "apex_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
ABI_VERSION = 1

_LIB: Optional[ctypes.CDLL] = None
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_LOCK = threading.Lock()
_N_THREADS = min(8, os.cpu_count() or 1)


def compiler() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") \
        or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler ($CXX, g++, c++): the "
                           "native host runtime cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhost_runtime-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([compiler(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded library, built on the first call if this checkout has
    none."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.apex_flatten.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int]
        lib.apex_unflatten.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        lib.apex_plan_buckets.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.apex_plan_buckets.restype = ctypes.c_int64
        lib.apex_fingerprint64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
        lib.apex_fingerprint64.restype = ctypes.c_uint64
        lib.apex_native_abi_version.restype = ctypes.c_int
        if lib.apex_native_abi_version() != ABI_VERSION:
            raise RuntimeError(f"{path}: ABI version "
                               f"{lib.apex_native_abi_version()}, want "
                               f"{ABI_VERSION}")
        _LIB = lib
        return lib


def _as_i64(seq) -> "ctypes.Array":
    return (ctypes.c_int64 * len(seq))(*seq)


def _same_dtype(arrays: Sequence[np.ndarray], what: str) -> np.dtype:
    if not arrays:
        raise ValueError(f"{what} requires at least one array")
    dtype = arrays[0].dtype
    if any(a.dtype != dtype for a in arrays):
        raise ValueError(f"{what} requires a single dtype per call "
                         "(group_by_dtype first)")
    return dtype


def flatten(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Host arrays of one dtype packed into one flat 1-d array
    (``apex_C.flatten``)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    dtype = _same_dtype(arrays, "flatten")
    nbytes = [a.nbytes for a in arrays]
    offsets = np.concatenate([[0], np.cumsum(nbytes[:-1])]).astype(np.int64)
    out = np.empty(sum(nbytes) // dtype.itemsize, dtype=dtype)
    srcs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
    library().apex_flatten(srcs, _as_i64(nbytes),
                           _as_i64([int(o) for o in offsets]), len(arrays),
                           out.ctypes.data_as(ctypes.c_char_p), _N_THREADS)
    return out


def _sizes(flat: np.ndarray, shapes: Sequence[Tuple[int, ...]]) -> List[int]:
    sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
    if sum(sizes) != flat.size:
        raise ValueError(f"flat buffer has {flat.size} elements, shapes "
                         f"require {sum(sizes)}")
    return sizes


def unflatten(flat: np.ndarray,
              shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
    """A flat array split back into new arrays of ``shapes``
    (``apex_C.unflatten``)."""
    flat = np.ascontiguousarray(flat)
    sizes = _sizes(flat, shapes)
    outs = [np.empty(s, dtype=flat.dtype) for s in shapes]
    itemsize = flat.dtype.itemsize
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    dsts = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
    library().apex_unflatten(
        flat.ctypes.data_as(ctypes.c_char_p),
        _as_i64([s * itemsize for s in sizes]),
        _as_i64([int(o) * itemsize for o in starts]), len(outs), dsts,
        _N_THREADS)
    return outs


def _triggers(n: int, triggers: Optional[Sequence[bool]]) -> np.ndarray:
    if triggers is not None and len(triggers) != n:
        raise ValueError(f"triggers has {len(triggers)} entries for "
                         f"{n} tensors")
    return (np.ascontiguousarray(triggers, dtype=np.uint8)
            if triggers is not None else np.zeros(n, dtype=np.uint8))


def plan_buckets(numels: Sequence[int], message_numel: int,
                 triggers: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Greedy in-order bucket ids, one per tensor (int64): the running
    bucket closes once its element count reaches ``message_numel`` or at
    a trigger tensor (``apex/parallel/distributed.py:339-362``)."""
    n = len(numels)
    trig = _triggers(n, triggers)
    sizes = np.ascontiguousarray(numels, dtype=np.int64)
    ids = np.empty(n, dtype=np.int64)
    library().apex_plan_buckets(
        sizes.ctypes.data_as(_I64P), trig.ctypes.data_as(_U8P), n,
        int(message_numel), ids.ctypes.data_as(_I64P))
    return ids


def _bytes_of(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).ravel()


def fingerprint64(data, seed: int = 0) -> int:
    """64-bit FNV-1a of an array's (or bytes') raw contents; ``seed``
    replaces the offset basis when non-zero."""
    buf = _bytes_of(data)
    return int(library().apex_fingerprint64(
        buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes, seed))


# -- the plain versions ------------------------------------------------------

def flatten_plain(arrays: Sequence[np.ndarray]) -> np.ndarray:
    arrays = [np.asarray(a) for a in arrays]
    _same_dtype(arrays, "flatten")
    return np.concatenate([a.reshape(-1) for a in arrays])


def unflatten_plain(flat: np.ndarray,
                    shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
    flat = np.asarray(flat)
    sizes = _sizes(flat, shapes)
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    return [flat.reshape(-1)[o:o + n].reshape(s).copy()
            for s, n, o in zip(shapes, sizes, starts)]


def plan_buckets_plain(numels: Sequence[int], message_numel: int,
                       triggers: Optional[Sequence[bool]] = None
                       ) -> np.ndarray:
    n = len(numels)
    trig = _triggers(n, triggers)
    ids = np.empty(n, dtype=np.int64)
    bucket = acc = 0
    for i in range(n):
        ids[i] = bucket
        acc += int(numels[i])
        if acc >= message_numel or trig[i]:
            bucket += 1
            acc = 0
    return ids


def fingerprint64_plain(data, seed: int = 0) -> int:
    h = seed if seed else 0xCBF29CE484222325
    for b in _bytes_of(data).tobytes():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
