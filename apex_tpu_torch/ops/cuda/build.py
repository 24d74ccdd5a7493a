"""Build and load the port's CUDA kernels.

Every ``apex_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), and the
objects are linked into ONE shared library with a plain C interface,
loaded with :mod:`ctypes`.  The library's file name carries a hash of
the sources and flags, under ``build/apex_tpu_torch/`` at the root of
the checkout, so a changed source rebuilds and an unchanged one loads.

Nothing here runs at import: the first kernel launch on a CUDA tensor
calls :func:`library`.  A failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "apex_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildInfo:
    """What the last :func:`library` call did: the library path, whether
    it compiled (False = loaded a library built earlier by this
    checkout), the wall seconds of the compile and link, and the
    ``-Xptxas -v`` lines of each kernel (registers, shared memory,
    spills)."""

    path: str
    compiled: bool
    seconds: float
    ptxas: Dict[str, List[str]] = field(default_factory=dict)


_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(stderr: str) -> Dict[str, List[str]]:
    """Group ``ptxas info`` lines under the kernel they describe."""
    out: Dict[str, List[str]] = {}
    current = None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = []
        elif current and "ptxas info" in line and "Function properties" \
                not in line:
            out[current].append(line.split("ptxas info    :")[-1].strip())
        elif current and ("spill" in line or "bytes stack frame" in line):
            out[current].append(line.strip())
    return out


def _compile(so_path: Path) -> BuildInfo:
    nvcc = nvcc_path()
    objdir = so_path.with_suffix(".objs")
    objdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    ptxas: Dict[str, List[str]] = {}
    errors = []
    for src, _obj, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out}{err}")
        ptxas.update(_ptxas_lines(out + err))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for _s, obj, _p in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so_path)
    return BuildInfo(str(so_path), True, time.perf_counter() - t0, ptxas)


def library(rebuild: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has no
    library for the current sources (or, with ``rebuild``, always —
    before the first load of the process)."""
    global _LIB, _INFO
    if _LIB is not None:
        return _LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"libapex_tpu_torch_{_digest()}.so"
    if so_path.exists() and not rebuild:
        info = BuildInfo(str(so_path), False, 0.0)
    else:
        info = _compile(so_path)
    lib = ctypes.CDLL(str(so_path))
    vp, i32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                         ctypes.c_longlong)
    lib.apex_layer_norm_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32,
                                        f32, i32, i32, vp]
    lib.apex_layer_norm_fwd.restype = i32
    lib.apex_flash_attn_fwd.argtypes = ([vp] * 8 + [i64] * 9
                                        + [i32] * 4 + [f32, i32, i32, vp])
    lib.apex_flash_attn_fwd.restype = i32
    lib.apex_flash_attn_smem_bytes.argtypes = [i32]
    lib.apex_flash_attn_smem_bytes.restype = i32
    lib.apex_flash_attn_bwd.argtypes = ([vp] * 12 + [i64] * 12
                                        + [i32] * 4 + [f32, i32, i32, vp])
    lib.apex_flash_attn_bwd.restype = i32
    lib.apex_flash_attn_bwd_smem_bytes.argtypes = [i32]
    lib.apex_flash_attn_bwd_smem_bytes.restype = i32
    lib.apex_layer_norm_bwd.argtypes = [vp] * 10 + [i32] * 4 + [vp]
    lib.apex_layer_norm_bwd.restype = i32
    lib.apex_layer_norm_bwd_parts.argtypes = [i32, i32]
    lib.apex_layer_norm_bwd_parts.restype = i32
    lib.apex_adam.argtypes = [vp] * 8 + [i64] + [f32] * 6 + [i32] * 3 + [vp]
    lib.apex_adam.restype = i32
    lib.apex_multi_tensor_scale.argtypes = [vp] * 4 + [i64, i32, i32, vp]
    lib.apex_multi_tensor_scale.restype = i32
    lib.apex_multi_tensor_sumsq.argtypes = ([vp] * 3 + [i32, i32, vp, i32]
                                            + [vp] * 4)
    lib.apex_multi_tensor_sumsq.restype = i32
    lib.apex_lamb_stage1.argtypes = ([vp] * 3 + [i32, i32] + [vp] * 11
                                     + [f32] * 7 + [i32, i32, vp])
    lib.apex_lamb_stage1.restype = i32
    lib.apex_lamb_stage2.argtypes = ([vp] * 4 + [i32, i32] + [vp] * 6
                                     + [f32, i32, vp])
    lib.apex_lamb_stage2.restype = i32
    lib.apex_cuda_error_string.argtypes = [i32]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    _LIB, _INFO = lib, info
    return lib


def build_info() -> Optional[BuildInfo]:
    """How the loaded library came to be (None before the first load)."""
    return _INFO


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        name = library().apex_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
