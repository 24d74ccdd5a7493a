"""Comparison helpers shared by the port's tests and ``chip_smoke.py``,
and :func:`start_ranks` / :func:`run_ranks`, the tests' multi-process
launcher with a deadline."""

from __future__ import annotations

import torch


#: where an fp32 sum cancels toward zero, two summation orders differ by
#: more than a bf16 ulp of the tiny result; below this absolute
#: difference elements count as equal
BF16_CANCEL_ATOL = 2.0 ** -16


def _ulp16_distance(a: torch.Tensor, b: torch.Tensor, atol: float) -> int:
    if a.numel() == 0:
        return 0

    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    dist = (key(a) - key(b)).abs()
    if atol > 0:
        close = (a.float() - b.float()).abs() <= atol
        dist = torch.where(close, torch.zeros_like(dist), dist)
    return int(dist.max())


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor,
                      atol: float = 0.0) -> int:
    """Largest distance, in units in the last place, between two bf16
    tensors of one shape (adjacent bf16 values are 1 apart; +0 and -0
    are 0 apart), ignoring elements whose absolute difference is at
    most ``atol``."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("bf16_ulp_distance compares two bf16 tensors")
    return _ulp16_distance(a, b, atol)


def half_ulp_distance(a: torch.Tensor, b: torch.Tensor,
                      atol: float = 0.0) -> int:
    """:func:`bf16_ulp_distance` for two tensors of one 16-bit float
    type, bf16 or fp16 (both order their bit patterns as sign and
    magnitude)."""
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError("half_ulp_distance compares two bf16 or two fp16 "
                        "tensors")
    return _ulp16_distance(a, b, atol)


def assert_tokens_match_above_margin(got, want, margins,
                                     min_margin: float = 1e-3):
    """Greedy streams ``got`` and ``want`` must agree token by token,
    except at a step whose reference top-2 logit margin ``margins[t]``
    is at most ``min_margin``: there the two may pick differently (a
    near tie, which the rounding of another framework can flip) and the
    streams stop being comparable.  ``margins`` may be a callable that
    computes them, called only at a divergence.  Returns the step of
    such a recorded near tie, or None when the streams are equal."""
    got, want = list(map(int, got)), list(map(int, want))
    if len(got) != len(want):
        raise AssertionError(f"stream lengths differ: {len(got)} vs "
                             f"{len(want)}")
    for t, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if callable(margins):
                margins = margins()
            if float(margins[t]) > min_margin:
                raise AssertionError(
                    f"step {t}: token {a} vs reference {b} at top-2 "
                    f"margin {float(margins[t]):.3g} > {min_margin}")
            return t
    return None


def start_ranks(source: str, world: int, workdir,
                deadline_s: float = 120.0, init_timeout_s: float = 60.0):
    """Start the Python ``source`` as ``world`` ranks on this machine
    through ``python -m apex_tpu_torch.parallel.multiproc``, in
    ``workdir`` (the script, the ranks' logs and whatever they write go
    there; the script gets ``workdir`` as its argument), and return a
    function that waits for them.  The ranks form their group with
    ``APEX_TPU_INIT_TIMEOUT_S=init_timeout_s``; the launcher and every
    rank are killed ``deadline_s`` after the start.  The wait raises
    ``AssertionError`` with the launcher's stderr (a failing rank's tail)
    when a rank fails or the deadline passes."""
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    import time
    workdir = pathlib.Path(workdir)
    script = workdir / "rank.py"
    script.write_text(source)
    root = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, WORLD_SIZE=str(world),
               APEX_TPU_INIT_TIMEOUT_S=str(init_timeout_s),
               APEX_TPU_INIT_RETRIES="0", OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         str(script), str(workdir)], cwd=workdir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    end = time.monotonic() + deadline_s

    def wait() -> None:
        try:
            out, err = proc.communicate(
                timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            raise AssertionError(f"ranks still running at the "
                                 f"{deadline_s:g} s deadline; killed."
                                 f"\n{out}\n{err}")
        if proc.returncode != 0:
            raise AssertionError(f"ranks failed (launcher exit "
                                 f"{proc.returncode}):\n{out}\n{err}")

    return wait


def run_ranks(source: str, world: int, workdir, deadline_s: float = 120.0,
              init_timeout_s: float = 60.0) -> None:
    """:func:`start_ranks` and wait for them."""
    start_ranks(source, world, workdir, deadline_s, init_timeout_s)()
