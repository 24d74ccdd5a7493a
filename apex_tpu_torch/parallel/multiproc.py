"""Process-group setup and the local spawner (``apex_tpu/parallel/
multiproc.py``).

- :func:`initialize` forms ``torch.distributed``'s default group from
  the JAX package's environment contract (``COORDINATOR_ADDRESS`` =
  ``host:port``, ``WORLD_SIZE``, ``RANK``), or from torchrun's
  ``MASTER_ADDR`` / ``MASTER_PORT`` when ``COORDINATOR_ADDRESS`` is not
  set.  The backend is explicit: ``"nccl"`` by default (entry points run
  on the card), ``"gloo"`` when the caller names the CPU; one is never
  swapped for the other.  Cluster formation is bounded as in JAX:
  ``APEX_TPU_INIT_TIMEOUT_S`` a try (``init_process_group(timeout=...)``),
  ``APEX_TPU_INIT_RETRIES`` retries with exponential backoff from
  ``APEX_TPU_INIT_BACKOFF_S``, then :class:`ClusterInitError` naming the
  ranks that can be missing; a second ``initialize`` fails at once.
- :func:`spawn` / ``python -m apex_tpu_torch.parallel.multiproc
  script.py ...`` start ``world_size`` copies of a script on this
  machine with that environment exported: rank 0 writes to stdout, every
  other rank to ``PROC_<i>.log``, every rank's stderr to
  ``PROC_<i>.err``; a failing rank tears the rest down and is reported
  with its stderr's tail, and ranks still running
  ``APEX_TPU_SPAWN_GRACE_S`` after a peer exited cleanly are reaped.

The JAX package's ``spmd_preflight`` hashes a lowered XLA module; it
waits for the port of ``apex_tpu/analysis/``, and
``initialize(preflight=...)`` raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from typing import Any, List, Optional, Sequence

from apex_tpu_torch.ops import DeviceLike, resolve_device


class ClusterInitError(RuntimeError):
    """Cluster formation failed within the configured timeout / retry
    budget; the message names the expected world and the ranks that can
    be missing."""


def _env_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    return float(val) if val not in (None, "") else default


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               retries: Optional[int] = None,
               backoff_s: Optional[float] = None,
               preflight: Any = None,
               preflight_label: str = "train_step",
               backend: Optional[str] = None,
               device: DeviceLike = None) -> None:
    """Form the default process group of this process.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``COORDINATOR_ADDRESS`` (else
    ``MASTER_ADDR:MASTER_PORT``), ``WORLD_SIZE`` and ``RANK``; all three
    must be known.  ``backend`` defaults to ``"nccl"``, or ``"gloo"``
    when ``device`` is the CPU.  On the card the process takes device
    ``LOCAL_RANK`` (else its rank) modulo the device count.  Each try
    waits ``timeout_s`` (``APEX_TPU_INIT_TIMEOUT_S``, default 300) and
    is retried ``retries`` times (``APEX_TPU_INIT_RETRIES``, default 2)
    after ``backoff_s * 2**try`` seconds (``APEX_TPU_INIT_BACKOFF_S``,
    default 5); then :class:`ClusterInitError`.  A process whose group is
    already formed raises ``RuntimeError`` at once."""
    import torch
    import torch.distributed as dist
    if preflight is not None:
        raise NotImplementedError(
            "spmd_preflight hashes a lowered XLA module and waits for the "
            "port of apex_tpu/analysis/ (ROADMAP.md Queue 1, analysis/)")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in "
                           "this process")
    dev = resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    addr = _address(coordinator_address)
    ws = num_processes if num_processes is not None \
        else os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    missing = [name for name, v in (("COORDINATOR_ADDRESS", addr),
                                    ("WORLD_SIZE", ws), ("RANK", rank))
               if v in (None, "")]
    if missing:
        raise ValueError(f"initialize needs {missing} (arguments or "
                         "environment; torchrun's MASTER_ADDR / "
                         "MASTER_PORT stand for COORDINATOR_ADDRESS)")
    ws, rank = int(ws), int(rank)
    timeout_s = timeout_s if timeout_s is not None else \
        _env_float("APEX_TPU_INIT_TIMEOUT_S", 300.0)
    retries = int(retries if retries is not None else
                  _env_float("APEX_TPU_INIT_RETRIES", 2))
    backoff_s = backoff_s if backoff_s is not None else \
        _env_float("APEX_TPU_INIT_BACKOFF_S", 5.0)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    attempts = retries + 1
    last_error: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{addr}", world_size=ws,
                rank=rank,
                timeout=datetime.timedelta(seconds=max(1.0, timeout_s)))
            return None
        except (RuntimeError, OSError, ValueError) as e:
            # a double initialize is a programming error, not weather
            if "already initialized" in str(e).lower() \
                    or "twice" in str(e).lower():
                raise
            last_error = e
            if attempt + 1 < attempts:
                time.sleep(backoff_s * (2.0 ** attempt))
    others = sorted(set(range(ws)) - {rank})
    raise ClusterInitError(
        f"cluster init failed after {attempts} attempt(s) x {timeout_s:g}s "
        f"(coordinator {addr}, backend {backend}): this is rank {rank} of "
        f"{ws}; the missing peer(s) are among ranks {others}.  Last error: "
        f"{last_error!r}.  Tune via APEX_TPU_INIT_TIMEOUT_S / "
        "APEX_TPU_INIT_RETRIES / APEX_TPU_INIT_BACKOFF_S.") from last_error


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stderr_tail(path: str, limit: int = 2000) -> str:
    """The last ``limit`` characters of a rank's captured stderr."""
    try:
        with open(path, "r", errors="replace") as f:
            data = f.read().strip()
    except OSError:
        return "<no stderr captured>"
    return data[-limit:] if data else "<stderr empty>"


def _stop(workers: Sequence[subprocess.Popen]) -> None:
    """SIGTERM every running worker, then SIGKILL those still up 5 s
    later; reaps them all."""
    for p in workers:
        if p.poll() is None:
            p.terminate()
    for p in workers:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spawn(argslist: Sequence[str], world_size: Optional[int] = None,
          coordinator_port: Optional[int] = None,
          log_prefix: str = "PROC_") -> List[int]:
    """Start ``world_size`` copies of ``python argslist...`` with
    ``COORDINATOR_ADDRESS`` (``localhost:<port>``), ``WORLD_SIZE`` and
    ``RANK`` exported, wait for all, and return their exit codes.

    ``world_size`` defaults to ``WORLD_SIZE``; ``coordinator_port`` to
    ``COORDINATOR_PORT``, else a free port.  Rank 0 inherits stdout, rank
    i > 0 writes it to ``{log_prefix}{i}.log``; every rank's stderr goes
    to ``{log_prefix}{i}.err``.  A rank that exits non-zero gets the
    others terminated and raises :class:`ClusterInitError` with its
    stderr's tail.  Once a rank exits 0, the rest get
    ``max(APEX_TPU_SPAWN_GRACE_S, runtime so far)`` seconds (default 60;
    ``<= 0`` waits forever) before they are terminated and reported as
    wedged."""
    argslist = list(argslist)
    if world_size is None:
        ws_env = os.environ.get("WORLD_SIZE")
        if not ws_env:
            raise ValueError("spawn() needs world_size= or the WORLD_SIZE "
                             "environment variable")
        world_size = int(ws_env)
    if coordinator_port is None:
        coordinator_port = int(os.environ.get("COORDINATOR_PORT")
                               or _free_port())
    workers: List[subprocess.Popen] = []
    logs = []
    err_paths: List[str] = []

    def _raise_first_failure(codes: List[Optional[int]]) -> None:
        bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
        first = bad[0]
        raise ClusterInitError(
            f"rank {first} exited with code {codes[first]} (failing ranks: "
            f"{bad}; exit codes: {codes}).  rank {first} stderr tail "
            f"({err_paths[first]}):\n{_stderr_tail(err_paths[first])}")

    try:
        for i in range(world_size):
            env = dict(os.environ,
                       COORDINATOR_ADDRESS=f"localhost:{coordinator_port}",
                       WORLD_SIZE=str(world_size), RANK=str(i))
            stdout = None
            if i != 0:
                stdout = open(f"{log_prefix}{i}.log", "w")
                logs.append(stdout)
            stderr = open(f"{log_prefix}{i}.err", "w")
            logs.append(stderr)
            err_paths.append(f"{log_prefix}{i}.err")
            workers.append(subprocess.Popen([sys.executable] + argslist,
                                            stdout=stdout, stderr=stderr,
                                            env=env))
        grace_s = _env_float("APEX_TPU_SPAWN_GRACE_S", 60.0)
        launch_t = time.monotonic()
        first_done: Optional[float] = None
        grace_eff = grace_s
        while True:
            codes = [p.poll() for p in workers]
            if all(c is not None for c in codes):
                if any(c != 0 for c in codes):
                    _raise_first_failure(codes)
                return codes
            if any(c not in (None, 0) for c in codes):
                first_bad = list(codes)     # before the peers get -15
                _stop(workers)
                _raise_first_failure(first_bad)
            if grace_s > 0 and any(c == 0 for c in codes):
                if first_done is None:
                    first_done = time.monotonic()
                    grace_eff = max(grace_s, first_done - launch_t)
                elif time.monotonic() - first_done > grace_eff:
                    wedged = [i for i, c in enumerate(codes) if c is None]
                    _stop(workers)
                    raise ClusterInitError(
                        f"ranks {wedged} still running {grace_eff:g}s after "
                        f"rank {codes.index(0)} exited cleanly (exit codes "
                        f"{codes}): wedged in a collective whose peer is "
                        f"gone; terminated.  rank {wedged[0]} stderr tail "
                        f"({err_paths[wedged[0]]}):\n"
                        f"{_stderr_tail(err_paths[wedged[0]])}")
            time.sleep(0.1)
    finally:
        _stop(workers)
        for f in logs:
            f.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m apex_tpu_torch.parallel.multiproc "
              "script.py ...", file=sys.stderr)
        return 2
    try:
        codes = spawn(argv)
    except ClusterInitError as e:
        print(f"multiproc: {e}", file=sys.stderr)
        return 1
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
