"""Seeded, composable fault injection for training-loop chaos tests, as
``apex_tpu/resilience/faults.py``.

Every failure the resilience layer claims to survive has an injectable
analog, so the claims are tested: non-finite gradients, a checkpoint
truncated or corrupted on disk, a preemption mid-step, a hung step, a
killed rank, and slow or flaky checkpoint IO.

Faults are frozen dataclasses; an injector composes any number of them
and is driven by the resilience loop's hooks (or by hand in a test)::

    inj = FaultInjector([NaNStorm(step=4, duration=6),
                         CorruptCheckpoint(step=9, kind="truncate")])
    with inj:
        result = run_resilient(step, amp, batches, ..., injector=inj)
    inj.events   # what fired, when: incident evidence

Gradient poisoning goes through the batch (element 0 of its first
floating tensor), so the non-finite values reach the real backward pass,
the route bad data takes, which amp's overflow skip must absorb.
``NaNStorm.duration`` counts firings, not steps: after a rewind the
replayed steps see clean data, which lets the loop recover.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal as signal_mod
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple


class SimulatedPreemption(RuntimeError):
    """Raised by the injector where SIGTERM would land mid-step."""

    def __init__(self, step: int):
        super().__init__(f"simulated preemption (SIGTERM) at step {step}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class NaNStorm:
    """Non-finite gradients: from ``step``, the batch is poisoned for the
    next ``duration`` firings (``value``: inf by default)."""
    step: int
    duration: int = 1
    value: float = float("inf")


@dataclasses.dataclass(frozen=True)
class CorruptCheckpoint:
    """Damage the first checkpoint committed at/after ``step``:
    ``kind="truncate"`` (preemption mid-write) or ``"corrupt"`` (bit rot);
    target leaf file picked by the injector's seeded RNG."""
    step: int
    kind: str = "truncate"


@dataclasses.dataclass(frozen=True)
class Preempt:
    """Raise :class:`SimulatedPreemption` at the start of ``step``."""
    step: int


@dataclasses.dataclass(frozen=True)
class HangStep:
    """A host hang of ``seconds`` at the start of ``step``, for the
    watchdog.  (A wedged device call cannot be interrupted from Python;
    a host sleep takes the same detection path.)"""
    step: int
    seconds: float = 5.0


@dataclasses.dataclass(frozen=True)
class RankKill:
    """Hard-kill a rank at the start of ``step``.  Unlike :class:`Preempt`
    (an exception the same loop catches), this is SIGKILL: no handlers,
    no flushes; the process is gone, as a preempted machine is to the
    surviving ranks.  ``rank`` scopes the fault (None: whichever rank's
    injector sees the step); ``kill_parent`` also kills the rank's parent
    (its supervisor), so that its heartbeat stops too."""
    step: int
    rank: Optional[int] = None
    signal: int = signal_mod.SIGKILL
    kill_parent: bool = True


@dataclasses.dataclass(frozen=True)
class FlakyIO:
    """The first ``fails`` IO calls of ``op`` raise ``OSError`` (the
    loop's retry with backoff absorbs them)."""
    op: str = "save"
    fails: int = 2


@dataclasses.dataclass(frozen=True)
class SlowIO:
    """Every IO call of ``op`` sleeps ``seconds`` first."""
    op: str = "save"
    seconds: float = 0.05


class FaultInjector:
    """Composes faults behind the hooks the resilience stack calls.

    Hooks (all no-ops when the fault list doesn't match):

    - :meth:`on_step_start` — may sleep (:class:`HangStep`), raise
      (:class:`Preempt`) or SIGKILL the process (:class:`RankKill`);
      call first thing in the step.
    - :meth:`poison_batch`  — returns the (possibly poisoned) batch.
    - :meth:`io_hook`       — pass as ``DurableCheckpointManager(io_hook=...)``.
    - :meth:`on_commit`     — pass as ``DurableCheckpointManager(on_commit=...)``.

    ``rank`` scopes rank-targeted faults (:class:`RankKill` with an
    explicit ``rank`` fires only on the matching injector);
    ``on_rank_kill``, when set, is called as ``on_rank_kill(fault,
    step)`` instead of :meth:`execute_rank_kill`, so that the caller can
    write its record before the kill.

    The victim of :class:`CorruptCheckpoint` is drawn by
    ``random.Random(seed)`` from the sorted leaf files, as the JAX
    package's injector draws it: the same seed and leaf count pick the
    same file.

    Usable as a context manager."""

    def __init__(self, faults: Sequence[Any] = (), seed: int = 0,
                 rank: Optional[int] = None):
        self.faults = list(faults)
        self.rng = random.Random(seed)
        self.rank = rank
        self.events: List[dict] = []
        self.on_rank_kill: Optional[Callable[[RankKill, int], None]] = None
        self._storm_left = {id(f): f.duration for f in self.faults
                            if isinstance(f, NaNStorm)}
        self._flaky_left = {id(f): f.fails for f in self.faults
                            if isinstance(f, FlakyIO)}
        self._fired_once: set = set()   # HangStep/Preempt/CorruptCheckpoint
        self._active = False

    def __enter__(self) -> "FaultInjector":
        self._active = True
        return self

    def __exit__(self, *exc) -> None:
        self._active = False

    def _record(self, fault: str, **info: Any) -> None:
        from apex_tpu_torch.resilience.incidents import utc_now
        self.events.append({"fault": fault, "utc": utc_now(), **info})

    # -- hooks -----------------------------------------------------------
    def on_step_start(self, step: int) -> None:
        """Each fault fires once: a rewound or restarted run replays step
        indices, and a hang or preemption is an event, not a property of
        the step number."""
        for f in self.faults:
            if id(f) in self._fired_once:
                continue
            if isinstance(f, HangStep) and f.step == step:
                self._fired_once.add(id(f))
                self._record("hang_step", step=step, seconds=f.seconds)
                time.sleep(f.seconds)
            elif isinstance(f, Preempt) and f.step == step:
                self._fired_once.add(id(f))
                self._record("preempt", step=step)
                raise SimulatedPreemption(step)
            elif isinstance(f, RankKill) and f.step == step \
                    and (f.rank is None or f.rank == self.rank):
                self._fired_once.add(id(f))
                self._record("rank_kill", step=step, rank=self.rank,
                             signal=int(f.signal),
                             kill_parent=bool(f.kill_parent))
                if self.on_rank_kill is not None:
                    self.on_rank_kill(f, step)
                else:
                    self.execute_rank_kill(f)

    def execute_rank_kill(self, fault: RankKill) -> None:
        """The default :class:`RankKill` trigger: kill the parent (the
        rank's supervisor), then this process; it does not return."""
        if fault.kill_parent:
            try:
                os.kill(os.getppid(), fault.signal)
            except (OSError, ProcessLookupError):
                pass
        os.kill(os.getpid(), fault.signal)

    def poison_batch(self, step: int, batch: Tuple[Any, ...]
                     ) -> Tuple[Any, ...]:
        """``batch`` with element 0 of its first floating (or complex)
        tensor set to the storm's value, on that tensor's device and out
        of place (the JAX package's ``.at[0].set``), while a
        :class:`NaNStorm` is firing; else ``batch`` itself."""
        import torch
        import torch.utils._pytree as pytree
        for f in self.faults:
            if not isinstance(f, NaNStorm) or step < f.step:
                continue
            if self._storm_left.get(id(f), 0) <= 0:
                continue
            self._storm_left[id(f)] -= 1
            self._record("nan_storm", step=step, value=repr(f.value))
            leaves, spec = pytree.tree_flatten(batch)
            for i, leaf in enumerate(leaves):
                if isinstance(leaf, torch.Tensor) and (
                        leaf.is_floating_point() or leaf.is_complex()) \
                        and leaf.numel():
                    flat = leaf.detach().reshape(-1).clone()
                    flat[0] = f.value
                    leaves[i] = flat.reshape(leaf.shape)
                    break
            return pytree.tree_unflatten(leaves, spec)
        return batch

    def io_hook(self, op: str) -> None:
        for f in self.faults:
            if isinstance(f, SlowIO) and f.op == op:
                self._record("slow_io", op=op, seconds=f.seconds)
                time.sleep(f.seconds)
            elif isinstance(f, FlakyIO) and f.op == op \
                    and self._flaky_left.get(id(f), 0) > 0:
                self._flaky_left[id(f)] -= 1
                self._record("flaky_io", op=op,
                             remaining=self._flaky_left[id(f)])
                raise OSError(f"injected flaky {op} IO")

    def on_commit(self, step: int, path: str) -> None:
        for f in self.faults:
            if not isinstance(f, CorruptCheckpoint) or id(f) in \
                    self._fired_once or step < f.step:
                continue
            self._fired_once.add(id(f))
            leaf_files = sorted(n for n in os.listdir(path)
                                if n.endswith(".npy"))
            if not leaf_files:
                continue
            victim = os.path.join(path, self.rng.choice(leaf_files))
            size = os.path.getsize(victim)
            if f.kind == "truncate":
                with open(victim, "r+b") as fh:
                    fh.truncate(max(0, size // 2))
            else:
                with open(victim, "r+b") as fh:
                    fh.seek(max(0, size // 2))
                    chunk = fh.read(8)
                    fh.seek(max(0, size // 2))
                    fh.write(bytes(b ^ 0xFF for b in chunk))
            self._record("corrupt_checkpoint", step=step, kind=f.kind,
                         file=os.path.basename(victim))


def parse_fault(spec: str) -> Any:
    """``name@step[:arg]`` / ``name[:arg]`` -> a fault dataclass, the JAX
    package's vocabulary:

    - ``nan_storm@S[:D]``: poison the batch for D firings from S
    - ``ckpt_truncate@S`` / ``ckpt_corrupt@S``: damage the first
      checkpoint committed at or after S
    - ``preempt@S``: an in-process preemption at S
    - ``rank_kill@S[:RANK]``: SIGKILL a rank at S (every rank without
      RANK)
    - ``hang@S[:SEC]``: a host hang at S
    - ``flaky_io[:N]``: the first N saves raise OSError
    - ``slow_io[:SEC]``: every save sleeps SEC first

    Raises ``ValueError`` on an unknown name or a missing step.
    """
    name, _, rest = spec.partition("@")
    step_s, _, arg = rest.partition(":")
    if not rest:          # no @: arg may ride on the name (flaky_io:3)
        name, _, arg = spec.partition(":")
        step_s = ""
    step = int(step_s) if step_s else None
    if step is None and name in ("nan_storm", "ckpt_truncate",
                                 "ckpt_corrupt", "preempt", "rank_kill",
                                 "hang"):
        raise ValueError(f"fault {name!r} needs a step: {name}@STEP[:arg]")
    if name == "nan_storm":
        return NaNStorm(step=step, duration=int(arg) if arg else 6)
    if name == "ckpt_truncate":
        return CorruptCheckpoint(step=step, kind="truncate")
    if name == "ckpt_corrupt":
        return CorruptCheckpoint(step=step, kind="corrupt")
    if name == "preempt":
        return Preempt(step=step)
    if name == "rank_kill":
        return RankKill(step=step, rank=int(arg) if arg else None)
    if name == "hang":
        return HangStep(step=step, seconds=float(arg) if arg else 2.0)
    if name == "flaky_io":
        return FlakyIO(op="save", fails=int(arg) if arg else 2)
    if name == "slow_io":
        return SlowIO(op="save", seconds=float(arg) if arg else 0.05)
    raise ValueError(f"unknown fault spec {spec!r}")
