"""Elastic self-healing training fleet: shrink when a rank dies, regrow
when it returns, with bitwise recovery, as ``apex_tpu/resilience/
fleet.py``.

The training state is an :class:`~apex_tpu_torch.amp.Amp` replicated on
every rank (DDP + amp O2), so a snapshot written by N ranks restores on
any other count.  The parts are the port's own: ``run_resilient``'s
watchdog and rewind, ``DurableCheckpointManager``, ``multiproc``'s
bounded-retry group formation, the flight recorder; this module composes
them into a loop that survives a rank's death:

- **heartbeat lease, never a collective**: each rank's liveness is a
  lease file in a shared :class:`FleetLedger` directory (atomic
  tmp + rename writes; a shared filesystem on a cluster, a temporary
  directory in the drill).  The detector of a wedged collective must
  never itself be a collective, and the group's store dies with the rank
  that holds it, exactly the rank whose death the fleet must survive.
- **bounded detection**: a membership gate runs before every dispatch:
  a member whose lease is older than ``lease_ttl_s`` means *shrink*; a
  fresh lease from a non-member means *regrow*.  The gate raises
  :class:`FleetMembershipChange` before the next collective is queued,
  so at most one step in flight meets the dead peer (and gloo's
  peer-closed error from that step is classified by the same lease
  check).
- **generations**: each formation of the group is a generation with an
  immutable plan (``gen/gen_NNNN.json``: members, coordinator port,
  restore step).  A membership change ends the generation: every
  surviving child exits with :data:`EXIT_MEMBERSHIP`, the rank's
  supervisor elects a leader (the smallest surviving member: a returning
  rank waits as a joiner and never leads a replan; a joiner takes over
  only when every member's lease is stale), the leader writes the next
  plan (an ``O_EXCL`` create: exactly one wins), and each supervisor
  starts a fresh child that forms the group again through
  :func:`apex_tpu_torch.parallel.multiproc.initialize`.
- **checkpoint or rewind**: the generation's leader (its first member)
  owns the :class:`~apex_tpu_torch.resilience.durable.
  DurableCheckpointManager`; the plan's ``restore_step`` is the newest
  snapshot that verifies, so every member restores the same step (steps
  lost <= ``checkpoint_every`` by construction).

Placement is explicit: :class:`FleetConfig` names the ``device`` (the
card by default) and the ``backend`` (NCCL by default); ranks that share
one card run gloo, and only when the caller says so.  Each formation
runs the SPMD preflight (:func:`~apex_tpu_torch.parallel.multiproc.
spmd_preflight`) over a dry capture of the step's communicating part
(:meth:`_Workload.capture`: the gradients' reduction and the loss's
mean), and its ``preflight`` event carries the verdict, the number of
collectives and the schedule's hash, as JAX's does.  The JAX package
also loads its step from an AOT cache; the port compiles nothing, and
its ``aot`` event says ``source: "eager"``.  The ledger's files are JAX's, name for name and key
for key: either package reads a ledger the other wrote.

Every kill, shrink, restore and regrow lands in the flight recorder and
in an incident record (``incidents/`` in the ledger).
:func:`apex_tpu_torch.testing.run_fleet_drill` runs the drill.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "EXIT_MEMBERSHIP", "FleetError", "FleetMembershipChange",
    "FleetConfig", "FleetLedger", "HeartbeatLease", "FleetMetrics",
    "latest_verified_step", "load_snapshot_state", "snapshot_digest",
    "state_digest", "membership_gate", "run_generation", "supervise",
]

#: child exit code meaning "the generation ended because membership
#: changed (shrink / regrow / new plan): replan and start me again"
EXIT_MEMBERSHIP = 17


class FleetError(RuntimeError):
    """Fleet-level orchestration failure (formation or replan timeout,
    malformed plan, generation budget exhausted)."""


class FleetMembershipChange(FleetError):
    """The membership gate saw the fleet change shape: a member lease
    expired (``reason="shrink"``), a non-member published a fresh lease
    (``"regrow"``), or a newer generation plan appeared (``"plan"``).
    Raised *before* the next step is dispatched: ending the generation
    is the recovery, not an error."""

    def __init__(self, reason: str, ranks: Sequence[int], step: int):
        self.reason = reason
        self.ranks = list(ranks)
        self.step = int(step)
        super().__init__(
            f"fleet membership change at step {step}: {reason} "
            f"(ranks {self.ranks})")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetConfig:
    """Fleet parameters, serialized to ``config.json`` in the ledger so
    every supervisor and generation child reads one source of truth.
    Times are seconds."""

    num_steps: int = 24
    checkpoint_every: int = 4
    world_size: int = 2
    seed: int = 0
    # liveness
    lease_ttl_s: float = 2.0
    heartbeat_s: float = 0.25
    poll_s: float = 0.1
    # group formation / replanning
    init_timeout_s: float = 60.0
    init_retries: int = 1
    form_window_s: float = 60.0
    replan_window_s: float = 60.0
    max_generations: int = 8
    # child supervision
    stall_budget_s: float = 90.0
    child_grace_s: float = 5.0
    watchdog_timeout_s: float = 60.0
    # workload (a DDP + amp O2 MLP; per-rank batch)
    batch: int = 4
    d_in: int = 8
    hidden: int = 16
    min_loss_scale: float = 2.0 ** 14
    #: host sleep per step (drill pacing: an unthrottled generation ends
    #: before a returning rank can rejoin it; wall time only, no effect
    #: on the math: the bitwise replays run with it at 0)
    step_delay_s: float = 0.0
    # fault specs (``resilience/faults.py`` vocabulary, e.g.
    # ``rank_kill@10:1``), applied inside generation children
    faults: Tuple[str, ...] = ()
    #: where each rank's child trains (the card unless the caller names
    #: the CPU) and the group's backend; ranks sharing one card need gloo
    #: (NCCL refuses two ranks on one device), which the caller picks
    device: str = "cuda"
    backend: str = "nccl"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = list(self.faults)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FleetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["faults"] = tuple(kw.get("faults", ()))
        return cls(**kw)


# ---------------------------------------------------------------------------
# the ledger: atomic-write JSON files in a shared directory
# ---------------------------------------------------------------------------

def _atomic_write_json(path: str, obj: Any, exclusive: bool = False) -> bool:
    """Write ``obj`` as JSON via tmp + rename (readers never see a torn
    file).  With ``exclusive`` the final link is created with O_EXCL:
    exactly one concurrent writer wins; returns whether *this* call
    won."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    if not exclusive:
        os.replace(tmp, path)
        return True
    try:
        os.link(tmp, path)
    except FileExistsError:
        return False
    finally:
        os.unlink(tmp)
    return True


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None    # absent or mid-replace: the caller polls again


class FleetLedger:
    """File-based coordination state of one fleet run.

    Layout (all JSON, all atomic writes)::

        root/
          config.json             # FleetConfig
          hb/rank_R.json          # heartbeat lease (supervisor-owned)
          progress/rank_R.json    # child training progress (child-owned)
          member/rank_R.json      # announcements {rank, incarnation}
          gen/gen_NNNN.json       # immutable generation plans
          events/<ns>_<pid>_R_kind.json   # append-only event log
          finals/rank_R.json      # per-rank final digest on completion
          incidents/*.json        # incident records
          ckpt/ aot/ logs/        # durable snapshots, (unused), logs

    The lease is written by the rank's *supervisor* (it keeps beating
    while a generation child runs, and a killed rank loses both
    processes, so the lease goes stale within one TTL); ``progress`` is
    written by the child and is the supervisor's stall detector.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        for sub in ("hb", "progress", "member", "gen", "events",
                    "finals", "incidents", "ckpt", "aot", "logs"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)

    # -- paths -----------------------------------------------------------
    def path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    @property
    def ckpt_dir(self) -> str:
        return self.path("ckpt")

    @property
    def aot_dir(self) -> str:
        return self.path("aot")

    # -- config ----------------------------------------------------------
    def write_config(self, cfg: FleetConfig) -> None:
        _atomic_write_json(self.path("config.json"), cfg.to_json())

    def read_config(self) -> FleetConfig:
        doc = _read_json(self.path("config.json"))
        if doc is None:
            raise FleetError(f"no config.json in ledger {self.root}")
        return FleetConfig.from_json(doc)

    # -- heartbeats ------------------------------------------------------
    def heartbeat(self, rank: int, **info: Any) -> None:
        _atomic_write_json(self.path("hb", f"rank_{rank}.json"),
                           {"rank": int(rank), "ts": time.time(),
                            "pid": os.getpid(), **info})

    def read_heartbeat(self, rank: int) -> Optional[dict]:
        return _read_json(self.path("hb", f"rank_{rank}.json"))

    def lease_age(self, rank: int) -> Optional[float]:
        hb = self.read_heartbeat(rank)
        return None if hb is None else max(0.0, time.time() - hb["ts"])

    def fresh(self, rank: int, ttl_s: float) -> bool:
        age = self.lease_age(rank)
        return age is not None and age <= ttl_s

    def live_ranks(self, ttl_s: float) -> List[int]:
        return sorted(r for r in self.announced() if self.fresh(r, ttl_s))

    # -- progress (child-owned) ------------------------------------------
    def progress(self, rank: int, **info: Any) -> None:
        _atomic_write_json(self.path("progress", f"rank_{rank}.json"),
                           {"rank": int(rank), "ts": time.time(),
                            "pid": os.getpid(), **info})

    def read_progress(self, rank: int) -> Optional[dict]:
        return _read_json(self.path("progress", f"rank_{rank}.json"))

    # -- membership announcements ----------------------------------------
    def announce(self, rank: int) -> int:
        """Register (or re-register) a rank; returns its incarnation
        (0 on the first join, + 1 a relaunch): plans record these, so a
        relaunched supervisor never adopts a plan written for its
        previous life."""
        path = self.path("member", f"rank_{rank}.json")
        prev = _read_json(path)
        inc = 0 if prev is None else int(prev.get("incarnation", 0)) + 1
        _atomic_write_json(path, {"rank": int(rank), "incarnation": inc,
                                  "ts": time.time(), "pid": os.getpid()})
        return inc

    def announced(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for name in os.listdir(self.path("member")):
            if name.startswith("rank_") and name.endswith(".json"):
                doc = _read_json(self.path("member", name))
                if doc is not None:
                    out[int(doc["rank"])] = doc
        return out

    def incarnation(self, rank: int) -> Optional[int]:
        doc = self.announced().get(rank)
        return None if doc is None else int(doc.get("incarnation", 0))

    # -- generation plans ------------------------------------------------
    def _plan_path(self, gen: int) -> str:
        return self.path("gen", f"gen_{int(gen):04d}.json")

    def write_plan(self, plan: dict) -> bool:
        """Atomically create the plan of its generation; False when a
        concurrent leader already committed one (the caller then reads
        and follows the winner)."""
        return _atomic_write_json(self._plan_path(plan["gen"]), plan,
                                  exclusive=True)

    def read_plan(self, gen: int) -> Optional[dict]:
        return _read_json(self._plan_path(gen))

    def latest_plan(self) -> Optional[dict]:
        gens = []
        for name in os.listdir(self.path("gen")):
            if name.startswith("gen_") and name.endswith(".json"):
                try:
                    gens.append(int(name[4:-5]))
                except ValueError:
                    pass
        return self.read_plan(max(gens)) if gens else None

    # -- event log -------------------------------------------------------
    def event(self, rank: int, kind: str, **data: Any) -> dict:
        from apex_tpu_torch.resilience.incidents import utc_now
        rec = {"ts": time.time(), "utc": utc_now(), "rank": int(rank),
               "kind": kind, **data}
        name = f"{time.time_ns():020d}_{os.getpid()}_{rank}_{kind}.json"
        _atomic_write_json(self.path("events", name), rec)
        return rec

    def events(self) -> List[dict]:
        out = []
        for name in sorted(os.listdir(self.path("events"))):
            if name.endswith(".json"):
                doc = _read_json(self.path("events", name))
                if doc is not None:
                    out.append(doc)
        return sorted(out, key=lambda d: d.get("ts", 0.0))

    # -- finals ----------------------------------------------------------
    def final(self, rank: int, **data: Any) -> None:
        _atomic_write_json(self.path("finals", f"rank_{rank}.json"),
                           {"rank": int(rank), "ts": time.time(), **data})

    def finals(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for name in os.listdir(self.path("finals")):
            if name.startswith("rank_") and name.endswith(".json"):
                doc = _read_json(self.path("finals", name))
                if doc is not None:
                    out[int(doc["rank"])] = doc
        return out


class HeartbeatLease:
    """Daemon thread renewing one rank's lease (or progress record)
    every ``interval_s``.  ``info_fn`` is sampled at each beat: the child
    publishes its current absolute step through it, which is both the
    supervisor's stall detector and the drill's timeline."""

    def __init__(self, ledger: FleetLedger, rank: int, interval_s: float,
                 info_fn: Optional[Callable[[], dict]] = None,
                 kind: str = "hb"):
        self._ledger = ledger
        self._rank = int(rank)
        self._interval = float(interval_s)
        self._info_fn = info_fn
        self._write = (ledger.heartbeat if kind == "hb" else ledger.progress)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        info = {}
        if self._info_fn is not None:
            try:
                info = dict(self._info_fn())
            except Exception:   # a flaky sampler must not kill the lease
                info = {}
        try:
            self._write(self._rank, **info)
        except OSError:
            pass    # one missed beat is absorbed by the TTL

    def start(self) -> "HeartbeatLease":
        self.beat()     # the lease exists before start() returns
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"apex-tpu-torch-lease-{self._rank}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "HeartbeatLease":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# read-only snapshot helpers (a rank that is not the leader never builds a
# DurableCheckpointManager: construction sweeps .tmp-* staging dirs and
# would race the leader's commit)
# ---------------------------------------------------------------------------

def latest_verified_step(directory: str) -> Optional[int]:
    """The newest snapshot step in ``directory`` that passes full
    checksum verification (a corrupt or truncated one is skipped, as
    ``DurableCheckpointManager.restore`` skips it): the step a new
    generation's plan pins as ``restore_step``."""
    from apex_tpu_torch.resilience import durable
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(durable._STEP_PREFIX):
            try:
                steps.append(int(name[len(durable._STEP_PREFIX):]))
            except ValueError:
                pass
    for step in sorted(steps, reverse=True):
        ok, _problems = durable.verify_snapshot(
            os.path.join(directory, durable._step_dirname(step)))
        if ok:
            return step
    return None


def load_snapshot_state(directory: str, step: int, template: Any,
                        extras: Optional[dict] = None) -> Tuple[Any, dict]:
    """Read-only restore of one pinned snapshot step into ``template``
    (an :class:`~apex_tpu_torch.amp.Amp`, in place, each leaf onto its
    tensor's device and dtype), checksum-verified (raises
    ``CheckpointCorruptError`` on damage); returns ``(template,
    extras)``.  Every member restores THE step its plan names, never its
    newest, which async saves can skew across ranks."""
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.resilience import durable

    path = os.path.join(directory, durable._step_dirname(step))
    values, manifest = durable.read_snapshot(path)
    target = ckpt.payload_template(template, extras)
    keys = [k for k, _ in durable.tree_leaves_with_path(target)]
    ckpt.check_same_structure(set(values), set(keys),
                              context=f"fleet snapshot step {step}")
    metas = manifest["leaves"]
    payload = durable.tree_map_with_path(
        lambda k, _t: durable.as_tensor(values[k], metas[k]["dtype"]),
        target)
    state, ex = ckpt.load_state_dict(template, payload)
    return state, (durable.place_like(ex, extras) if extras else ex)


def _combine_leaf_hashes(pairs: Sequence[Tuple[str, str]]) -> str:
    import hashlib
    h = hashlib.sha256()
    for key, sha in sorted(pairs):
        h.update(f"{key}:{sha}\n".encode("utf-8"))
    return h.hexdigest()


def state_digest(state: Any, extras: Optional[dict] = None) -> str:
    """Order-independent digest over every leaf of a state's checkpoint
    payload: BY CONSTRUCTION equal to :func:`snapshot_digest` of a
    snapshot of the same state (the same flattening, the same npy bytes
    that :func:`~apex_tpu_torch.resilience.durable.write_snapshot` hashes,
    bf16 leaves as their ``V2`` words), and to the JAX package's
    ``state_digest`` of the same state, so a replay compares bit for bit
    with a drill's snapshot without writing one."""
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.resilience import durable

    pairs = [(key, durable._sha256(*durable._npy_parts(arr)))
             for key, arr, _dtype in durable._flatten_payload(
                 ckpt.state_dict(state, extras))]
    return _combine_leaf_hashes(pairs)


def snapshot_digest(directory: str, step: int) -> str:
    """The :func:`state_digest`-comparable digest of one committed
    snapshot, from its manifest's checksums alone (no array IO)."""
    from apex_tpu_torch.resilience import durable
    manifest = _read_json(os.path.join(
        directory, durable._step_dirname(step), durable.MANIFEST))
    if manifest is None:
        raise FileNotFoundError(
            f"no snapshot manifest for step {step} in {directory}")
    return _combine_leaf_hashes(
        [(k, meta["sha256"]) for k, meta in manifest["leaves"].items()])


# ---------------------------------------------------------------------------
# fleet metrics (recorded by run_resilient at its lag-resolved point: host
# numbers only)
# ---------------------------------------------------------------------------

#: recovery wall-clock buckets (seconds): replan + formation + restore on
#: one machine lands in seconds; a cluster rejoin in minutes
RECOVERY_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class FleetMetrics:
    """The ``train_fleet_*`` instruments on one registry.

    ``run_resilient(fleet_metrics=...)`` calls :meth:`on_resolve` at its
    lag-resolved point (setting the active-ranks gauge again from a host
    int) and :meth:`on_rewind` at a divergence rewind; the fleet layer
    drives the preemption and recovery counters.  Nothing here reads a
    device value."""

    def __init__(self, registry: Any, active_ranks: int = 1):
        self._active = int(active_ranks)
        self.active = registry.gauge(
            "train_fleet_active_ranks",
            "ranks in the current generation's plan")
        self.preemptions = registry.counter(
            "train_fleet_preemptions_total",
            "rank-death shrink events observed")
        self.recoveries = registry.counter(
            "train_fleet_recoveries_total",
            "generations resumed from a durable snapshot")
        self.rewinds = registry.counter(
            "train_fleet_rewinds_total",
            "divergence rewinds inside fleet generations")
        self.recovery_seconds = registry.histogram(
            "train_fleet_recovery_seconds",
            "plan creation to first post-restore dispatch",
            buckets=RECOVERY_BUCKETS)
        self.active.set(self._active)

    def set_active(self, n: int) -> None:
        self._active = int(n)
        self.active.set(self._active)

    def on_resolve(self) -> None:
        self.active.set(self._active)

    def on_rewind(self) -> None:
        self.rewinds.inc()

    def on_preemption(self, n: int = 1) -> None:
        self.preemptions.inc(n)

    def on_recovery(self, seconds: float) -> None:
        self.recoveries.inc()
        self.recovery_seconds.observe(float(seconds))


# ---------------------------------------------------------------------------
# the membership gate
# ---------------------------------------------------------------------------

def membership_gate(ledger: FleetLedger, cfg: FleetConfig, plan: dict,
                    rank: int,
                    on_change: Optional[Callable[..., None]] = None
                    ) -> Callable[[int], None]:
    """A ``gate(abs_step)`` callable run before every dispatch.

    Raises :class:`FleetMembershipChange` when a member lease expired
    (shrink), a fresh non-member lease appeared (regrow), or a newer plan
    exists.  Checks are throttled to one ledger scan per ``cfg.poll_s``:
    detection latency is bounded by ``lease_ttl_s + poll_s``, the cost a
    few file reads."""
    members = [int(r) for r in plan["members"]]
    peers = [r for r in members if r != rank]
    gen = int(plan["gen"])
    last_check = [0.0]

    def gate(abs_step: int) -> None:
        now = time.monotonic()
        if now - last_check[0] < cfg.poll_s:
            return
        last_check[0] = now
        dead = [r for r in peers if not ledger.fresh(r, cfg.lease_ttl_s)]
        if dead:
            if on_change is not None:
                on_change("shrink", dead, abs_step)
            raise FleetMembershipChange("shrink", dead, abs_step)
        joiners = sorted(
            r for r in ledger.announced()
            if r not in members and ledger.fresh(r, cfg.lease_ttl_s))
        if joiners:
            if on_change is not None:
                on_change("regrow", joiners, abs_step)
            raise FleetMembershipChange("regrow", joiners, abs_step)
        latest = ledger.latest_plan()
        if latest is not None and int(latest["gen"]) > gen:
            if on_change is not None:
                on_change("plan", latest["members"], abs_step)
            raise FleetMembershipChange("plan", latest["members"], abs_step)

    return gate


# ---------------------------------------------------------------------------
# the leader's checkpoint manager behind a step offset
# ---------------------------------------------------------------------------

class _StepOffsetManager:
    """Translates ``run_resilient``'s generation-local step indices to
    the fleet's absolute steps on the wrapped
    :class:`~apex_tpu_torch.resilience.durable.DurableCheckpointManager`
    (and back on restore), so the snapshot directory speaks absolute
    steps across generations."""

    def __init__(self, inner: Any, start: int):
        self._inner = inner
        self._start = int(start)
        self.last_restore: Optional[dict] = None

    def save(self, step: int, state: Any, extras: Optional[dict] = None
             ) -> None:
        self._inner.save(self._start + int(step), state, extras)

    def all_steps(self) -> List[int]:
        return [s - self._start for s in self._inner.all_steps()
                if s >= self._start]

    def restore(self, template: Any, step: Optional[int] = None,
                extras: Optional[dict] = None) -> Tuple[Any, dict]:
        out = self._inner.restore(
            template, None if step is None else self._start + int(step),
            extras)
        lr = dict(self._inner.last_restore or {})
        lr["step"] = lr.get("step", self._start) - self._start
        self.last_restore = lr
        return out

    def wait(self) -> None:
        self._inner.wait()

    def close(self) -> None:
        self._inner.close()


# ---------------------------------------------------------------------------
# the per-generation workload (DDP + amp O2 across the process group)
# ---------------------------------------------------------------------------

def _mlp_loss(model, xb):
    """JAX's drill loss: ``mean((relu(x @ w1) @ w2 - x) ** 2)``."""
    import torch
    h = torch.relu(xb @ model.w1)
    return torch.mean(torch.square(h @ model.w2 - xb))


class _Workload:
    """The drill's DDP + amp O2 train step for one generation's world
    size: an MLP (``w1`` ``(d_in, hidden)``, ``w2`` ``(hidden, d_in)``,
    JAX's names) under :class:`~apex_tpu_torch.optimizers.FusedAdam`,
    its gradients reduced by :class:`~apex_tpu_torch.parallel.Reducer`
    over the process group, its loss averaged over the ranks.  The state
    (:attr:`amp`) is replicated on every rank, so a snapshot round-trips
    on any world size.  The JAX package's ``to_global`` / ``to_local``
    have no counterpart: the eager state is already this process's."""

    def __init__(self, cfg: FleetConfig, world: int, idx: int):
        import torch
        from torch import nn

        from apex_tpu_torch import amp
        from apex_tpu_torch.ops import resolve_device
        from apex_tpu_torch.optimizers import FusedAdam
        from apex_tpu_torch.parallel import Reducer

        self.cfg = cfg
        self.world = int(world)
        self.idx = int(idx)
        self.device = resolve_device(cfg.device)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        model = nn.Module()
        model.w1 = nn.Parameter(torch.randn(cfg.d_in, cfg.hidden,
                                            generator=gen))
        model.w2 = nn.Parameter(torch.randn(cfg.hidden, cfg.d_in,
                                            generator=gen))
        model.to(self.device)
        self.amp = amp.initialize(
            model, FusedAdam(model.parameters(), lr=1e-3,
                             device=self.device),
            opt_level="O2", min_loss_scale=cfg.min_loss_scale,
            device=self.device)
        self.reducer = Reducer()
        step = amp.make_train_step(self.amp, model, _mlp_loss,
                                   reduce_fn=self.reducer.reduce)

        def step_fn(xb):
            m = step(xb)
            return {"loss": self._mean_loss(m["loss"].detach().clone()),
                    "overflow": m["overflow"],
                    "pinned_at_floor": m["pinned_at_floor"]}

        self.step_fn = step_fn

    def _mean_loss(self, loss):
        """The ranks' mean of this rank's fp32 loss (summed in place)."""
        from apex_tpu_torch.parallel.distributed import (_all_reduce_,
                                                         process_group)
        return _all_reduce_(loss, process_group()) / self.world

    def _communicate(self) -> None:
        """What the step sends, on zeros of its shapes and dtypes: the
        gradients' reduction, then the loss's mean."""
        import torch
        self.reducer.reduce([torch.zeros_like(p) for p in self.amp.params])
        self._mean_loss(torch.zeros((), dtype=torch.float32,
                                    device=self.device))

    def capture(self):
        """A dry :func:`~apex_tpu_torch.analysis.capture.capture` of the
        step's communicating part: the subject of the generation's SPMD
        preflight (the JAX package lowers the whole step)."""
        from apex_tpu_torch.analysis.capture import capture
        return capture(self._communicate)

    def batch_array(self, abs_step: int):
        """This rank's rows of step ``abs_step``'s batch as numpy: the
        full ``(world, batch, d_in)`` pool comes from ``(seed, abs_step,
        world)`` alone (the JAX package's formula, bit for bit) and each
        rank keeps its own row, so a replay of one schedule on one world
        size sees the same data."""
        import numpy as np
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + abs_step) * 17 + self.world)
        pool = rng.standard_normal(
            (self.world, self.cfg.batch, self.cfg.d_in)).astype(np.float32)
        return pool[self.idx]

    def make_global_batch(self, abs_step: int):
        """:meth:`batch_array` as a tensor on the workload's device."""
        import torch
        return torch.from_numpy(self.batch_array(abs_step)).to(self.device)


def _parse_fleet_faults(specs: Sequence[str], start: int) -> list:
    """Fault specs -> fault instances with steps shifted into the
    generation's local index space (``run_resilient`` drives the
    injector with local steps); faults already behind ``start`` are
    dropped: they belong to an earlier generation's timeline."""
    from apex_tpu_torch.resilience.faults import (HangStep, RankKill,
                                                  parse_fault)
    out = []
    for spec in specs:
        f = parse_fault(spec)
        if not isinstance(f, (RankKill, HangStep)):
            raise ValueError(
                f"fault {spec!r} is not supported in the fleet lane "
                "(rank_kill / hang only: batch and IO faults are not "
                "consistent across a process group)")
        if f.step >= start:
            out.append(dataclasses.replace(f, step=f.step - start))
    return out


# ---------------------------------------------------------------------------
# generation child
# ---------------------------------------------------------------------------

def run_generation(ledger: FleetLedger, cfg: FleetConfig, gen: int,
                   rank: int) -> int:
    """Run one generation on one rank: form the group, restore the
    plan's step, train until the end or a membership change.  Returns
    the child's exit code (0 done, :data:`EXIT_MEMBERSHIP` on shrink,
    regrow or a new plan)."""
    from apex_tpu_torch.obs.flight import FlightRecorder
    from apex_tpu_torch.obs.metrics import Registry
    from apex_tpu_torch.ops.cuda import launch_counts
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.resilience import incidents as incidents_lib
    from apex_tpu_torch.resilience.durable import DurableCheckpointManager
    from apex_tpu_torch.resilience.faults import FaultInjector, RankKill
    from apex_tpu_torch.resilience.loop import ResilienceConfig, run_resilient

    plan = ledger.read_plan(gen)
    if plan is None:
        raise FleetError(f"no plan for generation {gen} in {ledger.root}")
    members = [int(r) for r in plan["members"]]
    if rank not in members:
        raise FleetError(f"rank {rank} is not in generation {gen}'s plan "
                         f"{members}")
    idx = members.index(rank)
    world = len(members)
    restore_step = plan.get("restore_step")
    start = 0 if restore_step is None else int(restore_step) + 1
    step_cell = {"step": start, "phase": "init"}

    progress = HeartbeatLease(
        ledger, rank, cfg.heartbeat_s, kind="progress",
        info_fn=lambda: dict(step_cell, gen=gen)).start()
    ledger.event(rank, "gen_start", gen=gen, members=members,
                 restore_step=restore_step, world=world)

    fr = FlightRecorder()
    reg = Registry()
    fm = FleetMetrics(reg, active_ranks=world)

    def _incident(status: str, summary: str, evidence: list,
                  **extra: Any) -> None:
        path = ledger.path("incidents",
                           f"gen{gen}_rank{rank}_{status}.json")
        extra.setdefault("metrics", reg.snapshot())
        extra.setdefault("flight", fr.dump())
        incidents_lib.write_incident(path, status, summary, evidence,
                                     gen=gen, rank=rank, **extra)

    def _on_change(reason: str, ranks: Sequence[int],
                   abs_step: int) -> None:
        if reason == "shrink":
            fr.note("kill", ranks=list(ranks), step=abs_step)
        fr.note(f"{reason}_detected", ranks=list(ranks), step=abs_step)

    def _classified_end(e: BaseException) -> Optional[int]:
        """Route a failure through the lease check: a stale peer lease
        means the failure IS a membership change (EXIT_MEMBERSHIP through
        the common epilogue); ``None`` means a program error the caller
        raises again."""
        change = _classify_failure(ledger, cfg, plan, rank, e,
                                   step_cell["step"])
        if change is None:
            ledger.event(rank, "child_error", gen=gen,
                         phase=step_cell["phase"],
                         error=f"{type(e).__name__}: {e}"[:500])
            return None
        _on_change(change.reason, change.ranks, change.step)
        return _end_generation(ledger, cfg, fm, fr, _incident, gen,
                               rank, world, members, change,
                               cause=repr(e)[:300])

    manager = None
    try:
        try:
            step_cell["phase"] = "cluster_init"
            multiproc.initialize(
                coordinator_address=f"localhost:{plan['port']}",
                num_processes=world, process_id=idx,
                timeout_s=cfg.init_timeout_s, retries=cfg.init_retries,
                backend=cfg.backend, device=cfg.device)
            wl = _Workload(cfg, world, idx)

            step_cell["phase"] = "preflight"
            pre = multiproc.spmd_preflight(wl.capture(),
                                           label=f"fleet_gen{gen}")
            ledger.event(rank, "preflight", gen=gen, ok=bool(pre["ok"]),
                         n_collectives=pre["n_collectives"],
                         schedule_hash=pre["schedule_hash"],
                         exchange=pre["exchange"])
            fr.note("preflight", gen=gen,
                    n_collectives=pre["n_collectives"])
            # the port has no AOT cache: the step runs eagerly
            step_cell["phase"] = "aot"
            ledger.event(rank, "aot", gen=gen, source="eager", world=world)
            fr.note("aot", gen=gen, source="eager")

            step_cell["phase"] = "restore"
            if restore_step is not None:
                load_snapshot_state(ledger.ckpt_dir, int(restore_step),
                                    wl.amp)
                digest = snapshot_digest(ledger.ckpt_dir,
                                         int(restore_step))
                ledger.event(rank, "restore", gen=gen,
                             step=int(restore_step), digest=digest)
                fr.note("restore", gen=gen, step=int(restore_step))
                if gen > 0:
                    fm.on_recovery(max(
                        0.0, time.time()
                        - float(plan.get("created_ts", 0.0))))
                    _incident(
                        "fleet-restored",
                        f"generation {gen} (world {world}) resumed from "
                        f"durable step {restore_step}",
                        [f"restored step {restore_step} digest "
                         f"{digest[:16]}…",
                         f"members {members}",
                         "aot source eager"],
                        restore_step=int(restore_step))
        except Exception as e:  # noqa: BLE001 - classify via the lease
            # a peer dying during FORMATION (init timeout, restore) must
            # end in a replan like a death mid-step: raising would exit
            # every survivor fatally, stop their leases, and cascade to
            # the whole fleet's death
            code = _classified_end(e)
            if code is None:
                raise
            return code

        remaining = cfg.num_steps - start
        if remaining <= 0:
            ledger.final(rank, gen=gen, step=cfg.num_steps - 1,
                         digest=state_digest(wl.amp))
            return 0

        if idx == 0:    # the leader only: construction sweeps .tmp-* dirs
            manager = _StepOffsetManager(
                DurableCheckpointManager(ledger.ckpt_dir,
                                         max_to_keep=10_000), start)

        gate = membership_gate(ledger, cfg, plan, rank,
                               on_change=_on_change)

        def batch_fn(i: int) -> tuple:
            abs_step = start + i
            step_cell["step"] = abs_step
            step_cell["phase"] = "train"
            if cfg.step_delay_s > 0:
                time.sleep(cfg.step_delay_s)
            gate(abs_step)
            return (wl.make_global_batch(abs_step),)

        inj = FaultInjector(_parse_fleet_faults(cfg.faults, start),
                            seed=cfg.seed, rank=rank)

        def _on_rank_kill(fault: RankKill, local_step: int) -> None:
            # the record must reach the disk BEFORE the kill: a killed
            # rank gets no other chance to say why it died
            ledger.event(rank, "kill", gen=gen, step=start + local_step,
                         signal=int(fault.signal),
                         kill_parent=bool(fault.kill_parent))
            inj.execute_rank_kill(fault)

        inj.on_rank_kill = _on_rank_kill

        rcfg = ResilienceConfig(
            watchdog_timeout_s=cfg.watchdog_timeout_s,
            checkpoint_every=cfg.checkpoint_every,
            incident_path=ledger.path(
                "incidents", f"gen{gen}_rank{rank}_loop.json"))

        try:
            result = run_resilient(
                wl.step_fn, wl.amp, batch_fn, remaining, manager=manager,
                config=rcfg, injector=inj, registry=reg, flight=fr,
                fleet_metrics=fm)
        except FleetMembershipChange as e:
            return _end_generation(ledger, cfg, fm, fr, _incident, gen,
                                   rank, world, members, e)
        except Exception as e:  # noqa: BLE001 - classify via the lease
            code = _classified_end(e)
            if code is None:
                raise
            return code

        final_digest = state_digest(wl.amp)
        loss = result.losses[-1][1] if result.losses else float("nan")
        launches = {k: v for k, v in launch_counts().items() if v}
        ledger.event(rank, "gen_complete", gen=gen,
                     step=cfg.num_steps - 1, digest=final_digest,
                     rewinds=result.rewinds, loss=loss, launches=launches)
        ledger.final(rank, gen=gen, step=cfg.num_steps - 1,
                     digest=final_digest, loss=loss,
                     scale=float(wl.amp.scaler_states[0].loss_scale),
                     launches=launches)
        print(f"FLEET RANK {rank} GEN {gen} FINAL "
              f"step={cfg.num_steps - 1} digest={final_digest}",
              flush=True)
        return 0
    finally:
        if manager is not None:
            try:
                manager.close()
            except Exception:   # noqa: BLE001 - exit code already decided
                pass
        progress.stop()


def _classify_failure(ledger: FleetLedger, cfg: FleetConfig, plan: dict,
                      rank: int, exc: Optional[BaseException],
                      abs_step: int) -> Optional[FleetMembershipChange]:
    """A failure mid-generation is a *shrink* iff a peer's lease is (or
    within one TTL becomes) stale: gloo's peer-closed error races the
    lease file, so wait one TTL out before calling it a program error.
    The evidence is the lease, never the exception's text (``exc`` may
    be ``None``: the supervisor applies the same test to a child that
    died too hard to raise)."""
    peers = [int(r) for r in plan["members"] if int(r) != rank]
    deadline = time.monotonic() + cfg.lease_ttl_s + 3 * cfg.heartbeat_s
    while time.monotonic() < deadline:
        dead = [r for r in peers if not ledger.fresh(r, cfg.lease_ttl_s)]
        if dead:
            return FleetMembershipChange("shrink", dead, abs_step)
        time.sleep(cfg.poll_s)
    return None


def _end_generation(ledger: FleetLedger, cfg: FleetConfig,
                    fm: FleetMetrics, fr: Any, incident: Callable,
                    gen: int, rank: int, world: int,
                    members: Sequence[int], change: FleetMembershipChange,
                    cause: Optional[str] = None) -> int:
    """The membership-change epilogue: counters, ledger event, incident
    with the flight tail, exit code."""
    from apex_tpu_torch.ops.cuda import launch_counts
    if change.reason == "shrink":
        fm.on_preemption(len(change.ranks))
    candidate = latest_verified_step(ledger.ckpt_dir)
    ledger.event(rank, f"{change.reason}_detected", gen=gen,
                 step=change.step, ranks=change.ranks,
                 restore_candidate=candidate,
                 launches={k: v for k, v in launch_counts().items() if v})
    status = {"shrink": "fleet-shrink", "regrow": "fleet-regrow"}.get(
        change.reason, "fleet-replan")
    evidence = [
        f"membership change at step {change.step}: {change.reason} "
        f"(ranks {change.ranks})",
        f"generation {gen} members {list(members)} (world {world})",
        f"latest verified durable step: {candidate}",
    ]
    if cause is not None:
        evidence.append(f"surfaced by: {cause}")
    incident(status,
             f"generation {gen} ended at step {change.step}: "
             f"{change.reason} of ranks {change.ranks}",
             evidence, step=change.step, ranks=change.ranks,
             restore_candidate=candidate)
    return EXIT_MEMBERSHIP


def _record_reclassified_death(ledger: FleetLedger, gen: int, rank: int,
                               code: int,
                               change: FleetMembershipChange) -> None:
    """The child died too hard to record its own membership change (a
    signal, a crash in formation), so the supervisor writes the events
    and incident the child's :func:`_end_generation` would have: one
    vocabulary, whichever side detected the change."""
    from apex_tpu_torch.obs.flight import FlightRecorder
    from apex_tpu_torch.resilience import incidents as incidents_lib
    ledger.event(rank, "child_death_reclassified", gen=gen, code=code,
                 reason=change.reason, ranks=change.ranks,
                 step=change.step)
    candidate = latest_verified_step(ledger.ckpt_dir)
    ledger.event(rank, f"{change.reason}_detected", gen=gen,
                 step=change.step, ranks=change.ranks,
                 restore_candidate=candidate, via="supervisor")
    fr = FlightRecorder()
    if change.reason == "shrink":
        fr.note("kill", ranks=list(change.ranks), step=change.step)
    fr.note(f"{change.reason}_detected", ranks=list(change.ranks),
            step=change.step)
    status = {"shrink": "fleet-shrink", "regrow": "fleet-regrow"}.get(
        change.reason, "fleet-replan")
    incidents_lib.write_incident(
        ledger.path("incidents",
                    f"gen{gen}_rank{rank}_{status}_supervisor.json"),
        status,
        f"generation {gen} ended at step {change.step}: {change.reason} "
        f"of ranks {change.ranks} (child died hard, exit {code})",
        [f"child exit code {code}: classified via peer leases; the "
         f"child never raised, its own recorder died with it",
         f"membership change at step {change.step}: {change.reason} "
         f"(ranks {change.ranks})",
         f"latest verified durable step: {candidate}"],
        gen=gen, rank=rank, step=change.step, ranks=change.ranks,
        restore_candidate=candidate, flight=fr.dump())


# ---------------------------------------------------------------------------
# the rank's supervisor
# ---------------------------------------------------------------------------

def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _child_env() -> dict:
    """The child's environment: the checkout on ``PYTHONPATH``; an
    inherited launcher's group (``COORDINATOR_ADDRESS``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``) dropped, since the child forms its group
    from the plan; nothing that hides a card; cuBLAS's workspace pinned
    (``CUBLAS_WORKSPACE_CONFIG``), so that a replay in a fresh process
    repeats the drill's GEMMs bit for bit."""
    env = dict(os.environ)
    for var in ("XLA_FLAGS", "COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return env


def _spawn_child(ledger: FleetLedger, gen: int, rank: int
                 ) -> Tuple[subprocess.Popen, list]:
    out = open(ledger.path("logs", f"child_g{gen}_r{rank}.out"), "w")
    err = open(ledger.path("logs", f"child_g{gen}_r{rank}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.resilience.fleet",
         "--role", "child", "--ledger", ledger.root,
         "--gen", str(gen), "--rank", str(rank)],
        stdout=out, stderr=err, env=_child_env())
    return proc, [out, err]


def _monitor_child(ledger: FleetLedger, cfg: FleetConfig, gen: int,
                   rank: int, proc: subprocess.Popen) -> int:
    """Wait for the generation child, with a progress watchdog: a child
    whose progress record stops advancing for ``stall_budget_s`` (wedged
    in a collective whose peer died without the lease noticing) is
    terminated, then killed, and treated as a membership change, so the
    fleet replans around the stall instead of hanging."""
    last_seen = time.monotonic()
    last_payload: Optional[tuple] = None
    while True:
        code = proc.poll()
        if code is not None:
            return code
        pr = ledger.read_progress(rank)
        payload = None if pr is None else (pr.get("gen"), pr.get("step"),
                                           pr.get("phase"), pr.get("ts"))
        if payload != last_payload:
            last_payload = payload
            last_seen = time.monotonic()
        if time.monotonic() - last_seen > cfg.stall_budget_s:
            ledger.event(rank, "child_stalled", gen=gen,
                         budget_s=cfg.stall_budget_s, progress=pr)
            proc.terminate()
            try:
                proc.wait(timeout=cfg.child_grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            return EXIT_MEMBERSHIP
        time.sleep(min(cfg.poll_s, 0.1))


def supervise(root: str, rank: int,
              cfg: Optional[FleetConfig] = None) -> int:
    """The per-rank supervisor: announce membership, keep the rank's
    lease alive, run one generation child per plan that includes this
    rank (a fresh process each generation: a process group cannot be
    formed again in-process after a peer died), elect the leader to
    write replacement plans, and interpret the child's exit code (0
    done, EXIT_MEMBERSHIP replan, anything else fatal, which stops the
    lease so peers shrink around this rank)."""
    ledger = FleetLedger(root)
    if cfg is None:
        cfg = ledger.read_config()
    inc = ledger.announce(rank)
    ledger.event(rank, "announce", incarnation=inc)
    lease = HeartbeatLease(ledger, rank, cfg.heartbeat_s,
                           info_fn=lambda: {"incarnation": inc}).start()
    try:
        form_deadline = time.monotonic() + cfg.form_window_s
        join_gen: Optional[int] = None     # generation we wait on as a
        join_t0 = 0.0                      # non-member, and since when
        while True:
            plan = ledger.latest_plan()
            if plan is None:
                if not _try_lead_initial_plan(ledger, cfg, rank,
                                              form_deadline):
                    if time.monotonic() > form_deadline + cfg.form_window_s:
                        raise FleetError(
                            f"rank {rank}: no generation 0 plan within "
                            f"{cfg.form_window_s}s")
                    time.sleep(cfg.poll_s)
                continue
            gen = int(plan["gen"])
            if gen >= cfg.max_generations:
                raise FleetError(
                    f"generation budget exhausted ({gen} >= "
                    f"{cfg.max_generations})")
            mine = (rank in [int(r) for r in plan["members"]]
                    and int(plan.get("incarnations", {}).get(
                        str(rank), inc)) == inc)
            if not mine:
                # a joiner: our fresh lease IS the regrow signal; the
                # running generation's gate sees it and replans us in
                finals = ledger.finals()
                if all(int(r) in finals for r in plan["members"]):
                    ledger.event(rank, "join_after_done", gen=gen)
                    return 0
                if join_gen != gen:
                    join_gen, join_t0 = gen, time.monotonic()
                if _take_over_dead_generation(ledger, cfg, rank, plan):
                    continue
                # bounded: live members replan around a fresh joiner
                # within lease_ttl + poll + replan_window; a joiner still
                # planless past that is stuck, not patient
                join_budget = cfg.form_window_s + cfg.replan_window_s
                if time.monotonic() - join_t0 > join_budget:
                    raise FleetError(
                        f"rank {rank}: generation {gen} never replanned "
                        f"around this joiner within {join_budget:g}s")
                time.sleep(cfg.poll_s)
                continue
            ledger.event(rank, "spawn_child", gen=gen)
            proc, logs = _spawn_child(ledger, gen, rank)
            try:
                code = _monitor_child(ledger, cfg, gen, rank, proc)
            finally:
                for f in logs:
                    f.close()
            ledger.event(rank, "child_exit", gen=gen, code=code)
            if code == 0:
                ledger.event(rank, "rank_done", gen=gen)
                return 0
            if code != EXIT_MEMBERSHIP:
                # the child died HARD (a signal, a crash in formation),
                # so its own classifier never ran: apply the same lease
                # test here.  A stale peer makes this death a membership
                # casualty and the rank REPLANS; only a death with every
                # peer alive is fatal (stopping our lease in the finally,
                # so the fleet shrinks around this rank instead of every
                # survivor cascading to rank_fatal)
                pr = ledger.read_progress(rank) or {}
                step = pr.get("step")
                change = _classify_failure(
                    ledger, cfg, plan, rank, None,
                    step if isinstance(step, int) else -1)
                if change is None:
                    ledger.event(rank, "rank_fatal", gen=gen, code=code)
                    return code if code > 0 else 1
                _record_reclassified_death(ledger, gen, rank, code,
                                           change)
            _await_next_plan(ledger, cfg, rank, gen)
    finally:
        lease.stop()


def _try_lead_initial_plan(ledger: FleetLedger, cfg: FleetConfig,
                           rank: int, form_deadline: float) -> bool:
    """Write the generation-0 plan if this rank should lead it: the
    leader is the smallest announced live rank, and it waits for the
    whole expected world until the formation window closes (then starts
    with whoever arrived: a fleet that can start degraded is the
    point)."""
    live = ledger.live_ranks(cfg.lease_ttl_s)
    if not live or min(live) != rank:
        return False
    if len(live) < cfg.world_size and time.monotonic() < form_deadline:
        return False
    restore = latest_verified_step(ledger.ckpt_dir)
    return _commit_plan(ledger, cfg, rank, gen=0, members=live,
                        restore_step=restore, reason="initial")


def _free_port() -> int:
    """A free TCP port on this host (``multiproc._free_port``; kept here
    so that a supervisor never imports torch)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _commit_plan(ledger: FleetLedger, cfg: FleetConfig, rank: int,
                 gen: int, members: List[int], restore_step: Optional[int],
                 reason: str) -> bool:
    from apex_tpu_torch.resilience.incidents import utc_now
    announced = ledger.announced()
    plan = {
        "gen": int(gen), "members": [int(r) for r in members],
        "port": _free_port(), "restore_step": restore_step,
        "reason": reason, "created_by": int(rank),
        "created_ts": time.time(), "utc": utc_now(),
        "incarnations": {str(r): int(announced.get(r, {})
                                     .get("incarnation", 0))
                         for r in members},
    }
    won = ledger.write_plan(plan)
    if won:
        ledger.event(rank, "plan", gen=gen, members=plan["members"],
                     restore_step=restore_step, reason=reason,
                     port=plan["port"])
    return won


def _replan_reason(old: set, new: set) -> str:
    return ("regrow" if new > old else
            "shrink" if new < old else "reform")


def _await_next_plan(ledger: FleetLedger, cfg: FleetConfig, rank: int,
                     gen: int) -> dict:
    """After EXIT_MEMBERSHIP: elect the next plan.  The leader is the
    smallest live rank AMONG THE ENDED GENERATION'S MEMBERS: only they
    reach this loop; a rank that just returned sits in ``supervise``'s
    joiner branch and never writes plans, so electing the smallest live
    rank outright would deadlock the regrow when the returning rank is
    the smallest (kill rank 0, not rank 1).  Membership is the live
    leases, the restore step the newest verifying snapshot.  If the
    elected member stalls, after half the window every waiting member
    tries the commit itself (the O_EXCL create arbitrates: one wins,
    the others adopt it).  Bounded by ``replan_window_s``."""
    nxt = gen + 1
    prev = ledger.read_plan(gen) or {"members": []}
    prev_members = set(int(r) for r in prev["members"])
    start = time.monotonic()
    deadline = start + cfg.replan_window_s
    grace = start + cfg.replan_window_s / 2.0
    while time.monotonic() < deadline:
        plan = ledger.read_plan(nxt)
        if plan is not None:
            return plan
        live = ledger.live_ranks(cfg.lease_ttl_s)
        leaders = [r for r in live if r in prev_members]
        if live and ((leaders and min(leaders) == rank)
                     or time.monotonic() >= grace):
            restore = latest_verified_step(ledger.ckpt_dir)
            _commit_plan(ledger, cfg, rank, gen=nxt, members=live,
                         restore_step=restore,
                         reason=_replan_reason(prev_members, set(live)))
            continue
        time.sleep(cfg.poll_s)
    raise FleetError(
        f"rank {rank}: no generation {nxt} plan within "
        f"{cfg.replan_window_s}s of the membership change")


def _take_over_dead_generation(ledger: FleetLedger, cfg: FleetConfig,
                               rank: int, plan: dict) -> bool:
    """A joiner waiting on a generation NONE of whose members is alive
    (every lease stale: the whole earlier fleet died) must not wait for
    a replan nobody is left to write: the smallest live rank commits the
    next plan itself.  Racing a reviving member is safe: the O_EXCL
    create arbitrates, and a loser adopts the winner at its next poll."""
    members = [int(r) for r in plan["members"]]
    if any(ledger.fresh(r, cfg.lease_ttl_s) for r in members):
        return False
    live = ledger.live_ranks(cfg.lease_ttl_s)
    if not live or min(live) != rank:
        return False
    nxt = int(plan["gen"]) + 1
    ledger.event(rank, "takeover", gen=nxt, dead_members=members,
                 members=live)
    _commit_plan(ledger, cfg, rank, gen=nxt, members=live,
                 restore_step=latest_verified_step(ledger.ckpt_dir),
                 reason=_replan_reason(set(members), set(live)))
    return True


# ---------------------------------------------------------------------------
# process entry (``python -m apex_tpu_torch.resilience.fleet``)
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="elastic training fleet process entry")
    p.add_argument("--role", choices=("supervisor", "child"),
                   required=True)
    p.add_argument("--ledger", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--gen", type=int, default=None,
                   help="generation to run (child role)")
    args = p.parse_args(argv)

    ledger = FleetLedger(args.ledger)
    if args.role == "supervisor":
        return supervise(args.ledger, args.rank)
    if args.gen is None:
        print("--gen is required for --role child", file=sys.stderr)
        return 2
    import torch
    # bitwise replays: no TF32 rounding of fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ledger.read_config()
    code = run_generation(ledger, cfg, args.gen, args.rank)
    # skip interpreter teardown: the process group's shutdown can wait on
    # the very peer whose death ended this generation, and everything
    # durable (events, incident, progress, final) is already renamed
    # into place
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    sys.exit(main())
