"""Comparison helpers shared by the port's tests and ``chip_smoke.py``;
:func:`start_ranks` / :func:`run_ranks`, the tests' multi-process
launcher with a deadline; and :func:`run_fleet_drill`, the elastic
training fleet's chaos drill with its bitwise replays."""

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


def _fleet_env(extra=None) -> dict:
    import os
    import pathlib
    env = dict(os.environ)
    # the drill forms its own groups: an inherited launcher's must not
    # leak into the supervisors or their children
    for var in ("XLA_FLAGS", "COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    root = str(pathlib.Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _launch_supervisor(root: str, rank: int, env: dict):
    import os
    import subprocess
    import sys
    log = open(os.path.join(root, "logs", f"supervisor_r{rank}.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.resilience.fleet",
             "--role", "supervisor", "--ledger", root, "--rank", str(rank)],
            stdout=log, stderr=subprocess.STDOUT, env=env)
    finally:
        log.close()     # the child holds its own descriptor


def _log_tail(root: str, rank: int, limit: int = 1500) -> str:
    import os
    try:
        with open(os.path.join(root, "logs", f"supervisor_r{rank}.log"),
                  errors="replace") as f:
            return f.read()[-limit:]
    except OSError:
        return "<no log>"


def _wait_for(pred, timeout_s: float, what: str, poll_s: float = 0.1):
    import time
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        val = pred()
        if val:
            return val
        time.sleep(poll_s)
    raise AssertionError(f"fleet drill: timed out after {timeout_s:g} s "
                         f"waiting for {what}")


def _drain_supervisors(procs: dict, timeout_s: float, what: str) -> dict:
    import time
    deadline = time.monotonic() + timeout_s
    codes = {}
    while len(codes) < len(procs):
        for r, p in procs.items():
            if r not in codes and p.poll() is not None:
                codes[r] = p.returncode
        if time.monotonic() > deadline:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            raise AssertionError(f"fleet drill: timed out after "
                                 f"{timeout_s:g} s waiting for {what} "
                                 f"(codes so far: {codes})")
        time.sleep(0.1)
    return codes


def _plans(ledger) -> list:
    plans, g = [], 0
    while True:
        plan = ledger.read_plan(g)
        if plan is None:
            return plans
        plans.append(plan)
        g += 1


def _fleet_replay(tag: str, base: str, cfg, drill_ckpt: str,
                  seed_step: int, world: int, num_steps: int,
                  timeout_s: float, env: dict) -> dict:
    """An UNINTERRUPTED fleet of ``world`` ranks from the drill's own
    snapshot at ``seed_step`` to ``num_steps`` in a fresh ledger (the
    same supervisor -> child -> ``run_resilient`` path, no faults, no
    pacing); returns its finals."""
    import dataclasses
    import os
    import shutil
    from apex_tpu_torch.resilience.durable import _step_dirname
    from apex_tpu_torch.resilience.fleet import FleetLedger
    root = os.path.join(base, f"replay_{tag}")
    ledger = FleetLedger(root)
    src = os.path.join(drill_ckpt, _step_dirname(seed_step))
    if not os.path.isdir(src):
        raise AssertionError(f"replay {tag}: the drill has no snapshot at "
                             f"step {seed_step}")
    shutil.copytree(src, os.path.join(ledger.ckpt_dir,
                                      _step_dirname(seed_step)))
    # the pacing is a host sleep: dropping it cannot change the math
    ledger.write_config(dataclasses.replace(
        cfg, world_size=world, num_steps=num_steps, faults=(),
        step_delay_s=0.0))
    procs = {r: _launch_supervisor(root, r, env) for r in range(world)}
    codes = _drain_supervisors(procs, timeout_s, f"replay {tag}")
    if any(c != 0 for c in codes.values()):
        raise AssertionError(
            f"replay {tag}: supervisor exit codes {codes}; log tails: "
            f"{ {r: _log_tail(root, r) for r in codes} }")
    finals = ledger.finals()
    if sorted(finals) != list(range(world)):
        raise AssertionError(f"replay {tag}: finals of ranks "
                             f"{sorted(finals)}")
    return {"world": world, "restore_step": seed_step,
            "final_step": num_steps - 1,
            "finals": {str(r): {"step": f["step"], "digest": f["digest"]}
                       for r, f in finals.items()}}


def run_fleet_drill(base: str, cfg, timeout_s: float = 300.0,
                    env=None) -> dict:
    """The elastic fleet's chaos drill, as the JAX package's
    ``tools/train_fleet.py`` runs it, in ``base`` (a directory):

    1. two supervisors (``python -m apex_tpu_torch.resilience.fleet
       --role supervisor``) start generation children training under
       ``run_resilient``;
    2. the fault of ``cfg.faults`` (``rank_kill@S:R``) kills rank R, its
       child and its supervisor, at step S;
    3. the survivor sees the stale lease, ends its generation, replans
       onto one rank, restores the last durable step and goes on;
    4. once that generation has committed a snapshot of its own, rank R's
       supervisor is started again; its fresh lease makes the fleet
       regrow to two ranks, which run to the end;
    5. the post-kill schedule (one rank, shrink restore -> regrow
       restore) and the post-regrow one (two ranks, regrow restore ->
       end) are replayed from the drill's own snapshots in fresh
       ledgers.

    Returns the verdicts (``bitwise``: the shrink replay's digest equals
    the drill's snapshot at the regrow restore, the regrow replay's
    finals equal the drill's rank by rank, the drill's two finals are
    equal), the generations, the kill, restore and lost steps, the
    detection latency (the kill event to the survivor's
    ``shrink_detected``, by the ledger's clock), each restored
    generation's ``train_fleet_recovery_seconds`` (from its incident's
    metrics), the children's kernel launches, and the wall seconds.
    ``env``: variables added to the processes' environment."""
    import json
    import os
    import time
    from apex_tpu_torch.resilience.durable import _STEP_PREFIX
    from apex_tpu_torch.resilience.fleet import (FleetLedger,
                                                 latest_verified_step,
                                                 snapshot_digest)
    from apex_tpu_torch.resilience.faults import parse_fault
    kills = [parse_fault(f) for f in cfg.faults]
    if len(kills) != 1 or type(kills[0]).__name__ != "RankKill" \
            or kills[0].rank is None:
        raise ValueError(f"the drill takes one rank_kill@S:R fault, got "
                         f"{cfg.faults}")
    kill_rank = int(kills[0].rank)
    env = _fleet_env(env)
    root = os.path.join(base, "drill")
    ledger = FleetLedger(root)
    ledger.write_config(cfg)
    t0 = time.time()
    procs = {r: _launch_supervisor(root, r, env)
             for r in range(cfg.world_size)}
    try:
        _wait_for(lambda: [e for e in ledger.events()
                           if e["kind"] == "kill"],
                  timeout_s, "the scheduled rank kill")
        _wait_for(lambda: procs[kill_rank].poll() is not None, 30.0,
                  "the killed supervisor to die")
        if procs[kill_rank].returncode != -9:
            raise AssertionError(f"the killed rank's supervisor exited "
                                 f"{procs[kill_rank].returncode}, not by "
                                 "SIGKILL")

        def shrunk():
            if ledger.finals():
                raise AssertionError(
                    "the shrunken generation finished before the killed "
                    "rank could be started again: raise step_delay_s")
            plan = ledger.latest_plan()
            if plan is None or int(plan["gen"]) < 1:
                return None
            restore = plan.get("restore_step")
            latest = latest_verified_step(ledger.ckpt_dir)
            if latest is None or restore is None:
                return None
            return plan if latest > int(restore) else None

        _wait_for(shrunk, timeout_s,
                  "the shrunken generation to commit a snapshot")
        procs[kill_rank] = _launch_supervisor(root, kill_rank, env)
        codes = _drain_supervisors(procs, timeout_s,
                                   "the regrown fleet to finish")
        if any(c != 0 for c in codes.values()):
            raise AssertionError(
                f"supervisor exit codes {codes}; log tails: "
                f"{ {r: _log_tail(root, r) for r in codes} }")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.time() - t0
    events = ledger.events()
    finals = ledger.finals()
    plans = _plans(ledger)
    if len(plans) < 3:
        raise AssertionError(f"expected >= 3 generations (initial, "
                             f"shrink, regrow), got {len(plans)}")
    if sorted(finals) != list(range(cfg.world_size)):
        raise AssertionError(f"finals of ranks {sorted(finals)}")
    kill = next(e for e in events if e["kind"] == "kill")
    detected = [e for e in events if e["kind"] == "shrink_detected"
                and e["ts"] >= kill["ts"]]
    snapshots = {}
    for name in sorted(os.listdir(ledger.ckpt_dir)):
        if name.startswith(_STEP_PREFIX):
            step = int(name[len(_STEP_PREFIX):])
            snapshots[str(step)] = snapshot_digest(ledger.ckpt_dir, step)
    recovery = {}
    for name in sorted(os.listdir(ledger.path("incidents"))):
        if name.endswith("_fleet-restored.json"):
            with open(ledger.path("incidents", name)) as f:
                rows = json.load(f)["metrics"]["metrics"]
            row = next(m for m in rows
                       if m["name"] == "train_fleet_recovery_seconds")
            recovery[name[:-len("_fleet-restored.json")]] = row["sum"]
    plan1, plan2 = plans[1], plans[2]
    s1, s2 = int(plan1["restore_step"]), int(plan2["restore_step"])
    shrink = _fleet_replay("shrink", base, cfg, ledger.ckpt_dir, s1,
                           len(plan1["members"]), s2 + 1, timeout_s, env)
    regrow = _fleet_replay("regrow", base, cfg, ledger.ckpt_dir, s2,
                           len(plan2["members"]), cfg.num_steps, timeout_s,
                           env)
    digests = {str(r): f["digest"] for r, f in finals.items()}
    launches: dict = {}
    for e in events:
        for k, v in (e.get("launches") or {}).items():
            launches[k] = launches.get(k, 0) + v
    return {
        "bitwise": {
            "shrink_matches_uninterrupted":
                shrink["finals"]["0"]["digest"] == snapshots.get(str(s2)),
            "regrow_matches_uninterrupted": all(
                regrow["finals"][r]["digest"] == d
                for r, d in digests.items()),
            "final_cross_rank_identical": len(set(digests.values())) == 1,
        },
        "generations": [{"gen": int(p["gen"]),
                         "members": [int(r) for r in p["members"]],
                         "restore_step": p.get("restore_step"),
                         "reason": p["reason"]} for p in plans],
        "kill_step": int(kill["step"]), "shrink_restore": s1,
        "regrow_restore": s2, "steps_lost": int(kill["step"]) - s1,
        "detection_latency_s": (detected[0]["ts"] - kill["ts"]
                                if detected else None),
        "recovery_seconds": recovery, "snapshots": snapshots,
        "finals": {str(r): {"step": f["step"], "digest": f["digest"],
                            "loss": f.get("loss")}
                   for r, f in finals.items()},
        "replays": {"shrink": shrink, "regrow": regrow},
        "launches": launches, "wall_s": wall_s, "root": root,
    }
