"""The port's elastic training fleet (``apex_tpu_torch/resilience/
fleet.py``) against the JAX package's (``apex_tpu/resilience/fleet.py``):
the ledger's atomic and exclusive files, the heartbeat lease, the
membership gate, the step-offset manager, fault shifting, the replan
election and takeover (the counterparts of
``tests/distributed/test_train_fleet.py``); a ledger written by one
package read by the other; the digest contract, on a state carried
across; the drill's MLP workload against JAX's ``make_train_step``; the
``train_fleet_*`` family at ``run_resilient``'s resolve point; and the
two-rank CPU drill (gloo), whose three bitwise verdicts must hold.

Tolerances: the workload's losses within 1e-6 and masters within 1e-5
of JAX's over 4 steps from a JAX-written snapshot (JAX run with
``--xla_allow_excess_precision=false`` in a process of its own, so that
XLA rounds each bf16 op as the port does; measured: losses equal,
masters within 1.5e-8).
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.resilience import DurableCheckpointManager as JaxManager
from apex_tpu.resilience import fleet as jfleet
from apex_tpu_torch import amp
from apex_tpu_torch.obs.metrics import Registry
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import (DurableCheckpointManager, FleetConfig,
                                       FleetLedger, FleetMembershipChange,
                                       FleetMetrics, HeartbeatLease, RankKill,
                                       ResilienceConfig, latest_verified_step,
                                       membership_gate, run_resilient,
                                       snapshot_digest, state_digest)
from apex_tpu_torch.resilience import fleet as fleet_mod
from apex_tpu_torch.testing import run_fleet_drill

REPO = pathlib.Path(__file__).resolve().parents[1]


# -- the ledger --------------------------------------------------------------

def test_plan_write_is_exclusive_first_writer_wins(tmp_path):
    led = FleetLedger(str(tmp_path))
    won = led.write_plan({"gen": 1, "members": [0], "restore_step": 7})
    lost = led.write_plan({"gen": 1, "members": [0, 1], "restore_step": 3})
    assert won is True and lost is False
    assert led.read_plan(1)["members"] == [0]
    assert led.latest_plan()["gen"] == 1


def test_announce_increments_incarnation(tmp_path):
    led = FleetLedger(str(tmp_path))
    assert led.announce(0) == 0
    assert led.announce(1) == 0
    assert led.announce(1) == 1          # rank 1 came back
    assert led.incarnation(0) == 0 and led.incarnation(1) == 1
    assert sorted(led.announced()) == [0, 1]


def test_heartbeat_lease_fresh_then_stale(tmp_path):
    led = FleetLedger(str(tmp_path))
    led.announce(0)
    with HeartbeatLease(led, 0, interval_s=0.05,
                        info_fn=lambda: {"step": 3}):
        time.sleep(0.25)
        assert led.fresh(0, ttl_s=0.5)
        assert led.read_heartbeat(0)["step"] == 3
        assert led.live_ranks(ttl_s=0.5) == [0]
    time.sleep(0.3)
    assert not led.fresh(0, ttl_s=0.2)
    assert led.live_ranks(ttl_s=0.2) == []


def test_event_log_is_ordered_and_typed(tmp_path):
    led = FleetLedger(str(tmp_path))
    led.event(0, "kill", step=10)
    led.event(1, "restore", step=7)
    assert [e["kind"] for e in led.events()] == ["kill", "restore"]
    assert all("utc" in e and "ts" in e for e in led.events())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_ledger_written_by_one_package_reads_in_the_other(tmp_path,
                                                            writer):
    """Config, plans, announcements, leases, events and finals: the
    files are the same, name for name and key for key."""
    w = (FleetLedger if writer == "port" else jfleet.FleetLedger)(
        str(tmp_path))
    r = (jfleet.FleetLedger if writer == "port" else FleetLedger)(
        str(tmp_path))
    cfg_cls = FleetConfig if writer == "port" else jfleet.FleetConfig
    w.write_config(cfg_cls(num_steps=12, faults=("rank_kill@6:1",)))
    assert w.write_plan({"gen": 0, "members": [0, 1], "port": 5,
                         "restore_step": None, "reason": "initial"})
    assert w.announce(1) == 0
    w.heartbeat(1, incarnation=0)
    w.event(1, "kill", gen=0, step=6)
    w.final(0, gen=2, step=11, digest="ab")
    got = r.read_config()
    assert (got.num_steps, got.faults, got.lease_ttl_s) == \
        (12, ("rank_kill@6:1",), 2.0)
    assert r.latest_plan()["members"] == [0, 1]
    assert r.incarnation(1) == 0 and r.live_ranks(ttl_s=5.0) == [1]
    assert [(e["kind"], e["step"]) for e in r.events()] == [("kill", 6)]
    assert r.finals()[0]["digest"] == "ab"
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["config.json"] + ["hb", "progress", "member", "gen", "events",
                           "finals", "incidents", "ckpt", "aot", "logs"])


def test_fleet_config_keeps_jaxs_keys_and_adds_placement():
    port = FleetConfig().to_json()
    jax_keys = set(jfleet.FleetConfig().to_json())
    assert set(port) - jax_keys == {"device", "backend"}
    assert (port["device"], port["backend"]) == ("cuda", "nccl")
    assert {k: port[k] for k in jax_keys} == jfleet.FleetConfig().to_json()
    assert FleetConfig.from_json(jfleet.FleetConfig(seed=3).to_json()) \
        == FleetConfig(seed=3)


# -- the membership gate -----------------------------------------------------

def _gate_cfg():
    # poll_s=0: every gate() call scans the ledger
    return FleetConfig(world_size=2, lease_ttl_s=0.2, poll_s=0.0)


def test_gate_raises_shrink_when_member_lease_stale(tmp_path):
    led = FleetLedger(str(tmp_path))
    led.announce(0), led.announce(1)
    led.heartbeat(0)                      # rank 1 never beats: dead
    seen = []
    gate = membership_gate(led, _gate_cfg(),
                           {"gen": 0, "members": [0, 1]}, rank=0,
                           on_change=lambda *a: seen.append(a))
    with pytest.raises(FleetMembershipChange) as ei:
        gate(11)
    assert (ei.value.reason, ei.value.ranks, ei.value.step) == \
        ("shrink", [1], 11)
    assert seen == [("shrink", [1], 11)]


def test_gate_raises_regrow_when_nonmember_lease_appears(tmp_path):
    led = FleetLedger(str(tmp_path))
    led.announce(0), led.heartbeat(0)
    gate = membership_gate(led, _gate_cfg(), {"gen": 1, "members": [0]},
                           rank=0)
    gate(5)                               # alone: no change
    led.announce(1), led.heartbeat(1)     # the killed rank returns
    with pytest.raises(FleetMembershipChange) as ei:
        gate(6)
    assert ei.value.reason == "regrow" and ei.value.ranks == [1]


def test_gate_raises_on_newer_plan(tmp_path):
    led = FleetLedger(str(tmp_path))
    led.announce(0), led.heartbeat(0)
    gate = membership_gate(led, _gate_cfg(), {"gen": 0, "members": [0]},
                           rank=0)
    led.write_plan({"gen": 1, "members": [0], "restore_step": 3})
    with pytest.raises(FleetMembershipChange) as ei:
        gate(4)
    assert ei.value.reason == "plan"


def test_gate_throttles_ledger_scans(tmp_path):
    led = FleetLedger(str(tmp_path))
    led.announce(0), led.heartbeat(0)
    cfg = FleetConfig(world_size=2, lease_ttl_s=0.2, poll_s=30.0)
    gate = membership_gate(led, cfg, {"gen": 0, "members": [0, 1]}, rank=0)
    with pytest.raises(FleetMembershipChange):
        gate(0)                           # the first call always scans
    gate(1)                               # inside the poll window: silent


# -- absolute steps and fault shifting ---------------------------------------

class _FakeInner:
    def __init__(self):
        self.saved = []
        self.last_restore = None

    def save(self, step, state, extras=None):
        self.saved.append(step)

    def all_steps(self):
        return [3, 7, 11]

    def restore(self, template, step=None, extras=None):
        self.last_restore = {"step": 11 if step is None else step,
                             "skipped": []}
        return template, {}

    def wait(self):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("package", [fleet_mod, jfleet])
def test_step_offset_manager_translates_to_absolute_steps(package):
    inner = _FakeInner()
    mgr = package._StepOffsetManager(inner, start=7)
    mgr.save(0, None)
    mgr.save(4, None)
    assert inner.saved == [7, 11]         # abs = start + local
    assert mgr.all_steps() == [0, 4]      # steps before start invisible
    mgr.restore(None, step=4)
    assert inner.last_restore["step"] == 11
    assert mgr.last_restore["step"] == 4  # back to local for the loop


def test_parse_fleet_faults_shift_and_vocabulary():
    out = fleet_mod._parse_fleet_faults(["rank_kill@10:1", "rank_kill@3"],
                                        start=7)
    assert out == [RankKill(step=3, rank=1)]   # 10-7=3; step 3 < 7 dropped
    want = jfleet._parse_fleet_faults(["rank_kill@10:1", "rank_kill@3"],
                                      start=7)
    assert [(f.step, f.rank) for f in out] == \
        [(f.step, f.rank) for f in want]
    with pytest.raises(ValueError, match="not supported in the fleet"):
        fleet_mod._parse_fleet_faults(["nan_storm@5"], start=0)


# -- replan leadership -------------------------------------------------------

def _plan(gen, members, **kw):
    return {"gen": gen, "members": members, "port": 1,
            "restore_step": None, "reason": "initial",
            "created_by": members[0], "created_ts": time.time(),
            "incarnations": {str(r): 0 for r in members}, **kw}


def test_replan_leader_is_surviving_member_not_returning_min_rank(tmp_path):
    led = FleetLedger(str(tmp_path))
    cfg = FleetConfig(world_size=2, lease_ttl_s=5.0, poll_s=0.01,
                      replan_window_s=10.0)
    assert led.write_plan(_plan(0, [0, 1]))
    assert led.write_plan(_plan(1, [1], reason="shrink"))
    led.announce(0), led.heartbeat(0)     # rank 0 is back: lease fresh
    led.announce(1), led.heartbeat(1)
    t0 = time.monotonic()
    plan = fleet_mod._await_next_plan(led, cfg, rank=1, gen=1)
    assert time.monotonic() - t0 < cfg.replan_window_s / 2
    assert (plan["gen"], plan["members"], plan["reason"],
            plan["created_by"]) == (2, [0, 1], "regrow", 1)


def test_replan_grace_lets_waiting_member_pass_a_stalled_leader(tmp_path):
    led = FleetLedger(str(tmp_path))
    cfg = FleetConfig(world_size=2, lease_ttl_s=10.0, poll_s=0.02,
                      replan_window_s=1.0)
    assert led.write_plan(_plan(0, [0, 1]))
    led.announce(0), led.heartbeat(0)     # leader rank 0: fresh, silent
    led.announce(1), led.heartbeat(1)
    t0 = time.monotonic()
    plan = fleet_mod._await_next_plan(led, cfg, rank=1, gen=0)
    assert time.monotonic() - t0 >= cfg.replan_window_s / 2 - 0.1
    assert (plan["created_by"], plan["reason"], plan["members"]) == \
        (1, "reform", [0, 1])


def test_joiner_takes_over_only_when_every_member_lease_is_stale(tmp_path):
    led = FleetLedger(str(tmp_path))
    cfg = FleetConfig(lease_ttl_s=0.2, poll_s=0.0)
    led.announce(0), led.heartbeat(0)
    led.announce(1)
    plan = _plan(0, [0])
    assert led.write_plan(plan)
    led.heartbeat(1)
    assert not fleet_mod._take_over_dead_generation(led, cfg, 1, plan)
    time.sleep(0.3)                       # member 0's lease goes stale
    led.heartbeat(1)                      # the joiner stays fresh
    assert fleet_mod._take_over_dead_generation(led, cfg, 1, plan)
    nxt = led.read_plan(1)
    assert nxt["members"] == [1] and nxt["created_by"] == 1
    assert "takeover" in [e["kind"] for e in led.events()]


# -- digests and pinned restores ---------------------------------------------

def _mlp_amp(opt_level="O2", seed=0):
    from torch import nn
    gen = torch.Generator().manual_seed(seed)
    model = nn.Module()
    model.w1 = nn.Parameter(torch.randn(4, 8, generator=gen))
    model.w2 = nn.Parameter(torch.randn(8, 4, generator=gen))
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level=opt_level, device="cpu")
    step = amp.make_train_step(a, model, fleet_mod._mlp_loss)
    x = torch.randn(8, 4, generator=gen)
    return a, step, x


#: a bf16 leaf beside the O2 state, as the snapshot writes it (its words)
def _extras():
    return {"bf16": torch.linspace(-3, 3, 6).to(torch.bfloat16)}


def test_state_digest_equals_snapshot_digest(tmp_path):
    a, step, x = _mlp_amp()
    step(x), step(x)
    mgr = DurableCheckpointManager(str(tmp_path))
    mgr.save(3, a, extras=_extras())
    mgr.wait()
    assert latest_verified_step(str(tmp_path)) == 3
    assert snapshot_digest(str(tmp_path), 3) == state_digest(a, _extras())
    before = state_digest(a, _extras())
    step(x)                               # one more step: another state
    assert state_digest(a, _extras()) != before
    mgr.close()


def test_state_digest_of_a_state_carried_across_equals_jaxs(tmp_path):
    """A JAX O2 state (with a bf16 extra) snapshotted by the JAX package,
    restored into the port's ``Amp``: the port's digest of it equals
    JAX's of the original, and the port's own snapshot of it equals
    both."""
    params = {"w1": jax.random.normal(jax.random.PRNGKey(0), (4, 8)),
              "w2": jax.random.normal(jax.random.PRNGKey(1), (8, 4))}
    ja = jamp.initialize(optimizer=JaxFusedAdam(lr=1e-2), opt_level="O2",
                         verbosity=0)
    jstep = jax.jit(jamp.make_train_step(
        ja, lambda p, xb: jnp.mean(jnp.square(
            jax.nn.relu(xb @ p["w1"]) @ p["w2"] - xb))))
    jstate = ja.init(params)
    xj = jax.random.normal(jax.random.PRNGKey(2), (8, 4))
    for _ in range(2):
        jstate, _ = jstep(jstate, xj)
    jextras = {"bf16": jnp.linspace(-3, 3, 6).astype(jnp.bfloat16)}
    jmgr = JaxManager(str(tmp_path / "jax"))
    jmgr.save(2, jstate, extras=jextras)
    jmgr.wait()
    jmgr.close()
    want = jfleet.state_digest(jstate, jextras)
    assert jfleet.snapshot_digest(str(tmp_path / "jax"), 2) == want

    a, _, _ = _mlp_amp()
    extras = {"bf16": torch.zeros(6, dtype=torch.bfloat16)}
    fleet_mod.load_snapshot_state(str(tmp_path / "jax"), 2, a, extras)
    assert torch.equal(extras["bf16"], _extras()["bf16"])
    assert state_digest(a, extras) == want
    assert snapshot_digest(str(tmp_path / "jax"), 2) == want
    mgr = DurableCheckpointManager(str(tmp_path / "port"))
    mgr.save(2, a, extras=extras)
    mgr.close()
    assert snapshot_digest(str(tmp_path / "port"), 2) == want


def test_load_snapshot_state_restores_the_pinned_step(tmp_path):
    a, step, x = _mlp_amp()
    step(x)
    mgr = DurableCheckpointManager(str(tmp_path), max_to_keep=4)
    mgr.save(1, a)
    mgr.wait()
    first = state_digest(a)
    step(x)
    mgr.save(2, a)
    mgr.wait()
    later = state_digest(a)
    other, _, _ = _mlp_amp(seed=5)
    fleet_mod.load_snapshot_state(str(tmp_path), 1, other)
    assert state_digest(other) == first != later
    mgr.close()


def test_latest_verified_step_skips_corrupt_newest(tmp_path):
    a, step, x = _mlp_amp()
    mgr = DurableCheckpointManager(str(tmp_path), max_to_keep=4)
    mgr.save(1, a)
    step(x)
    mgr.save(2, a)
    mgr.close()
    from apex_tpu_torch.resilience import durable
    victim = next(p for p in (tmp_path / durable._step_dirname(2)).iterdir()
                  if p.suffix == ".npy")
    victim.write_bytes(victim.read_bytes()[:10])
    assert latest_verified_step(str(tmp_path)) == 1
    assert jfleet.latest_verified_step(str(tmp_path)) == 1


# -- the train_fleet_* family ------------------------------------------------

def _metric(snap, name):
    return next(m for m in snap["metrics"] if m["name"] == name)


def test_fleet_metrics_family_matches_jaxs():
    from apex_tpu.obs.metrics import Registry as JaxRegistry
    snaps = []
    for reg, fm_cls in ((Registry(), FleetMetrics),
                        (JaxRegistry(), jfleet.FleetMetrics)):
        fm = fm_cls(reg, active_ranks=2)
        fm.on_preemption()
        fm.on_recovery(1.5)
        fm.on_rewind()
        fm.set_active(1)
        fm.on_resolve()
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    hist = _metric(snaps[0], "train_fleet_recovery_seconds")
    assert hist["count"] == 1 and hist["sum"] == 1.5
    assert _metric(snaps[0], "train_fleet_active_ranks")["value"] == 1.0


def test_run_resilient_emits_fleet_metrics_at_resolve_and_rewind():
    a, step, x = _mlp_amp()
    reg = Registry()
    fm = FleetMetrics(reg, active_ranks=2)
    fm.active.set(0)          # the resolve point sets it again
    result = run_resilient(step, a, lambda i: (x,), 4,
                           config=ResilienceConfig(checkpoint_every=2),
                           registry=reg, fleet_metrics=fm)
    assert result.steps_completed == 4
    snap = reg.snapshot()
    assert _metric(snap, "train_fleet_active_ranks")["value"] == 2.0
    assert _metric(snap, "train_fleet_rewinds_total")["value"] == 0.0
    # a non-finite loss outside an overflow skip rewinds: on_rewind
    calls = []

    def poisoned(xb):
        calls.append(1)
        m = step(xb)
        return dict(m, loss=m["loss"] * float("nan")) if len(calls) == 3 \
            else m

    run_resilient(poisoned, a, lambda i: (x,), 4,
                  config=ResilienceConfig(checkpoint_every=2),
                  registry=reg, fleet_metrics=fm)
    assert _metric(reg.snapshot(), "train_fleet_rewinds_total")["value"] \
        == 1.0


# -- the drill's workload against JAX ----------------------------------------

WORKLOAD = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam
from apex_tpu.resilience import DurableCheckpointManager
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.resilience import fleet

cfg = fleet.FleetConfig(device="cpu", backend="gloo")
k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed))
params = {"w1": jax.random.normal(k1, (cfg.d_in, cfg.hidden)),
          "w2": jax.random.normal(k2, (cfg.hidden, cfg.d_in))}
a = jamp.initialize(optimizer=FusedAdam(lr=1e-3), opt_level="O2",
                    min_loss_scale=cfg.min_loss_scale, verbosity=0)
step = jax.jit(jamp.make_train_step(a, lambda p, xb: jnp.mean(jnp.square(
    jax.nn.relu(xb @ p["w1"]) @ p["w2"] - xb))))
multiproc.initialize(coordinator_address=f"localhost:{multiproc._free_port()}",
                     num_processes=1, process_id=0, timeout_s=30, retries=0,
                     backend="gloo", device="cpu")
wl = fleet._Workload(cfg, 1, 0)
state = a.init(params)
for s in range(4):
    state, _ = step(state, wl.batch_array(s))
mgr = DurableCheckpointManager(sys.argv[2])
mgr.save(3, state)
mgr.close()
fleet.load_snapshot_state(sys.argv[2], 3, wl.amp)
rows = [fleet.state_digest(wl.amp) == fleet.snapshot_digest(sys.argv[2], 3)]
for s in range(4, 8):
    state, jm = step(state, wl.batch_array(s))
    pm = wl.step_fn(wl.make_global_batch(s))
    rows.append([float(jm["loss"]), float(pm["loss"])] + [
        float(np.max(np.abs(np.asarray(state.master_params[k])
                            - wl.amp.masters[k].numpy())))
        for k in ("w1", "w2")])
print(json.dumps(rows))
'''


def test_workload_steps_from_a_jax_snapshot_match_jax(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", WORKLOAD, str(REPO),
                        str(tmp_path / "ckpt")], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    assert rows[0] is True            # the port's digest of JAX's snapshot
    for jax_loss, port_loss, err_w1, err_w2 in rows[1:]:
        assert abs(jax_loss - port_loss) <= 1e-6
        assert max(err_w1, err_w2) <= 1e-5


# -- the drill ---------------------------------------------------------------

def test_two_rank_cpu_drill_shrinks_regrows_and_is_bitwise(tmp_path):
    """A real SIGKILL of rank 1 (child and supervisor) at step 6 of 16 on
    two gloo ranks: the survivor shrinks within the lease window and
    restores step 3, the returning rank regrows the fleet, and both
    replays end bit for bit where the drill did.  The shrunken
    generation has 8 paced steps after its first snapshot: room for the
    returning supervisor to start on a loaded machine."""
    cfg = FleetConfig(num_steps=16, checkpoint_every=4, world_size=2,
                      lease_ttl_s=1.0, heartbeat_s=0.2, poll_s=0.05,
                      init_timeout_s=30.0, step_delay_s=0.4,
                      faults=("rank_kill@6:1",), device="cpu",
                      backend="gloo")
    out = run_fleet_drill(str(tmp_path), cfg, timeout_s=120.0,
                          env={"OMP_NUM_THREADS": "1"})
    assert out["bitwise"] == {"shrink_matches_uninterrupted": True,
                              "regrow_matches_uninterrupted": True,
                              "final_cross_rank_identical": True}
    gens = out["generations"]
    assert [g["members"] for g in gens[:3]] == [[0, 1], [0], [0, 1]]
    assert [g["reason"] for g in gens[1:3]] == ["shrink", "regrow"]
    assert out["kill_step"] == 6 and out["shrink_restore"] == 3
    assert out["steps_lost"] <= cfg.checkpoint_every
    assert out["regrow_restore"] >= 7
    assert 0 < out["detection_latency_s"] <= 4 * (cfg.lease_ttl_s
                                                 + cfg.poll_s)
    assert out["recovery_seconds"]
    led = FleetLedger(out["root"])
    kinds = [e["kind"] for e in led.events()]
    assert {"kill", "shrink_detected", "regrow_detected", "restore",
            "preflight", "aot"} <= set(kinds)
    assert {e["source"] for e in led.events() if e["kind"] == "aot"} \
        == {"eager"}
    # every formation's SPMD preflight passed, one schedule a generation
    pre = [e for e in led.events() if e["kind"] == "preflight"]
    assert {e["gen"] for e in pre} == {g["gen"] for g in gens}
    assert all(e["ok"] is True and e["exchange"] in ("store", "none")
               for e in pre)
    for g in gens:
        mine = [e for e in pre if e["gen"] == g["gen"]]
        assert len(mine) == len(g["members"])
        assert len({e["schedule_hash"] for e in mine}) == 1
        assert {e["n_collectives"] for e in mine} == {2}
    # the JAX package reads the drill's ledger
    jled = jfleet.FleetLedger(out["root"])
    assert len(jled.events()) == len(kinds)
    assert jled.read_plan(1)["members"] == [0]
    from apex_tpu_torch.resilience.incidents import validate_incident_file
    inc = led.path("incidents")
    assert all(validate_incident_file(os.path.join(inc, n)) == []
               for n in os.listdir(inc))
