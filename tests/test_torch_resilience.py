"""The port's self-healing train loop, fault injector, incident records,
flight recorder and registry snapshot (``apex_tpu_torch/resilience``,
``apex_tpu_torch/obs``) against the JAX package's, on the CPU.

``run_resilient`` parity: the JAX package's loop cases
(``tests/l0/test_resilience.py`` lines 327-568), each run by both
packages on the same amp O2 workload (that file's ``_workload``: the
MLP((32,)), FusedAdam(1e-2), ``min_loss_scale`` 2**14 so that a storm
pins the scale in 2 overflows; the port's weights and batch are JAX's,
through ``convert.py``) under the same fault schedule.  Both must give
the same event sequence (names and steps), the same rewinds, the same
resolved steps with non-finite losses at the same steps, and finite
losses within ``2e-2`` (``tests/test_torch_train.py``'s O2 bound: bf16
compute rounds at other places in XLA and PyTorch); every incident the
port writes passes both packages' ``validate_incident`` and
``tools/gate_hygiene.py``'s loader.  Watchdog budgets are 0.3 s with a
0.6 s hang; checkpoints skip fsync where fsync is not under test.
"""

import functools
import importlib.util
import json
import os
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu import resilience as jres
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_cross_entropy
from apex_tpu.obs import flight as jax_flight
from apex_tpu.obs import metrics as jax_metrics
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp, resilience as res
from apex_tpu_torch.convert import mlp_params_from_jax
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.obs import FlightRecorder, Registry
from apex_tpu_torch.optimizers import FusedAdam

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 2e-2
WATCHDOG_S = 0.3
HANG_S = 0.6


@functools.lru_cache(maxsize=None)
def _jax_workload(min_loss_scale):
    model = JaxMLP(features=(32,))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"]
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2), opt_level="O2",
                           min_loss_scale=min_loss_scale, verbosity=0)
    step = jax.jit(jax_amp.make_train_step(
        a, lambda p, x, y: jax_cross_entropy(
            model.apply({"params": p}, x), y)))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 16))
    y = jax.random.randint(jax.random.PRNGKey(2), (32,), 0, 10)
    return a, step, a.init(params), (lambda i: (x, y)), params, x, y


def _port_workload(min_loss_scale):
    *_, params, x, y = _jax_workload(min_loss_scale)
    model = mlp_params_from_jax(jax.tree.map(np.array, params),
                                features=(32,), in_features=16,
                                device="cpu", trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level="O2", device="cpu",
                       min_loss_scale=min_loss_scale)
    step = amp.make_train_step(a, model,
                               lambda m, x, y: cross_entropy_loss(m(x), y))
    xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(
        np.array(y)).long()
    return a, step, (lambda i: (xt, yt))


class Outcome:
    def __init__(self, result=None, exc=None, injector=None, manager=None,
                 incident=None):
        self.result, self.exc = result, exc
        self.injector, self.manager, self.incident = injector, manager, \
            incident


def _run(pkg, tmp_path, faults=(), steps=12, cfg=None, manager=None,
         min_loss_scale=2.0 ** 14, raises=None):
    """One package's run_resilient on the workload: ``faults`` as
    ``(class name, kwargs)``, ``manager`` the manager's kwargs (None: no
    manager), ``cfg`` ResilienceConfig kwargs (an incident path added),
    ``raises`` the exception's class name when the run must fail."""
    mod = jres if pkg == "jax" else res
    inj = mod.FaultInjector([getattr(mod, n)(**kw) for n, kw in faults])
    mgr = None if manager is None else mod.DurableCheckpointManager(
        str(tmp_path / pkg), fsync=False, io_hook=inj.io_hook,
        on_commit=inj.on_commit, **manager)
    path = tmp_path / f"INCIDENT_{pkg}.json"
    config = mod.ResilienceConfig(incident_path=str(path), **(cfg or {}))
    if pkg == "jax":
        a, step, state, batch, *_ = _jax_workload(min_loss_scale)

        def call():
            return jres.run_resilient(step, state, batch, steps, amp_obj=a,
                                      manager=mgr, config=config,
                                      injector=inj,
                                      registry=jax_metrics.Registry())
    else:
        a, step, batch = _port_workload(min_loss_scale)

        def call():
            return res.run_resilient(step, a, batch, steps, manager=mgr,
                                     config=config, injector=inj,
                                     registry=Registry())
    out = Outcome(injector=inj, manager=mgr)
    if raises is None:
        out.result = call()
    else:
        with pytest.raises(Exception) as ei:
            call()
        assert type(ei.value).__name__ == raises, ei.value
        out.exc = ei.value
    if path.exists():
        out.incident = json.loads(path.read_text())
    return out


def _gate_hygiene_validator():
    """``tools/gate_hygiene.py``'s loader of the JAX package's incident
    schema (by file path, as the tool loads it)."""
    spec = importlib.util.spec_from_file_location(
        "_gate_hygiene", ROOT / "tools" / "gate_hygiene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._load_by_path(str(ROOT), "apex_tpu", "resilience",
                             "incidents.py").validate_incident


def _check_incident(rec):
    assert res.validate_incident(rec) == []
    assert jres.validate_incident(rec) == []
    assert _gate_hygiene_validator()(rec) == []


def _events(events):
    return [(e["event"], e.get("step"), e.get("to_step"), e.get("attempt"))
            for e in events]


def _assert_same_losses(got, want):
    assert [j for j, _ in got] == [j for j, _ in want]
    g = np.array([v for _, v in got])
    w = np.array([v for _, v in want])
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], atol=LOSS_TOL, rtol=0)


def _storm(**extra):
    return dict(faults=[("NaNStorm", dict(step=5, duration=6))], steps=18,
                manager={},
                cfg=dict(checkpoint_every=3, overflow_patience=3,
                         max_rewinds=2, watchdog_timeout_s=120.0, **extra))


CASES = {
    # the storm pins the scale; the loop rewinds to the last good
    # checkpoint with a fresh scaler and converges
    "nan_storm_rewinds_and_converges": _storm(),
    # the manager's own retry off, so the OSError reaches the loop's
    "flaky_save_absorbed_by_retry": dict(
        faults=[("FlakyIO", dict(op="save", fails=2))], steps=6,
        manager=dict(async_save=False, io_retries=0),
        cfg=dict(checkpoint_every=2, io_retries=3, io_backoff_s=0.0)),
    "preemption_flushes": dict(
        faults=[("Preempt", dict(step=7))], manager={},
        cfg=dict(checkpoint_every=3), raises="SimulatedPreemption"),
    "divergence_fails_after_max_rewinds": dict(
        faults=[("NaNStorm", dict(step=2, duration=1000))], steps=40,
        manager={}, cfg=dict(checkpoint_every=2, overflow_patience=2,
                             max_rewinds=1),
        raises="DivergenceError"),
    "no_checkpoint_to_rewind_to": dict(
        faults=[("NaNStorm", dict(step=0, duration=1000))], steps=20,
        cfg=dict(checkpoint_every=0, overflow_patience=2),
        raises="DivergenceError"),
    # one overflow far above the floor is amp's normal skip
    "normal_overflow_is_not_pathological": dict(
        faults=[("NaNStorm", dict(step=3, duration=1))], steps=8,
        cfg=dict(overflow_patience=3), min_loss_scale=1.0),
    "a_managerless_run_rewinds_from_a_host_copy": dict(
        faults=[("NaNStorm", dict(step=5, duration=6))], steps=18,
        cfg=dict(checkpoint_every=3, overflow_patience=3, max_rewinds=2)),
    "preflight_rejection_aborts_with_an_incident": _storm(
        preflight="reject"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_resilient_matches_jax(case, tmp_path):
    spec = dict(CASES[case])
    cfg = dict(spec.get("cfg", {}))
    if cfg.get("preflight") == "reject":
        def reject(_state):
            raise RuntimeError("rank 1 diverged: extra all-reduce")
        cfg["preflight"] = reject
        spec["raises"] = "RuntimeError"
    spec["cfg"] = cfg
    jax_out = _run("jax", tmp_path, **spec)
    out = _run("torch", tmp_path, **spec)
    assert (jax_out.incident is None) == (out.incident is None)
    if out.incident is not None:
        _check_incident(out.incident)
        assert out.incident["status"] == jax_out.incident["status"]
        assert out.incident["summary"] == jax_out.incident["summary"]
    assert [e["fault"] for e in out.injector.events] == \
        [e["fault"] for e in jax_out.injector.events]
    if out.exc is not None:
        assert str(out.exc) == str(jax_out.exc)
        return
    r, jr = out.result, jax_out.result
    assert _events(r.events) == _events(jr.events)
    assert r.rewinds == jr.rewinds
    assert r.steps_completed == jr.steps_completed == spec["steps"]
    _assert_same_losses(r.losses, jr.losses)
    assert np.isfinite(r.losses[-1][1])
    if case == "nan_storm_rewinds_and_converges":
        assert r.rewinds == 1
        assert "pinned at min_loss_scale" in [
            e for e in r.events if e["event"] == "rewind"][0]["reason"]
        assert r.losses[-1][1] < r.losses[0][1]
        assert float(r.state.scaler_state.loss_scale) > 2.0 ** 14
    if case == "flaky_save_absorbed_by_retry":
        assert any(e["event"] == "save_retry" for e in r.events)
        assert out.manager.latest_step() == jax_out.manager.latest_step()
    if case == "normal_overflow_is_not_pathological":
        assert r.rewinds == 0


def test_preemption_restore_lands_on_the_last_good_snapshot(tmp_path):
    """After a preemption at step 7 (saves at 2 and 5), a fresh manager
    and template restore step 5 in both packages; resumed at step 6, the
    port's run equals the uninterrupted one bit for bit."""
    spec = dict(CASES["preemption_flushes"])
    jax_out = _run("jax", tmp_path, **spec)
    out = _run("torch", tmp_path, **spec)
    _check_incident(out.incident)
    assert out.incident["status"] == "preempted"
    a, step, batch, *_ = _jax_workload(2.0 ** 14)
    jmgr = jres.DurableCheckpointManager(str(tmp_path / "jax"))
    jmgr.restore(a.init(jax.tree.map(np.asarray, _jax_workload(
        2.0 ** 14)[2].master_params)))
    mgr = res.DurableCheckpointManager(str(tmp_path / "torch"))
    b, step_b, batch_b = _port_workload(2.0 ** 14)
    mgr.restore(b)
    assert mgr.last_restore["step"] == jmgr.last_restore["step"] == 5

    cfg = res.ResilienceConfig(checkpoint_every=3)
    resumed = res.run_resilient(step_b, b, batch_b, 12, manager=mgr,
                                config=cfg, registry=Registry(),
                                start_step=6)
    assert [j for j, _ in resumed.losses] == list(range(6, 12))
    c, step_c, batch_c = _port_workload(2.0 ** 14)
    whole = res.run_resilient(step_c, c, batch_c, 12, config=cfg,
                              registry=Registry())
    assert [v for _, v in resumed.losses] == [v for _, v in whole.losses[6:]]
    for n, t in c.masters.items():
        assert torch.equal(b.masters[n], t), n


def test_an_operator_interrupt_records_an_incident(tmp_path):
    recs = {}
    for pkg, mod in (("jax", jres), ("torch", res)):
        path = tmp_path / f"{pkg}.json"
        cfg = mod.ResilienceConfig(incident_path=str(path))
        if pkg == "jax":
            a, step, state, *_ = _jax_workload(2.0 ** 14)
            zeros = (jnp.zeros((32, 16)), jnp.zeros((32,), jnp.int32))
        else:
            a, step, _ = _port_workload(2.0 ** 14)
            zeros = (torch.zeros(32, 16), torch.zeros(32, dtype=torch.long))

        def batch(i):
            if i == 3:
                raise KeyboardInterrupt
            return zeros

        with pytest.raises(KeyboardInterrupt):
            if pkg == "jax":
                jres.run_resilient(step, state, batch, 8, amp_obj=a,
                                   config=cfg,
                                   registry=jax_metrics.Registry())
            else:
                res.run_resilient(step, a, batch, 8, config=cfg,
                                  registry=Registry())
        recs[pkg] = json.loads(path.read_text())
    _check_incident(recs["torch"])
    assert recs["torch"]["status"] == recs["jax"]["status"] == "interrupted"
    assert recs["torch"]["summary"] == recs["jax"]["summary"]


def test_a_hung_step_writes_its_incident_within_the_budget(tmp_path):
    a, step, batch = _port_workload(2.0 ** 14)
    path = tmp_path / "INCIDENT_watchdog.json"
    inj = res.FaultInjector([res.HangStep(step=2, seconds=HANG_S)])
    cfg = res.ResilienceConfig(watchdog_timeout_s=WATCHDOG_S,
                               watchdog_poll_s=0.02,
                               incident_path=str(path))
    t0 = time.time()
    with pytest.raises(res.WatchdogTimeout):
        res.run_resilient(step, a, batch, 6, config=cfg, injector=inj,
                          registry=Registry())
    hang_start = next(e for e in inj.events if e["fault"] == "hang_step")
    assert hang_start
    rec = json.loads(path.read_text())
    _check_incident(rec)
    assert rec["status"] == "watchdog-timeout"
    # written while the hang was still on, not after it ended by itself
    assert os.path.getmtime(path) - t0 < HANG_S + 0.25
    assert any(e["kind"] == "watchdog" for e in rec["flight"]["events"])
    assert any(e["kind"] == "fault" and e["fault"] == "hang_step"
               for e in rec["flight"]["events"])
    assert {m["name"] for m in rec["metrics"]["metrics"]} >= {
        "train_steps_total", "train_loss", "train_watchdog_margin_s"}


def test_preflight_runs_after_every_rewind_on_the_restored_state(tmp_path):
    calls = []

    def preflight(state):
        calls.append(all(bool(torch.isfinite(t).all())
                         for t in state.masters.values()))

    out = _run("torch", tmp_path, **_storm(preflight=preflight))
    r = out.result
    assert r.rewinds == 1 and calls == [True]
    pf = [e for e in r.events if e["event"] == "preflight"]
    assert pf and pf[0]["to_step"] == \
        [e for e in r.events if e["event"] == "rewind"][0]["to_step"]


def test_without_faults_the_loop_equals_the_plain_loop():
    a, step, batch = _port_workload(2.0 ** 14)
    for i in range(5):
        step(*batch(i))
    b, step_b, batch_b = _port_workload(2.0 ** 14)
    result = res.run_resilient(step_b, b, batch_b, 5, registry=Registry())
    assert result.state is b
    for n, t in a.masters.items():
        assert torch.equal(b.masters[n], t), n
    assert int(a.step) == int(b.step) == 5


def _jax_w_step(kind):
    if kind == "decay":
        def step(st, x):
            w = st["w"] - 0.1 * x
            return {"w": w}, {"loss": jnp.sum(w ** 2)}
    else:
        def step(st, x):
            w = st["w"] * 0.9 + x
            return {"w": w}, {"loss": jnp.sum(w)}
    return jax.jit(step)


def _port_w_step(state, kind):
    def step(x):
        w = state["w"]
        with torch.no_grad():
            if kind == "decay":
                w.sub_(0.1 * x)
                return {"loss": (w ** 2).sum()}
            w.mul_(0.9).add_(x)
            return {"loss": w.sum()}
    return step


@pytest.mark.parametrize("kind", ["decay", "nan_once"])
def test_a_state_that_is_not_an_amp_checkpoints_and_rewinds(kind):
    """A container of tensors changed in place by the step: host copies
    at the checkpoint cadence, restored by copy on a rewind (the JAX
    package's generic pytree state)."""
    def batches(mod_zeros, full):
        fired = {"done": False}

        def batch(i):
            if kind == "nan_once" and i == 4 and not fired["done"]:
                fired["done"] = True
                return (full(float("nan")),)
            return (full(0.01 if kind == "decay" else 0.1),)
        return batch

    jr = jres.run_resilient(
        _jax_w_step(kind), {"w": jnp.ones(4)},
        batches(None, lambda v: jnp.full((4,), v)),
        6 if kind == "decay" else 8,
        config=jres.ResilienceConfig(checkpoint_every=2, max_rewinds=2),
        registry=jax_metrics.Registry())
    state = {"w": torch.ones(4)}
    r = res.run_resilient(
        _port_w_step(state, kind), state,
        batches(None, lambda v: torch.full((4,), v)),
        6 if kind == "decay" else 8,
        config=res.ResilienceConfig(checkpoint_every=2, max_rewinds=2),
        registry=Registry())
    assert _events(r.events) == _events(jr.events)
    assert r.rewinds == jr.rewinds == (1 if kind == "nan_once" else 0)
    _assert_same_losses(r.losses, jr.losses)
    np.testing.assert_allclose(state["w"].numpy(),
                               np.asarray(jr.state["w"]), rtol=1e-6)
    assert torch.isfinite(state["w"]).all()


# ---------------------------------------------------------------------------
# retry_io, the injector, incidents, the flight recorder, the registry
# ---------------------------------------------------------------------------

def test_retry_io_backoff_schedule(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:
            raise OSError("transient")
        return "ok"

    assert res.retry_io(flaky, retries=3, backoff_s=0.1) == "ok"
    assert calls["n"] == 4
    np.testing.assert_allclose(sleeps, [0.1, 0.2, 0.4])


def test_retry_io_gives_up_and_passes_other_errors(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    with pytest.raises(OSError):
        res.retry_io(lambda: (_ for _ in ()).throw(OSError("dead")),
                     retries=2)
    calls = {"n": 0}

    def bug():
        calls["n"] += 1
        raise ValueError("a bug, not weather")

    with pytest.raises(ValueError):
        res.retry_io(bug, retries=5)
    assert calls["n"] == 1


@pytest.mark.parametrize("spec", [
    "nan_storm@4", "nan_storm@4:3", "ckpt_truncate@2", "ckpt_corrupt@9",
    "preempt@7", "rank_kill@3", "rank_kill@3:1", "hang@2", "hang@2:0.5",
    "flaky_io", "flaky_io:3", "slow_io", "slow_io:0.2"])
def test_parse_fault_matches_jax(spec):
    got, want = res.parse_fault(spec), jres.parse_fault(spec)
    assert type(got).__name__ == type(want).__name__
    assert got.__dict__ == want.__dict__


def test_parse_fault_refuses_what_jax_refuses():
    for spec in ("nan_storm", "bogus@1", "preempt"):
        with pytest.raises(ValueError):
            jres.parse_fault(spec)
        with pytest.raises(ValueError):
            res.parse_fault(spec)


@pytest.mark.parametrize("seed", [0, 3, 5, 11])
@pytest.mark.parametrize("kind", ["truncate", "corrupt"])
def test_the_injector_damages_the_same_leaf_file_as_jax(seed, kind,
                                                        tmp_path):
    files = {}
    for pkg, mod in (("jax", jres), ("torch", res)):
        d = tmp_path / pkg
        d.mkdir()
        for i in range(7):
            (d / f"leaf_{i:05d}.npy").write_bytes(bytes(range(64)))
        inj = mod.FaultInjector([mod.CorruptCheckpoint(step=0, kind=kind)],
                                seed=seed)
        inj.on_commit(0, str(d))
        inj.on_commit(1, str(d))          # fires once
        assert len(inj.events) == 1
        files[pkg] = (inj.events[0]["file"],
                      sorted((p.name, p.read_bytes()) for p in d.iterdir()))
    assert files["torch"] == files["jax"]


def test_poison_batch_sets_element_zero_out_of_place():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    y = np.arange(3, dtype=np.int32)
    jinj = jres.FaultInjector([jres.NaNStorm(step=1, duration=2)])
    inj = res.FaultInjector([res.NaNStorm(step=1, duration=2)])
    tx, ty = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    assert inj.poison_batch(0, (tx, ty)) == (tx, ty)   # before the storm
    for step in (1, 2):
        jb = jinj.poison_batch(step, (jnp.asarray(y), jnp.asarray(x)))
        b = inj.poison_batch(step, (ty, tx))
        assert b[0] is ty
        np.testing.assert_array_equal(b[1].numpy(), np.asarray(jb[1]))
        assert np.isinf(b[1][0, 0].item())
        np.testing.assert_array_equal(tx.numpy(), x)   # out of place
    assert inj.poison_batch(3, (tx,))[0] is tx          # two firings only
    assert [e["fault"] for e in inj.events] == \
        [e["fault"] for e in jinj.events]


@pytest.mark.parametrize("rec", [
    None, [], {"status": "ok"}, {"status": "", "utc": "t", "evidence": ["x"]},
    {"status": "ok", "date": "t", "incident": {"evidence": ["a", {"b": 1}]}},
    {"status": "ok", "utc": "t", "evidence": [3]},
    {"status": "ok", "utc": "t", "evidence": ["x"], "metrics": {"m": 1}},
    {"status": "ok", "utc": "t", "evidence": ["x"],
     "flight": {"capacity": 1, "dropped": 0,
                "events": [{"ts": 0, "kind": "a"}, {"ts": 1, "kind": "b"}]}},
    {"status": "ok", "utc": "t", "evidence": ["x"],
     "flight": {"capacity": 4, "dropped": -1,
                "events": [{"ts": 2, "kind": "a"}, {"ts": 1, "kind": ""}]}},
])
def test_validate_incident_matches_jax(rec):
    assert res.validate_incident(rec) == jres.validate_incident(rec)


def test_written_incidents_pass_both_validators(tmp_path):
    fr = FlightRecorder(capacity=3)
    reg = Registry()
    reg.counter("c", "a counter").inc(2)
    reg.histogram("h").observe(0.01)
    for i in range(5):
        fr.note("step", step=i)
    fr.note_metrics(reg)
    path = tmp_path / "INCIDENT_port.json"
    rec = res.write_incident(str(path), "recovered", "a drill",
                             ["evidence"], metrics=reg.snapshot(),
                             flight=fr.dump())
    assert rec["flight"]["dropped"] == 3 and len(fr) == 3
    assert res.validate_incident_file(str(path)) == []
    assert jres.validate_incident_file(str(path)) == []
    path.write_text("{")                 # a truncated record
    assert res.validate_incident_file(str(path)) == \
        jres.validate_incident_file(str(path)) != []
    with pytest.raises(ValueError, match="refusing"):
        res.make_incident("", "s", ["e"])


def test_flight_recorder_matches_jax():
    got, want = FlightRecorder(capacity=2), jax_flight.FlightRecorder(
        capacity=2)
    for fr in (got, want):
        for i in range(3):
            fr.note("step", step=i, loss=0.5)
    g, w = got.dump(), want.dump()
    for d in (g, w):
        for e in d["events"]:
            e.pop("ts")
    assert g == w
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)
    with pytest.raises(ValueError):
        got.note("")


def test_registry_snapshot_matches_jax():
    got, want = Registry(), jax_metrics.Registry()
    for reg in (got, want):
        reg.counter("steps_total", "steps").inc(3)
        reg.gauge("loss", "the loss").set(0.25)
        h = reg.histogram("step_seconds", "step wall")
        for v in (0.0002, 0.003, 0.003, 1.5, 100.0):
            h.observe(v)
    assert got.snapshot() == want.snapshot()
    fr, jfr = FlightRecorder(), jax_flight.FlightRecorder()
    fr.note_metrics(got)
    jfr.note_metrics(want)
    assert fr.dump()["events"][0]["values"] == \
        jfr.dump()["events"][0]["values"]
