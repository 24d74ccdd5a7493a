"""The continuous profiler and its drift sentinel
(``apex_tpu_torch/obs/contprof.py``) with the port's copy of the
PROFILE_DRIFT rule (``apex_tpu_torch/analysis/profile_drift.py``), held
against the JAX package: the same verdicts on the same documents, the
same confirmations and gauges on the same window sequences, and the same
integration contract in the serve engines, the router and
``run_resilient`` (``tests/l0/test_contprof.py``'s cases).

The captures here are ``torch.profiler`` windows on the CPU, bucketed from
the host ops' self times; the card's windows (device kernels, one
``trace-device`` source) run in ``chip_smoke.py``'s ``contprof`` phase.
"""

import ast
import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from apex_tpu.analysis import obs as jax_obs_schema
from apex_tpu.analysis import profile_drift as jax_pd
from apex_tpu.obs import contprof as jax_contprof
from apex_tpu.obs import metrics as jax_metrics
from apex_tpu_torch import amp, analysis
from apex_tpu_torch import resilience as res
from apex_tpu_torch.analysis import profile_drift as pd
from apex_tpu_torch.models import GPTModel, gpt_tiny
from apex_tpu_torch.models.mlp import MLP, cross_entropy_loss
from apex_tpu_torch.obs import FlightRecorder, Registry, contprof, stepclass
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import incidents as incidents_lib
from apex_tpu_torch.serve import (
    DisaggRouter,
    Request,
    RouterConfig,
    ServeConfig,
    ServeEngine,
    SpecConfig,
    SpecEngine,
    truncated_draft,
)
from apex_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
BAND = 0.05
BASE = {"fractions": {"param_read": 0.1, "kv_read": 0.6,
                      "kv_write": 0.05, "attention": 0.02,
                      "sampling": 0.15, "host_sync": 0.0,
                      "other": 0.08},
        "step_wall_s": 0.003, "source": "test"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny CPU ops here run faster on one intra-op thread than on a
    pool the test workers share; the setting is restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frac(**over):
    f = dict(BASE["fractions"])
    f.update(over)
    return f


def _windows(specs):
    """[(fractions, wall), ...] -> windows with re-derivable
    ``out_of_band`` lists (the port's rule)."""
    return [{"index": i, "fractions": fr, "step_wall_s": w,
             "out_of_band": pd.out_of_band(fr, w, BASE, BAND)}
            for i, (fr, w) in enumerate(specs)]


def _cpu(**kw):
    return contprof.ContinuousProfiler(device="cpu", **kw)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", [
    "analysis/__init__.py", "analysis/profile_drift.py",
    "obs/stepclass.py", "obs/contprof.py"])
def test_the_slices_modules_import_nothing_of_jax(module):
    """Every import of the module, at the top or inside a function: no
    ``jax`` and nothing of ``apex_tpu`` (its stdlib-only schema module
    included: the port keeps its own copy)."""
    names = list(_imports(REPO / "apex_tpu_torch" / module))
    assert names
    assert [n for n in names if n == "jax" or n.startswith("jax.")
            or n == "apex_tpu" or n.startswith("apex_tpu.")] == []
    if module == "analysis/profile_drift.py":
        assert set(names) <= {"__future__", "json", "typing"}


# ---------------------------------------------------------------------------
# the rule and the schema: the JAX package's verdicts
# ---------------------------------------------------------------------------

def test_the_rule_is_jaxs_and_the_budget_is_jaxs():
    assert pd.DEFAULT_BAND == jax_pd.DEFAULT_BAND
    assert pd.DECODE_BUCKETS == jax_pd.DECODE_BUCKETS
    assert pd.TRAIN_BUCKETS == jax_pd.TRAIN_BUCKETS
    assert analysis.CONTPROF_BUDGET_PCT == jax_obs_schema.CONTPROF_BUDGET_PCT
    rng = np.random.RandomState(0)
    for _ in range(40):
        fr = {b: round(float(v), 4) for b, v in zip(
            pd.DECODE_BUCKETS, rng.dirichlet(np.ones(7)))}
        wall = float(rng.uniform(0.0025, 0.0035))
        assert pd.out_of_band(fr, wall, BASE, BAND) == \
            jax_pd.out_of_band(fr, wall, BASE, BAND)
    runs = [[{"metric": m, "delta": float(d)} for m, d in zip(
        rng.choice(list(pd.DECODE_BUCKETS), 3), rng.uniform(-0.2, 0.2, 3))]
        for _ in range(3)]
    assert pd.confirm_bucket(runs) == jax_pd.confirm_bucket(runs)


def _valid_doc():
    clean = _windows([(_frac(kv_read=0.61), 0.003),
                      (_frac(kv_read=0.59), 0.0031)])
    drifted = _frac(kv_read=0.8, sampling=0.0)
    seeded_w = _windows([(_frac(), 0.003),
                         (drifted, 0.003), (drifted, 0.003)])
    return {
        "round": 1, "platform": "cpu", "kind": "serve-decode",
        "config": {}, "band": {"value": BAND, "source": "test"},
        "k": 2,
        "sessions": {
            "clean": {"baseline": dict(BASE), "windows": clean,
                      "drifts": [], "quiet": True},
            "seeded": {"baseline": dict(BASE), "windows": seeded_w,
                       "seed": {"bucket": "kv_read", "factor": 2.0,
                                "from_window": 1},
                       "drifts": pd.replay_sentinel(
                           seeded_w, BASE, BAND, 2),
                       "quiet": False},
        },
        "gate": {"clean_quiet": True, "seeded_caught": True,
                 "ok": True},
        "note": "test doc",
    }


def _quiet_over_out_of_band(doc):
    doc["sessions"]["seeded"]["drifts"] = []
    doc["sessions"]["seeded"]["quiet"] = True
    doc["gate"]["seeded_caught"] = False
    doc["gate"]["ok"] = False


def _invented_drift(doc):
    doc["sessions"]["clean"]["drifts"] = [
        {"window": 1, "bucket": "kv_read", "windows_out": 2}]
    doc["sessions"]["clean"]["quiet"] = False


def _lying_list(doc):
    doc["sessions"]["seeded"]["windows"][1]["out_of_band"] = []


def _dramatized(doc):
    exc = doc["sessions"]["seeded"]["windows"][1]["out_of_band"]
    exc[0]["delta"] = round(exc[0]["delta"] * 10, 4)


def _gate(doc):
    doc["gate"]["ok"] = False


def _wrong_bucket(doc):
    doc["sessions"]["seeded"]["seed"]["bucket"] = "attention"


def _k1(doc):
    doc["k"] = 1


def _unknown_bucket(doc):
    doc["sessions"]["clean"]["windows"][0]["fractions"]["flops"] = 0.1


#: the mutations of ``tests/l0/test_contprof.py`` and the problem text
#: each must raise
MUTATIONS = {
    "valid": (lambda d: None, None),
    "quiet_verdict_over_out_of_band_run": (_quiet_over_out_of_band,
                                           "replaying"),
    "invented_drift": (_invented_drift, "CONTRADICTORY"),
    "lying_out_of_band_list": (_lying_list, "derive"),
    "fabricated_excursion_numbers": (_dramatized,
                                     "re-deriving from the recorded"),
    "gate_contradiction": (_gate, "gate.ok"),
    "drift_not_naming_the_seeded_bucket": (_wrong_bucket, "name the bucket"),
    "k1": (_k1, "k must be >= 2"),
    "unknown_bucket": (_unknown_bucket, "unknown buckets"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
@pytest.mark.parametrize("source", ["built", "committed"])
def test_validator_gives_jaxs_verdict(case, source):
    """The built document of JAX's tests and the committed
    PROFILE_DRIFT_r01.json, each mutated as JAX's tests mutate: the
    port's problems are JAX's, word for word."""
    if source == "built":
        doc = _valid_doc()
    else:
        doc = json.loads((REPO / "PROFILE_DRIFT_r01.json").read_text())
        if case in ("lying_out_of_band_list",
                    "fabricated_excursion_numbers"):
            # the committed seeded lane's first out-of-band window
            w = next(i for i, x in enumerate(
                doc["sessions"]["seeded"]["windows"]) if x["out_of_band"])
            doc["sessions"]["seeded"]["windows"][1] = \
                doc["sessions"]["seeded"]["windows"][w]
            doc["sessions"]["seeded"]["windows"][1]["index"] = \
                doc["sessions"]["seeded"]["windows"][0]["index"] + 1
            doc["sessions"]["seeded"]["windows"] = \
                doc["sessions"]["seeded"]["windows"][:2]
            doc["sessions"]["seeded"]["drifts"] = jax_pd.replay_sentinel(
                doc["sessions"]["seeded"]["windows"],
                doc["sessions"]["seeded"]["baseline"],
                doc["band"]["value"], doc["k"])
    mutate, want = MUTATIONS[case]
    mutate(doc)
    got = pd.validate_profile_drift(copy.deepcopy(doc))
    assert got == jax_pd.validate_profile_drift(copy.deepcopy(doc))
    if want is None:
        assert got == []
    else:
        assert any(want in p for p in got), got


def test_committed_document_replays_and_validates_as_a_file(tmp_path):
    path = REPO / "PROFILE_DRIFT_r01.json"
    assert pd.validate_profile_drift_file(str(path)) == []
    doc = json.loads(path.read_text())
    for name, sess in doc["sessions"].items():
        assert pd.replay_sentinel(sess["windows"], sess["baseline"],
                                  doc["band"]["value"], doc["k"]) == \
            jax_pd.replay_sentinel(sess["windows"], sess["baseline"],
                                   doc["band"]["value"], doc["k"])
    bad = tmp_path / "PROFILE_DRIFT_bad.json"
    bad.write_text("{not json")
    got = pd.validate_profile_drift_file(str(bad))
    assert got == [p.replace(str(bad), str(bad)) for p in
                   jax_pd.validate_profile_drift_file(str(bad))]
    assert got and "unreadable" in got[0]


# ---------------------------------------------------------------------------
# the sentinel: the JAX package's confirmations and gauges
# ---------------------------------------------------------------------------

def _sequences():
    rng = np.random.RandomState(3)
    walk = []
    for i in range(12):
        kv = 0.6 + (0.12 if 4 <= i < 8 else rng.uniform(-0.03, 0.03))
        walk.append((_frac(kv_read=round(kv, 4)),
                     round(0.003 * rng.uniform(0.98, 1.02), 6)))
    spike = _frac(kv_read=0.7, sampling=0.05)
    return {
        # JAX's cases: a seeded drift (k 3), noise with isolated spikes,
        # a wall regression and its recovery, the numpy-seeded walk
        "seeded_drift_k3": (3, [(_frac(), 0.003)] * 2
                            + [(_frac(kv_read=0.75, sampling=0.0),
                                0.003)] * 4),
        "noise_and_isolated_spikes": (2, [
            (_frac(kv_read=0.62, sampling=0.13), 0.0031), (spike, 0.003),
            (_frac(kv_read=0.58, other=0.1), 0.0029), (spike, 0.003),
            (_frac(), 0.003)]),
        "wall_regression_then_recovery": (2, [(_frac(), 0.004)] * 2
                                          + [(_frac(), 0.003)]),
        "seeded_walk": (2, walk),
        "relapse_after_recovery": (2, [(_frac(kv_read=0.8, sampling=0.0),
                                        0.003)] * 3 + [(_frac(), 0.003)]
                                   + [(_frac(param_read=0.3, kv_read=0.4),
                                       0.003)] * 2),
    }


@pytest.mark.parametrize("case", sorted(_sequences()))
def test_sentinel_confirms_and_gauges_as_jaxs(case, tmp_path):
    k, specs = _sequences()[case]
    reg, jreg = Registry(), jax_metrics.Registry()
    sent = contprof.DriftSentinel(baseline=dict(BASE), band=BAND, k=k,
                                  registry=reg)
    jsent = jax_contprof.DriftSentinel(baseline=dict(BASE), band=BAND, k=k,
                                       registry=jreg)
    gauges, jgauges = [], []
    for w in _windows(specs):
        jw = copy.deepcopy(w)
        sent.observe(w)
        jsent.observe(jw)
        assert w["out_of_band"] == jw["out_of_band"]
        gauges.append(reg.gauge("serve_profile_drift").value)
        jgauges.append(jreg.gauge("serve_profile_drift").value)
        assert sent.drifting == jsent.drifting
    assert gauges == jgauges
    assert [(d["window"], d["bucket"], d["windows_out"])
            for d in sent.drifts] == \
        [(d["window"], d["bucket"], d["windows_out"])
         for d in jsent.drifts]
    # the online machine is the validator's replay
    assert [(d["window"], d["bucket"]) for d in sent.drifts] == \
        [(d["window"], d["bucket"])
         for d in pd.replay_sentinel(_windows(specs), BASE, BAND, k)]
    if case == "seeded_drift_k3":
        assert [(d["window"], d["bucket"]) for d in sent.drifts] == \
            [(4, "kv_read")]
    if case == "wall_regression_then_recovery":
        assert sent.drifts[0]["bucket"] == "step_wall"
        assert gauges == [0.0, 1.0, 0.0]


def test_sentinel_first_window_seeds_and_rejects_bad_settings():
    sent = contprof.DriftSentinel(baseline=None, band=BAND, k=2)
    w0 = {"index": 0, "fractions": _frac(), "step_wall_s": 0.003}
    sent.observe(w0)
    assert sent.baseline["source"] == "first-window"
    assert w0["out_of_band"] == []
    w1 = {"index": 1, "fractions": _frac(kv_read=0.8, sampling=0.0),
          "step_wall_s": 0.003}
    sent.observe(w1)
    assert [e["metric"] for e in w1["out_of_band"]] == \
        ["kv_read", "sampling"]
    with pytest.raises(ValueError, match="k="):
        contprof.DriftSentinel(k=1)
    with pytest.raises(ValueError, match="band"):
        contprof.DriftSentinel(k=2, band=1.5)


def test_confirmed_drift_writes_incident_and_flight_tail(tmp_path):
    fr = FlightRecorder(capacity=32)
    path = str(tmp_path / "drift_incident.json")
    sent = contprof.DriftSentinel(baseline=dict(BASE), band=BAND, k=2,
                                  flight=fr, incident_path=path)
    windows = _windows([(_frac(kv_read=0.8, sampling=0.0), 0.003)] * 2)
    windows[1]["top_ops"] = [
        {"op": "index_elementwise_kernel", "ps": 999, "bucket": "kv_read"},
        {"op": "elementwise_kernel", "ps": 10, "bucket": "other"}]
    for w in windows:
        sent.observe(w)
    rec = sent.incidents[0]
    assert rec["status"] == "profile-drift"
    assert "kv_read" in rec["summary"]
    assert rec["drift"]["top_ops"] == [windows[1]["top_ops"][0]]
    assert "profile_drift" in [e["kind"] for e in rec["flight"]["events"]]
    assert incidents_lib.validate_incident_file(path) == []
    obj = contprof.drift_objective()
    assert (obj.kind, obj.metric) == ("gauge", "serve_profile_drift")
    jobj = jax_contprof.drift_objective()
    assert (obj.threshold, obj.op, obj.window, obj.min_count) == \
        (jobj.threshold, jobj.op, jobj.window, jobj.min_count)
    doc = {"device_time_fractions": dict(BASE["fractions"])}
    assert contprof.baseline_from_profile(doc) == \
        jax_contprof.baseline_from_profile(doc)


# ---------------------------------------------------------------------------
# the profiler's mechanics
# ---------------------------------------------------------------------------

def test_config_checks_are_jaxs():
    for kw in (dict(capture_steps=0), dict(capture_every=2,
                                           capture_steps=2),
               dict(phase=-1)):
        with pytest.raises(ValueError):
            contprof.ContProfConfig(**kw)
        with pytest.raises(ValueError):
            jax_contprof.ContProfConfig(**kw)
    assert contprof.ContProfConfig() == contprof.ContProfConfig(
        **{f: getattr(jax_contprof.ContProfConfig(), f) for f in (
            "capture_every", "capture_steps", "warmup_steps", "phase",
            "logdir", "keep_top_ops", "max_overhead_pct", "max_windows")})


def test_a_held_capture_skips_the_window_and_counts_it():
    """A window due while another holds the process's capture is skipped
    (counted), never queued — the lock is the one ``profiler_start``
    takes, and a capture of the caller's own skips too."""
    reg = Registry()
    prof = _cpu(registry=reg, config=contprof.ContProfConfig(
        capture_every=3, capture_steps=2, warmup_steps=0))
    assert contprof._capture_lock is profiling.capture_lock
    assert contprof._capture_lock.acquire(blocking=False)
    try:
        assert prof.step_begin() is False
    finally:
        contprof._capture_lock.release()
    assert prof.skipped_windows == 1 and not prof.in_window
    assert reg.counter("serve_profile_windows_skipped_total").value == 1
    # a full interval before the next attempt; then a foreign capture
    prof._next_start = prof._step + 1
    other = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    other.start()
    try:
        assert prof.step_begin() is False
    finally:
        other.stop()
    assert prof.skipped_windows == 2
    assert not contprof._capture_lock.locked()


def test_profiler_start_and_a_window_exclude_each_other(tmp_path):
    prof = _cpu(config=contprof.ContProfConfig(capture_every=3,
                                               capture_steps=2,
                                               warmup_steps=0))
    assert prof.step_begin() is True
    try:
        with pytest.raises(RuntimeError, match="held"):
            profiling.profiler_start(str(tmp_path))
    finally:
        prof.abort_window()
    assert prof.aborted_windows == 1
    profiling.profiler_start(str(tmp_path))
    try:
        prof._next_start = prof._step + 1
        assert prof.step_begin() is False
        assert prof.skipped_windows == 1
    finally:
        profiling.profiler_stop()
    assert not contprof._capture_lock.locked()


def test_suppress_aborts_window_and_restarts_cadence():
    prof = _cpu(config=contprof.ContProfConfig(capture_every=4,
                                               capture_steps=2,
                                               warmup_steps=1))
    assert prof.step_begin() is False      # warmup
    assert prof.step_begin() is True       # a real capture opens
    assert prof.in_window and profiling.capturing()
    prof.suppress()
    assert not prof.in_window and not profiling.capturing()
    assert contprof._capture_lock.acquire(blocking=False)
    contprof._capture_lock.release()
    assert prof.step_begin() is False      # a full interval again


def test_throttle_reanchors_next_window_a_full_interval_out():
    prof = _cpu(config=contprof.ContProfConfig(
        capture_every=20, capture_steps=2, warmup_steps=0,
        max_overhead_pct=1.0))
    prof._step, prof._win_start_step, prof._next_start = 21, 20, 40
    prof._throttle({"capture_s": 0.36, "parse_s": 0.0,
                    "sentinel_s": 0.0, "stream_step_wall_s": 1.0})
    assert prof.effective_every == 36
    assert prof._next_start == 20 + 36


def test_close_path_failure_degrades_to_a_discarded_window():
    class BrokenParse(contprof.ContinuousProfiler):
        def _parse_window(self):
            raise OSError("capture dir vanished")

    reg = Registry()
    prof = BrokenParse(device="cpu", registry=reg,
                       config=contprof.ContProfConfig(
                           capture_every=4, capture_steps=1,
                           warmup_steps=0))
    assert prof.step_begin() is True
    w = prof.step_end(0.001)
    assert "parse failed" in w["discarded"]
    assert len(prof.discarded) == 1 and not prof.windows
    assert reg.counter("serve_profile_windows_discarded_total").value == 1
    assert not prof.in_window and not contprof._capture_lock.locked()
    assert prof.step_begin() is False


def test_a_cards_window_without_device_events_is_discarded(monkeypatch):
    """On a card a capture that holds no device event is discarded and
    counted, never bucketed by host times (driven here with the card's
    synchronizations stubbed and the host-only capture the CPU makes)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    prof = _cpu(registry=Registry(), config=contprof.ContProfConfig(
        capture_every=4, capture_steps=1, warmup_steps=0))
    prof.device = torch.device("cuda")
    prof.set_classifier_builder(contprof.train_classifier_builder())
    with pytest.warns(UserWarning, match="CUDA"):
        assert prof.step_begin() is True
    torch.ones(8).sum()
    w = prof.step_end(0.001)
    assert w["source"] == "trace-host"
    assert "no device event" in w["discarded"]
    assert prof.discarded == [w] and not prof.windows
    assert not contprof._capture_lock.locked()


def test_a_windows_walls_and_the_step_time_it_judges():
    """``step_wall_s`` (judged) is a captured step's attributed time;
    the host walls are recorded beside it: the captured steps' and the
    mean of the unprofiled steps since the last window (warm-up
    excluded), which the throttle budgets against."""
    prof = _cpu(buckets=contprof.TRAIN_BUCKETS, name="train",
                classifier_builder=contprof.train_classifier_builder(),
                config=contprof.ContProfConfig(
                    capture_every=3, capture_steps=1, warmup_steps=1,
                    max_overhead_pct=None))
    opened = []
    for wall in (9.0, 0.2, 0.4, 0.6, 0.1, 0.3, 0.8):
        opened.append(prof.step_begin())
        torch.ones(64, 64).matmul(torch.ones(64, 64))
        prof.step_end(wall)
    assert opened == [False, True, False, False, True, False, False]
    first, second = prof.windows
    assert (first["host_step_wall_s"], first["stream_steps"],
            first["stream_step_wall_s"]) == (0.2, 0, None)
    assert (second["host_step_wall_s"], second["stream_steps"]) == (0.1, 2)
    assert second["stream_step_wall_s"] == pytest.approx(0.5)
    for w in (first, second):
        assert w["step_wall_s"] == pytest.approx(
            w["attributed_ps"] / 1e12, abs=1e-6)
        assert 0 < w["step_wall_s"] < w["host_step_wall_s"]


def test_the_train_builder_holds_no_step_and_is_built_once():
    builder = contprof.train_classifier_builder()
    assert builder.__closure__ is None or all(
        not isinstance(c.cell_contents, torch.Tensor)
        for c in builder.__closure__)
    prof = _cpu(buckets=contprof.TRAIN_BUCKETS, classifier_builder=builder)
    assert isinstance(prof._classifier(), stepclass.TrainStepClassifier)
    assert prof._builder is None and prof.has_classifier_builder


# ---------------------------------------------------------------------------
# a profiled serve session on the CPU
# ---------------------------------------------------------------------------

SCFG = ServeConfig(num_slots=2, block_size=16, num_blocks=17,
                   max_blocks_per_slot=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return GPTModel(gpt_tiny(), device="cpu")


def _requests(n, new, seed=0):
    rng = np.random.RandomState(seed)
    return [Request(uid=f"s{i}",
                    prompt=rng.randint(0, gpt_tiny().vocab_size, (8,)),
                    max_new_tokens=new) for i in range(n)]


@pytest.fixture(scope="module")
def profiled_session(model):
    reg = Registry()
    eng = ServeEngine(model, gpt_tiny(), SCFG, registry=reg, device="cpu")
    sent = contprof.DriftSentinel(band=0.25, k=2, registry=reg)
    prof = contprof.serve_profiler(eng, sentinel=sent,
                                   config=contprof.ContProfConfig(
                                       capture_every=5, capture_steps=2,
                                       warmup_steps=2, max_windows=2,
                                       max_overhead_pct=None))
    for r in _requests(2, 11):
        eng.submit(r)
    steps = 0
    while not eng.sched.idle() and steps < 40:
        eng.step()
        steps += 1
    prof.abort_window()
    return eng, prof, sent, reg, steps


def test_capture_windows_parse_and_classify(profiled_session):
    eng, prof, _sent, _reg, _steps = profiled_session
    assert eng.profiler is prof and prof.scope == "contprof/engine"
    assert len(prof.windows) == 2 and not prof.discarded
    for w in prof.windows:
        assert w["source"] == "trace-host" and w["total_ps"] > 0
        assert w["matched_frac"] > 0.3
        assert w["fractions"]["kv_read"] > 0.0
        assert set(w["fractions"]) == set(contprof.DECODE_BUCKETS)
        assert abs(sum(w["fractions"].values()) - 1.0) < 1e-9
        assert w["top_ops"] and w["attributed_ps"] <= w["total_ps"]


def test_profiled_steps_excluded_from_latency_histogram(profiled_session):
    _eng, prof, _sent, reg, steps = profiled_session
    gated = reg.histogram("serve_decode_step_seconds").count
    profiled = reg.histogram("serve_profiled_step_seconds").count
    captured = sum(w["steps"] for w in prof.windows + prof.discarded)
    assert profiled == captured == 4
    assert gated + profiled == steps
    assert reg.counter("serve_profile_windows_total").value == 2


def test_sentinel_saw_session_windows(profiled_session):
    _eng, prof, sent, _reg, _steps = profiled_session
    assert sent.baseline["source"] == "first-window"
    replay = pd.replay_sentinel(prof.windows, sent.baseline, sent.band,
                                sent.k)
    assert [(d["window"], d["bucket"]) for d in sent.drifts] == \
        [(d["window"], d["bucket"]) for d in replay]


def test_admission_and_failure_inside_a_window(model):
    """An admission's prefill inside a window discards it; a step that
    raises inside a window aborts it and releases the capture; ``run()``
    leaves no window open."""
    eng = ServeEngine(model, gpt_tiny(), SCFG, registry=Registry(),
                      device="cpu")
    prof = contprof.serve_profiler(eng, config=contprof.ContProfConfig(
        capture_every=3, capture_steps=2, warmup_steps=1,
        max_overhead_pct=None))
    first, late = _requests(2, 6)
    eng.submit(first)
    eng.step()                    # admission + warm-up step
    eng.step()                    # the window opens
    assert prof.in_window
    eng.submit(late)
    eng.step()                    # admits inside the window, closes it
    assert len(prof.discarded) == 1 and "admission" in \
        prof.discarded[0]["discarded"]
    prof._next_start = prof._step + 1

    def boom():
        raise RuntimeError("device lost")

    eng._decode, saved = boom, eng._decode
    with pytest.raises(RuntimeError, match="device lost"):
        eng.step()
    eng._decode = saved
    assert not prof.in_window and prof.aborted_windows == 1
    assert not contprof._capture_lock.locked()
    eng.run()
    assert not prof.in_window and not contprof._capture_lock.locked()


def test_a_speculative_round_is_profiled_with_the_draft_in_other(model):
    cfg = gpt_tiny()
    draft, dcfg = truncated_draft(model, cfg, 1)
    reg = Registry()
    eng = SpecEngine(model, cfg, SCFG, draft, dcfg, SpecConfig(k=2),
                     registry=reg, device="cpu")
    prof = contprof.serve_profiler(eng, config=contprof.ContProfConfig(
        capture_every=3, capture_steps=2, warmup_steps=1, max_windows=1,
        max_overhead_pct=None))
    for r in _requests(1, 10, seed=1):
        eng.submit(r)
    eng.run()
    assert len(prof.windows) == 1
    w = prof.windows[0]
    assert w["fractions"]["kv_read"] > 0 and w["fractions"]["other"] > 0
    clf = prof._clf
    draft_keys = [k for k in clf.buckets if "serve/spec_draft" in k.scopes]
    assert draft_keys and all(clf(k) is None for k in draft_keys)
    assert reg.histogram("serve_profiled_step_seconds").count == 2


# ---------------------------------------------------------------------------
# the router (JAX's wiring test) and a profiled fleet
# ---------------------------------------------------------------------------

RCFG_SCFG = ServeConfig(num_slots=2, block_size=4, num_blocks=9,
                        max_blocks_per_slot=4, prefill_chunk=4)


def test_router_contprof_wiring_and_drift_deranking(model):
    rcfg = RouterConfig(
        n_decode_replicas=2, transfer="recompute",
        contprof=contprof.ContProfConfig(capture_every=10_000,
                                         capture_steps=2))
    assert (rcfg.contprof_band, rcfg.contprof_k) == (0.03, 2)
    router = DisaggRouter(model, gpt_tiny(), RCFG_SCFG, rcfg,
                          devices=["cpu"] * 3, registry=Registry())
    assert len(router.profilers) == 2
    # staggered phases: JAX's stride
    assert [p.config.phase for p in router.profilers] == [0, 5000]
    assert [p.scope for p in router.profilers] == \
        ["contprof/replica0", "contprof/replica1"]
    for rep in router.replicas:
        assert "serve_profile_drift" in rep.eng.metrics._instruments
    router.sentinels[0]._active = True
    req = Request(uid="r", prompt=np.zeros(4, np.int64), max_new_tokens=4)
    assert router._pick_replica(req) is router.replicas[1]
    router._record_metrics()
    assert router.metrics.gauge("serve_replica0_profile_drift").value == 1.0
    router.sentinels[1]._active = True
    assert router._pick_replica(req) is not None
    p0 = router.profilers[0]
    p0._next_start = 2
    assert p0.step_begin() is False      # warmup
    assert p0.step_begin() is True       # a real capture opens
    router.kill_replica(0)
    assert not p0.in_window and p0.aborted_windows == 1
    assert not contprof._capture_lock.locked()


def test_a_profiled_fleet_streams_what_the_plain_fleet_streams(model):
    reqs = _requests(2, 8, seed=2)

    def run(rcfg):
        router = DisaggRouter(model, gpt_tiny(), RCFG_SCFG, rcfg,
                              devices=["cpu"] * 3, registry=Registry(),
                              flight=FlightRecorder())
        for r in reqs:
            router.submit(Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens))
        return router.run(), router

    plain, _ = run(RouterConfig())
    # stride 3: replica 0's windows at steps 2-3, replica 1's at 5-6
    got, router = run(RouterConfig(
        contprof=contprof.ContProfConfig(capture_every=6, capture_steps=2,
                                         max_overhead_pct=None),
        contprof_band=0.5))
    assert set(got) == set(plain)
    assert all(np.array_equal(got[u], plain[u]) for u in plain)
    assert all(p.windows and not p.discarded for p in router.profilers)
    assert all(p.skipped_windows == 0 for p in router.profilers)
    assert not contprof._capture_lock.locked()


# ---------------------------------------------------------------------------
# run_resilient (JAX's train-profiler test, and a rewind)
# ---------------------------------------------------------------------------

def _workload():
    torch.manual_seed(0)
    model = MLP((32, 32), in_features=16, device="cpu")
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level="O2", device="cpu",
                       min_loss_scale=2.0 ** 14)
    step = amp.make_train_step(
        a, model, lambda m, x, y: cross_entropy_loss(m(x), y))
    x, y = torch.randn(16, 16), torch.randint(0, 10, (16,))
    return a, step, (lambda i: (x, y))


def test_run_resilient_with_train_profiler():
    a, step, batch = _workload()
    reg = Registry()
    sent = contprof.DriftSentinel(band=0.5, k=2, name="train",
                                  registry=reg)
    prof = contprof.train_profiler(
        config=contprof.ContProfConfig(capture_every=4, capture_steps=2,
                                       warmup_steps=2, max_windows=1,
                                       max_overhead_pct=None),
        sentinel=sent, registry=reg, device="cpu")
    result = res.run_resilient(step, a, batch, 10,
                               config=res.ResilienceConfig(
                                   watchdog_timeout_s=120.0),
                               registry=reg, profiler=prof)
    assert result.steps_completed == 10 and len(prof.windows) == 1
    w = prof.windows[0]
    assert set(w["fractions"]) == set(stepclass.TRAIN_BUCKETS)
    assert all(w["fractions"][b] > 0 for b in ("fwd", "bwd", "optimizer"))
    assert abs(sum(w["fractions"].values()) - 1.0) < 1e-9
    assert prof.scope == "contprof/train" and prof.has_classifier_builder
    assert reg.counter("train_profile_windows_total").value == 1
    assert not prof.in_window and not contprof._capture_lock.locked()


def test_a_rewind_suppresses_the_open_window():
    """JAX's storm (poisoned from step 5, patience 3): resolving step 8
    rewinds to the snapshot of step 8 while the window opened at step 9
    (the 10th dispatch) is open; the rewind aborts it, and the cadence
    restarts a full interval later (the 18th dispatch)."""
    a, step, batch = _workload()
    prof = contprof.train_profiler(
        config=contprof.ContProfConfig(capture_every=8, capture_steps=2,
                                       warmup_steps=1,
                                       max_overhead_pct=None),
        device="cpu")
    inj = res.FaultInjector([res.NaNStorm(step=5, duration=6)])
    result = res.run_resilient(
        step, a, batch, 18,
        config=res.ResilienceConfig(checkpoint_every=3, overflow_patience=3,
                                    max_rewinds=2, watchdog_timeout_s=120.0),
        injector=inj, registry=Registry(), profiler=prof)
    assert result.rewinds == 1
    assert [e["to_step"] for e in result.events
            if e["event"] == "rewind"] == [8]
    assert [w["start_step"] for w in prof.windows] == [2, 18]
    assert prof.aborted_windows == 1
    assert not prof.in_window and not contprof._capture_lock.locked()
