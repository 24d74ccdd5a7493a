"""The port's lagged metrics registry, ``instrument_step``, the fleet
merges, the HTTP exposition and the trace parser
(``apex_tpu_torch/obs/{metrics,fleet,exposition,xplane}.py``) against
the JAX package's (``apex_tpu/obs/``), on the same recorded sequences
made from a numpy seed: the resolved state, ``snapshot()`` and the
Prometheus text are equal, line for line; the lag contract
(``pending_groups`` after each tick) is the same.  The trace parser
reads a real CPU ``torch.profiler`` capture of a tiny train step.
"""

import json
import math
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.obs import fleet as jfleet
from apex_tpu.obs import metrics as jmetrics
from apex_tpu.obs import xplane as jxplane
from apex_tpu_torch import obs
from apex_tpu_torch.obs import exposition, fleet, metrics, xplane
from apex_tpu_torch.obs.metrics import HostCopy, Registry, instrument_step


def _record(reg, kind, seed=0):
    """One recorded sequence, made from ``seed``: host numbers, and
    device values (torch tensors on the port, jax arrays on JAX) with a
    tick a step."""
    rng = np.random.default_rng(seed)
    as_dev = torch.tensor if kind == "port" else jnp.asarray
    lat = reg.histogram("serve_decode_step_seconds", "step latency")
    toks = reg.counter("serve_tokens_total", "tokens")
    loss = reg.gauge("train_loss", "loss")
    over = reg.counter("train_overflows_total")
    for step in range(12):
        lat.observe(float(rng.uniform(1e-4, 0.3)))
        toks.inc(int(rng.integers(1, 9)))
        loss.set(as_dev(np.float32(rng.normal())))
        over.inc(as_dev(bool(step % 5 == 0)))
        lat.observe(as_dev(rng.uniform(1e-3, 2.0, size=3)
                           .astype(np.float32)))
        reg.tick()
    reg.gauge("serve_kv_block_utilization").set(0.625)
    reg.counter("serve_requests_total").inc(16)
    return reg


def test_lagged_state_and_exports_equal_jaxs():
    port, jax_ = Registry(), jmetrics.Registry()
    pend = []
    for reg, kind in ((port, "port"), (jax_, "jax")):
        _record(reg, kind)
        pend.append(reg.pending_groups)
    assert pend[0] == pend[1] == 12 - 8   # resolved in one batch of 8
    assert port.snapshot() == jax_.snapshot()
    assert port.to_prometheus() == jax_.to_prometheus()
    port.flush(), jax_.flush()
    assert port.pending_groups == jax_.pending_groups == 0
    assert port.snapshot() == jax_.snapshot()
    assert port.to_prometheus() == jax_.to_prometheus()
    text = port.to_prometheus()
    assert 'serve_decode_step_seconds_bucket{le="+Inf"} 48' in text
    assert "# TYPE train_overflows_total counter" in text


@pytest.mark.parametrize("lag,every", [(0, 1), (1, 1), (1, 8), (2, 3)])
def test_pending_groups_follow_jaxs_lag_contract(lag, every):
    port = Registry(lag=lag, resolve_every=every)
    jax_ = jmetrics.Registry(lag=lag, resolve_every=every)
    got, want = [], []
    for i in range(10):
        port.counter("n").inc(torch.tensor(float(i)))
        jax_.counter("n").inc(jnp.float32(i))
        port.tick(), jax_.tick()
        got.append((port.pending_groups, port.counter("n").value))
        want.append((jax_.pending_groups, jax_.counter("n").value))
    assert got == want


def test_discard_reset_and_the_default_registry():
    reg = Registry(lag=1, resolve_every=1)
    c = reg.counter("n")
    c.inc(torch.tensor(5.0))
    reg.discard_pending()
    reg.flush()
    assert c.value == 0.0
    reg.reset()
    assert reg.snapshot() == {"metrics": []}
    assert metrics.get_registry() is metrics.DEFAULT
    name = "test_torch_obs_metrics_default_total"
    assert metrics.counter(name) is metrics.DEFAULT.counter(name)
    assert metrics.gauge(name + "_g") is metrics.DEFAULT.gauge(name + "_g")
    assert metrics.histogram(name + "_h").bounds == metrics.LATENCY_BUCKETS
    with pytest.raises(TypeError, match="already registered"):
        metrics.gauge(name)
    with pytest.raises(ValueError):
        Registry(lag=-1)


def test_recording_while_compiling_raises(monkeypatch):
    reg = Registry()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with pytest.raises(TypeError, match="step OUTPUTS"):
        reg.gauge("x").set(torch.tensor(1.0))
    reg.gauge("x").set(1.0)               # a host number is fine


def test_host_copy_keeps_order_dtypes_and_whole_arrays():
    ts = [torch.tensor(2.5), torch.tensor(True), torch.tensor(7, dtype=
          torch.int32), torch.arange(4, dtype=torch.bfloat16),
          torch.tensor([1.0, 2.0], dtype=torch.float64)]
    out = HostCopy(ts).result()
    assert [np.asarray(v).dtype.kind for v in out] == \
        ["f", "f", "i", "f", "f"]
    assert [np.asarray(v).tolist() for v in out] == \
        [2.5, 1.0, 7, [0.0, 1.0, 2.0, 3.0], [1.0, 2.0]]
    src = torch.tensor(1.0)
    copy = HostCopy([src])
    src.add_(1.0)                          # a later in-place step
    assert copy.result()[0] == 1.0


# -- instrument_step ---------------------------------------------------------

def test_instrument_step_wraps_and_lags():
    """The port's ``step(*batch) -> metrics`` and JAX's form."""
    reg = Registry()
    calls = []

    def step(x):
        calls.append(x)
        return {"loss": torch.tensor(0.5), "overflow": torch.tensor(False)}

    wrapped = instrument_step(step, registry=reg)
    for i in range(3):
        m = wrapped(i)
    assert len(calls) == 3 and set(m) == {"loss", "overflow"}
    assert reg.counter("train_steps_total").value == 3.0
    assert reg.histogram("train_step_dispatch_seconds").count == 3
    assert reg.gauge("train_loss").value == 0.0      # not resolved yet
    assert reg.pending_groups == 3
    reg.flush()
    assert reg.gauge("train_loss").value == 0.5
    assert reg.counter("train_overflows_total").value == 0.0

    reg2 = Registry()
    jstate = instrument_step(
        lambda s, x: (s + 1, {"loss": torch.tensor(0.25),
                              "overflow": (torch.tensor(True),
                                           torch.tensor(True))}),
        registry=reg2)
    s = 0
    for i in range(3):
        s, _ = jstate(s, i)
    reg2.flush()
    assert s == 3 and reg2.gauge("train_loss").value == 0.25
    assert reg2.counter("train_overflows_total").value == 6.0


def test_instrument_step_fp8_gauges_equal_jaxs():
    regs = (Registry(), jmetrics.Registry())
    for reg, dev in zip(regs, (torch.tensor, jnp.asarray)):
        wrapped = (instrument_step if reg is regs[0]
                   else jmetrics.instrument_step)(
            lambda s, x: (s + 1, {
                "loss": dev(np.float32(0.1)), "overflow": dev(False),
                "fp8_amax_saturation": dev(np.float32(0.97)),
                "fp8_rescales": dev(np.int32(2))}), registry=reg)
        s = 0
        for i in range(3):
            s, _ = wrapped(s, i)
        reg.flush()
    port, jax_ = (r.snapshot()["metrics"] for r in regs)
    drop = {"train_step_dispatch_seconds"}    # wall times differ
    assert [m for m in port if m["name"] not in drop] == \
        [m for m in jax_ if m["name"] not in drop]
    assert regs[0].gauge("train_fp8_amax_saturation").value == \
        float(np.float32(0.97))
    assert regs[0].counter("train_fp8_rescales_total").value == 6.0


# -- fleet merges and the exposition -----------------------------------------

def _fleet(kind):
    mod = metrics if kind == "port" else jmetrics
    regs = []
    for seed in range(3):
        reg = _record(mod.Registry(), kind, seed)
        reg.flush()
        reg.gauge("serve_active_slots").set(float(seed * 2))
        regs.append(reg)
    return regs


def test_fleet_merges_equal_jaxs():
    port, jax_ = _fleet("port"), _fleet("jax")
    for q in (0.5, 0.9, 0.99):
        pairs = [(r.histogram("serve_decode_step_seconds"), None)
                 for r in port]
        jpairs = [(r.histogram("serve_decode_step_seconds"), None)
                  for r in jax_]
        assert fleet.merged_quantile(pairs, q) == \
            jfleet.merged_quantile(jpairs, q)
    marks = [r.histogram("serve_decode_step_seconds").state() for r in port]
    for r in port:
        r.histogram("serve_decode_step_seconds").observe(0.05)
    windowed = fleet.merged_quantile(
        [(r.histogram("serve_decode_step_seconds"), m)
         for r, m in zip(port, marks)], 0.5)
    assert 0.025 < windowed <= 0.05 + 1e-12
    for r in jax_:
        r.histogram("serve_decode_step_seconds").observe(0.05)
    assert fleet.merge_registries(port).to_prometheus() == \
        jfleet.merge_registries(jax_).to_prometheus()
    labels = ["prefill", "replica0", "replica1"]
    assert fleet.gauge_table(port, labels) == \
        jfleet.gauge_table(jax_, labels)
    assert fleet.counter_sum(port, "serve_tokens_total") == \
        jfleet.counter_sum(jax_, "serve_tokens_total")
    with pytest.raises(ValueError, match="different bucket"):
        fleet.merge_histograms([
            (port[0].histogram("serve_decode_step_seconds"), None),
            (Registry().histogram("h", buckets=(1.0, 2.0)), None)])


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_metrics_server_scrape_equals_the_registry():
    port = _fleet("port")
    srv = exposition.MetricsServer(
        registry=port[0],
        fleet_registries=dict(zip(["prefill", "replica0", "replica1"],
                                  port)))
    host, p = srv.start()
    try:
        assert host == "127.0.0.1" and p > 0
        base = f"http://{host}:{p}"
        assert _get(base + "/metrics") == (200, port[0].to_prometheus())
        status, text = _get(base + "/fleet")
        assert status == 200
        assert text.startswith(fleet.merge_registries(port).to_prometheus())
        rows = [json.loads(line[len("# gauge-table "):])
                for line in text.splitlines()
                if line.startswith("# gauge-table ")]
        assert {k: v for row in rows for k, v in row.items()} == \
            fleet.gauge_table(port, ["prefill", "replica0", "replica1"])
        assert _get(base + "/healthz") == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/nope")
        with pytest.raises(RuntimeError, match="already started"):
            srv.start()
    finally:
        srv.stop()
    alone = exposition.MetricsServer()
    assert alone.registry is metrics.DEFAULT
    assert alone.fleet_text() == "# no fleet registries attached\n"


# -- the trace parser --------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A CPU ``torch.profiler`` capture of two steps of a tiny MLP (a
    schedule records the ``ProfilerStep#N`` spans)."""
    from torch.profiler import (ProfilerActivity, profile, schedule,
                                tensorboard_trace_handler)
    d = tmp_path_factory.mktemp("trace")
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                                torch.nn.Linear(32, 16))
    x = torch.randn(8, 16, generator=gen)
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1),
                 on_trace_ready=tensorboard_trace_handler(str(d))) as prof:
        for _ in range(3):
            model(x).square().mean().backward()
            prof.step()
    return str(d), prof.key_averages()


def test_trace_parser_reads_a_cpu_capture(capture):
    d, averages = capture
    t = xplane.op_times(d)
    assert t.source == "trace-host"      # no device events on the CPU
    # each op's self time: the sum is the profiler's own (in us)
    want_us = sum(e.self_cpu_time_total for e in averages
                  if not e.key.startswith("ProfilerStep"))
    assert t.total_ps == pytest.approx(want_us * 1e6, rel=1e-6)
    assert set(t.by_category) == {"cpu_op"}
    assert "aten::addmm" in t.by_op and all(v >= 0 for v in
                                            t.by_op.values())
    by_name, by_cat, total = xplane.parse_xplane(d)
    assert (by_name, by_cat, total) == (t.by_op, t.by_category, t.total_ps)
    marks = xplane.step_markers(d)
    assert [m["name"] for m in marks] == ["ProfilerStep#1",
                                          "ProfilerStep#2"]
    assert marks[0]["start_ps"] < marks[1]["start_ps"]
    assert all(m["duration_ps"] > 0 for m in marks)


def test_trace_parser_counts_device_events_only(tmp_path):
    """A capture with kernels: the device events, not the host ops nor
    the device-side annotations, make the total."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 2.5},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 1.25},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 0.5},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
         "ts": 10, "dur": 40.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#4",
         "ts": 0, "dur": 60.0}]
    import gzip
    with gzip.open(tmp_path / "w.1.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    t = xplane.op_times(str(tmp_path))
    assert t.source == "trace-device"
    assert t.total_ps == 4_250_000
    assert dict(t.by_op) == {"gemm": 3_750_000, "Memcpy HtoD": 500_000}
    assert dict(t.by_category) == {"kernel": 3_750_000,
                                   "gpu_memcpy": 500_000}
    assert xplane.step_markers(str(tmp_path / "w.1.pt.trace.json.gz")) == \
        [{"name": "ProfilerStep#4", "start_ps": 0,
          "duration_ps": 60_000_000}]


def test_bucket_op_times_equals_jaxs(capture):
    table = dict(xplane.op_times(capture[0]).by_op)
    table["nothing"] = 0

    def classify(name):
        return ("matmul" if "mm" in name else
                "act" if "gelu" in name else None)

    for buckets in (None, ["matmul", "act", "norm"], ["matmul"]):
        assert xplane.bucket_op_times(table, classify, buckets) == \
            jxplane.bucket_op_times(table, classify, buckets)


def test_obs_exports_jaxs_names_but_contprof_and_stepclass():
    """Every name the JAX package's ``obs`` exports or imports at its top
    level resolves in the port's, ``contprof`` and ``stepclass`` among
    them since they were ported (the name is the test's from before)."""
    from apex_tpu import obs as jobs
    want = set(jobs.__all__) | {"MetricsServer", "exposition", "contprof",
                                "stepclass", "ContinuousProfiler",
                                "ContProfConfig", "DriftSentinel",
                                "serve_profiler", "train_profiler"}
    missing = {n for n in want if not hasattr(obs, n)}
    assert missing == set()
    assert {"contprof", "stepclass"} <= set(obs.__all__)
    assert obs.stepclass.TRAIN_BUCKETS == jobs.stepclass.TRAIN_BUCKETS
    assert obs.contprof.ContProfConfig().capture_every == \
        jobs.contprof.ContProfConfig().capture_every
    assert math.isnan(Registry().histogram("h").quantile(0.5))
