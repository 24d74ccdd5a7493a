"""The port's observability base against the JAX package's, on the CPU:
``utils`` (profiling, logging), ``obs/spans.py``, ``Histogram.state()`` /
``quantile(since=)``, ``obs/reqtrace.py`` and ``obs/slo.py`` fed the same
observations and events in both packages; then the serve engine's tracer
records and spans.  Everything here is host bookkeeping, so results are
compared exactly (timestamps aside)."""

import json
import math
import threading

import numpy as np
import pytest
import torch

import apex_tpu.obs.reqtrace as jax_reqtrace
import apex_tpu.obs.slo as jax_slo
import apex_tpu.obs.spans as jax_spans
import apex_tpu.utils as jax_utils
from apex_tpu.obs.metrics import Registry as JaxRegistry
from apex_tpu_torch import utils
from apex_tpu_torch.models import GPTModel, gpt_tiny
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.obs import Registry, reqtrace, slo, spans
from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
from apex_tpu_torch.utils import logging as ulog


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_utils_names_are_jaxs():
    assert utils.__all__ == jax_utils.__all__
    assert all(callable(getattr(utils, n)) for n in utils.__all__)


def test_ranges_and_annotate_land_in_a_profiler_trace(tmp_path):
    @utils.annotate("outer_fn")
    def f(x):
        return x + 1

    assert f.__name__ == "f"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with utils.nvtx_range("region_a"):
            f(torch.ones(2))
        utils.range_push("region_b")
        torch.ones(2) * 2
        utils.range_pop()
        utils.range_pop()                 # an unmatched pop is a no-op
    names = {e.name for e in prof.events()}
    assert {"region_a", "outer_fn", "region_b"} <= names
    utils.profiler_start(str(tmp_path))
    utils.profiler_start(str(tmp_path))   # a second start is a no-op
    torch.ones(4).sum()
    utils.profiler_stop()
    utils.profiler_stop()
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_maybe_print_and_warn_or_err(capsys):
    try:
        ulog.set_verbosity(1)
        utils.maybe_print("shown")
        utils.maybe_print("hidden", min_verbosity=2)
        ulog.set_verbosity(0)
        utils.maybe_print("hidden too")
    finally:
        ulog.set_verbosity(1)
    assert capsys.readouterr().out == "shown\n"
    utils.warn_or_err(True, "never")
    with pytest.warns(UserWarning, match="policy"):
        utils.warn_or_err(False, "policy")
    with pytest.raises(RuntimeError, match="policy"):
        utils.warn_or_err(False, "policy", strict=True)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _drive_spans(mod, reg):
    paths = []
    with mod.span("serve", registry=reg):
        paths.append(mod.current_path())
        for _ in range(3):
            with mod.span("decode_step", registry=reg):
                paths.append(mod.current_path())
        with mod.span("x.y z", registry=reg, record=False):
            paths.append(mod.current_path())

    @mod.traced_span("train/step", registry=reg)
    def step():
        paths.append(mod.current_path())
        return 5

    assert step() == 5 and step.__name__ == "step"
    paths.append(mod.current_path())
    return paths


def test_spans_nest_name_and_time_as_jaxs():
    reg, jreg = Registry(), JaxRegistry()
    paths = _drive_spans(spans, reg)
    assert paths == _drive_spans(jax_spans, jreg)
    assert paths[-1] == ""
    names = sorted(reg._instruments)
    assert names == sorted(jreg._instruments)
    assert names == ["span_seconds__serve", "span_seconds__serve_decode_step",
                     "span_seconds__train_step"]
    for n in names:
        h, jh = reg.histogram(n), jreg.histogram(n)
        assert h.count == jh.count and h.bounds == jh.bounds
        assert h.sum > 0
    assert reg.histogram("span_seconds__serve_decode_step").count == 3
    for p in ("serve/decode_step", "a.b-c d", "x"):
        assert spans.metric_name(p) == jax_spans.metric_name(p)


def test_span_stacks_are_per_thread():
    seen = {}

    def worker():
        seen["inner"] = spans.current_path()

    with spans.span("outer", registry=Registry()):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert spans.current_path() == "outer"
    assert seen["inner"] == ""


# ---------------------------------------------------------------------------
# Histogram windows
# ---------------------------------------------------------------------------

def test_histogram_state_and_windowed_quantile_match_jax():
    rng = np.random.RandomState(0)
    reg, jreg = Registry(), JaxRegistry()
    h, jh = reg.histogram("lat"), jreg.histogram("lat")
    first = [50.0] + list(rng.uniform(1e-4, 0.05, 40))   # a warm-up outlier
    for v in first:
        h.observe(v)
        jh.observe(v)
    mark, jmark = h.state(), jh.state()
    assert np.array_equal(mark[0], jmark[0]) and mark[1:] == jmark[1:]
    second = list(rng.uniform(1e-4, 0.2, 60)) + [30.0, 40.0]
    for i, v in enumerate(second):
        h.observe(v)
        jh.observe(v)
        if i in (0, 30):
            mark2, jmark2 = h.state(), jh.state()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
        assert h.quantile(q, since=mark) == jh.quantile(q, since=jmark)
        assert h.quantile(q, since=mark2) == jh.quantile(q, since=jmark2)
    # a window that did not set the running max interpolates its
    # overflow bucket to the last finite bound, not toward 50.0
    h3, jh3 = reg.histogram("l3"), jreg.histogram("l3")
    for v in (100.0, 0.001):
        h3.observe(v)
        jh3.observe(v)
    m3, jm3 = h3.state(), jh3.state()
    for v in (60.0, 0.002):
        h3.observe(v)
        jh3.observe(v)
    assert h3.quantile(0.99, since=m3) == jh3.quantile(0.99, since=jm3) \
        == h3.bounds[-1]
    empty = h3.state()
    assert math.isnan(h3.quantile(0.5, since=empty))
    with pytest.raises(ValueError, match="outside"):
        h.quantile(1.5, since=mark)


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------

EVENTS = [
    ("enqueue", "a", "router", dict(queue_depth=1)),
    ("enqueue", "b", "router", dict(queue_depth=2)),
    ("prefill_chunk", "a", "prefill", dict(start=0, n_valid=4)),
    ("admit", "a", "prefill", dict(slot=0, first_token=3, prompt_len=4,
                                   tokens=1)),
    ("kv_ship", "a", "router", dict(to_replica=1, nbytes=64)),
    ("kv_install", "a", "replica1", dict(slot=0)),
    ("decode_step", "a", "replica1", dict(step=1, token=5, batch=1,
                                          tokens=1)),
    ("spec_draft", "b", "replica0", dict(step=1, proposed=3)),
    ("spec_verify", "b", "replica0", dict(step=1, accepted=2, tokens=3)),
    ("preempt", "b", "replica0", dict(slot=1)),
    ("reroute", "a", "router", dict(from_replica=1)),
    ("decode_step", "a", "replica0", dict(step=4, token=6, batch=2,
                                          tokens=1)),
    ("retire", "a", "replica0", dict(tokens_out=3)),
]


def _feed(mod, tracer_kw=None):
    tr = mod.RequestTracer(**(tracer_kw or {}))
    assert tr.mint("a") == tr.mint("a") == "t00001"
    for kind, uid, where, data in EVENTS:
        tr.record(kind, uid, where, **dict(data))
    return tr


def _no_time(doc):
    out = {}
    for uid, rec in doc.items():
        out[uid] = dict(rec, events=[{k: v for k, v in e.items()
                                      if k != "ts"} for e in rec["events"]],
                        spans=[{k: v for k, v in s.items()
                                if k not in ("t0", "t1")}
                               for s in rec["spans"]])
    return out


def test_tracer_documents_match_jaxs():
    tr, jtr = _feed(reqtrace), _feed(jax_reqtrace)
    assert _no_time(tr.to_doc_requests()) == _no_time(jtr.to_doc_requests())
    assert tr.tokens_of("a") == jtr.tokens_of("a") == 3
    assert tr.tokens_of("b") == 3 and tr.uids() == jtr.uids()
    assert tr.events("zz") == [] and tr.to_doc_requests()["a"]["spans"][
        1]["where"] == "router"
    # the same events give the same span tree and chrome export
    events = jtr.events("a")
    assert reqtrace.spans_of_events(events) == \
        jax_reqtrace.spans_of_events(events)
    assert reqtrace.spans_of_events([]) == []

    class Fixed(reqtrace.RequestTracer):
        def to_doc_requests(self):
            return jtr.to_doc_requests()

    assert Fixed().to_chrome_trace() == jtr.to_chrome_trace()
    with pytest.raises(ValueError, match="vocabulary"):
        tr.record("decode", "a", "engine")
    # the JAX vocabulary, then the kinds JAX's engine and router record
    assert reqtrace.EVENT_KINDS == jax_reqtrace.EVENT_KINDS + (
        "cow_fork", "prefix_hit", "prefix_direct")
    assert reqtrace.TOKEN_KINDS == jax_reqtrace.TOKEN_KINDS


def test_tracer_bounds_match_jaxs():
    for kw in (dict(max_retired=1), dict(max_retired=2)):
        tr, jtr = _feed(reqtrace, kw), _feed(jax_reqtrace, kw)
        for i in range(5):
            for t in (tr, jtr):
                t.record("enqueue", f"u{i}", "router")
                if i % 2:
                    t.record("retire", f"u{i}", "engine", tokens_out=0)
        assert tr.uids() == jtr.uids() and tr.dropped == jtr.dropped > 0
    with pytest.raises(ValueError, match="max_retired"):
        reqtrace.RequestTracer(max_retired=0)


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

def _objectives(mod):
    o = mod.SLObjective
    return (o(name="p99", kind="quantile", metric="lat", q=0.9,
              threshold=0.0128, window=4, min_count=5),
            o(name="p_snap", kind="quantile", metric="lat", q=0.99,
              threshold=0.25, window=2, min_count=1),
            o(name="p_all", kind="quantile", metric="lat", q=0.5,
              threshold=0.01, window=0, min_count=1),
            o(name="util", kind="gauge", metric="util", op="le",
              threshold=0.9, window=4, min_count=1),
            o(name="rate", kind="ratio", ratio_num="acc", ratio_den="prop",
              op="ge", threshold=0.5, window=4, min_count=4))


def _drive_slo(mod, reg):
    ev = mod.SLOEvaluator(reg, _objectives(mod))
    h, g = reg.histogram("lat"), reg.gauge("util")
    acc, prop = reg.counter("acc"), reg.counter("prop")
    rng = np.random.RandomState(0)
    out = [ev.evaluate()]
    for b in range(8):
        for v in rng.uniform(0.001, 0.01, 20):
            h.observe(float(v))
        if b >= 3:
            for _ in range(8):
                h.observe(0.30 if b % 2 else 0.05)
        g.set(0.5 if b != 5 else 3.0)
        acc.inc(3 + 4 * b)
        prop.inc(10)
        out.append(ev.evaluate())
    return out, ev.violated(), ev.summary()


def test_slo_evaluator_matches_jax_on_the_same_observations():
    got = _drive_slo(slo, Registry())
    want = _drive_slo(jax_slo, JaxRegistry())
    assert got == want
    statuses = {r["status"] for step in got[0] for r in step.values()}
    assert statuses == set(slo.STATUSES)


def test_serve_objectives_and_validation_match_jax():
    for kw in ({}, dict(min_acceptance=0.3, window=8)):
        assert [vars(o) for o in slo.serve_objectives(**kw)] == \
            [vars(o) for o in jax_slo.serve_objectives(**kw)]
    bad = (dict(kind="median", threshold=1.0, metric="m"),
           dict(kind="gauge", threshold=1.0, metric="m", op="lt"),
           dict(kind="quantile", threshold=1.0, metric="m", q=1.0),
           dict(kind="ratio", threshold=1.0),
           dict(kind="gauge", threshold=1.0),
           dict(kind="quantile", threshold=1.0, metric="m", window=-1),
           dict(kind="gauge", threshold=1.0, metric="m", window=0))
    for kw in bad:
        with pytest.raises(ValueError) as e:
            slo.SLObjective(name="x", **kw)
        with pytest.raises(ValueError) as je:
            jax_slo.SLObjective(name="x", **kw)
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="no objectives"):
        slo.SLOEvaluator(Registry(), ())


# ---------------------------------------------------------------------------
# the engine's records and spans
# ---------------------------------------------------------------------------

def test_engine_records_each_request_and_times_its_spans():
    """A preemption and a full-prompt prefix hit on the plain engine:
    every request's events in order, token totals equal to its stream,
    one ``serve/decode_step`` span a step and one ``serve/prefill_chunk``
    a chunk."""
    cfg = gpt_tiny()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = GPTModel(cfg, device="cpu").to(torch.bfloat16)
    tr = reqtrace.RequestTracer()
    eng = ServeEngine(model, cfg, ServeConfig(
        num_slots=3, block_size=4, num_blocks=9, max_blocks_per_slot=8,
        prefill_chunk=4), registry=Registry(), device="cpu", tracer=tr,
        trace_name="solo")
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, cfg.vocab_size, (8,)), 8),
            (rng.randint(0, cfg.vocab_size, (8,)), 8),
            (rng.randint(0, cfg.vocab_size, (6,)), 6)]
    for i, (p, n) in enumerate(reqs):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
    out = eng.run()
    eng.submit(Request(uid="again", prompt=reqs[0][0], max_new_tokens=3))
    eng.submit(Request(uid="again2", prompt=reqs[0][0], max_new_tokens=3))
    out.update(eng.run())
    m = eng.metrics
    assert m.counter("serve_preemptions_total").value == 1
    for uid, toks in out.items():
        assert tr.tokens_of(uid) >= len(toks)
        kinds = [e["kind"] for e in tr.events(uid)]
        assert kinds[0] == "enqueue" and kinds[-1] == "retire"
        assert {e["where"] for e in tr.events(uid)} == {"solo"}
        retire = tr.events(uid)[-1]
        assert retire["tokens_out"] == len(toks)
    preempted = [u for u in out if "preempt" in
                 [e["kind"] for e in tr.events(u)]]
    assert len(preempted) == 1
    assert [e["kind"] for e in tr.events(preempted[0])].count("admit") == 2
    hit = [e["kind"] for e in tr.events("again2")]
    assert hit[:4] == ["enqueue", "cow_fork", "prefix_hit", "prefill_chunk"]
    np.testing.assert_array_equal(
        out["again2"], generate(model, cfg, reqs[0][0][None], 3,
                                device="cpu").numpy()[0, 8:])
    steps = [e["step"] for u in out for e in tr.events(u)
             if e["kind"] == "decode_step"]
    assert max(steps) == eng.steps
    assert m.histogram("span_seconds__serve_decode_step").count == eng.steps
    assert m.histogram("span_seconds__serve_prefill_chunk").count == \
        m.counter("serve_prefill_chunks_total").value
    assert m.histogram("serve_decode_step_seconds").count == eng.steps
