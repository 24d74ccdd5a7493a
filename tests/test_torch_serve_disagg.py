"""apex_tpu_torch's disaggregated fleet (``serve/transfer.py``,
``serve/router.py``) on the CPU, with the shapes of
``tests/l0/test_serve_disagg.py``; the three slices are ``[cpu] * 3``.

One JAX ship-mode ``DisaggRouter`` with a ``RequestTracer`` is built (a
module fixture) and run beside the port's on the same mixed greedy
stream: the port's streams equal its own solo ``generate()`` exactly and
JAX's wherever JAX's top-2 logit margin exceeds 1e-3; the two traces hold
the same events, engine by engine; the KV bytes shipped are equal (the
generator state the port ships is a CPU ``torch.Generator``'s, bigger
than JAX's 8-byte key).  The other cases — recompute mode, a replica's
death, sampled requests through a death, SLO de-ranking, prefix hits —
are held against the port's own solo ``generate()`` or its own fleet.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import gpt_tiny as jax_gpt_tiny
from apex_tpu.obs import RequestTracer as JaxRequestTracer
from apex_tpu.obs.metrics import Registry as JaxRegistry
from apex_tpu.serve import DisaggRouter as JaxDisaggRouter
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import RouterConfig as JaxRouterConfig
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.obs import FlightRecorder, Registry, RequestTracer
from apex_tpu_torch.obs.slo import SLObjective
from apex_tpu_torch.resilience.incidents import validate_incident_file
from apex_tpu_torch.serve import (
    DisaggRouter,
    KVShipment,
    Request,
    RouterConfig,
    ServeConfig,
    ship,
    slice_fleet,
)
from apex_tpu_torch.serve import transfer
from apex_tpu_torch.testing import assert_tokens_match_above_margin

SHAPES = dict(num_slots=2, block_size=4, num_blocks=17,
              max_blocks_per_slot=8, prefill_chunk=4)
SCFG = ServeConfig(**SHAPES)
NEWS = (8, 6, 10, 4, 7)
CPUS = ["cpu"] * 3
#: fields that differ by construction between the packages' traces:
#: stamps, sampled tokens (held by the stream test under the near-tie
#: rule) and the shipment's bytes (the generator state's size)
UNCOMPARED = ("ts", "seq", "token", "first_token", "nbytes")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt_tiny()
    params = JaxGPT(jcfg).init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 4), jnp.int32))["params"]
    params = amp.initialize(opt_level="O2", verbosity=0).model_params_from(
        params)
    model = params_from_jax(jax.tree.map(np.asarray, params), gpt_tiny(),
                            device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, jcfg.vocab_size, (n,))
               for n in (5, 12, 3, 20, 9)]
    return jcfg, params, model, prompts


def _router(model, rcfg=None, **kw):
    return DisaggRouter(model, gpt_tiny(), kw.pop("scfg", SCFG),
                        rcfg or RouterConfig(), devices=CPUS,
                        registry=Registry(), **kw)


def _solo(model, prompt, n):
    return generate(model, gpt_tiny(), prompt[None], n,
                    device="cpu").numpy()[0, len(prompt):]


@pytest.fixture(scope="module")
def ship_runs(setup):
    """The mixed stream through JAX's ship-mode fleet and the port's,
    both traced; the port's queue depth after its first step."""
    jcfg, params, model, prompts = setup
    jtr, tr = JaxRequestTracer(), RequestTracer()
    jrouter = JaxDisaggRouter(params, jcfg, JaxServeConfig(**SHAPES),
                              JaxRouterConfig(transfer="ship"),
                              registry=JaxRegistry(), tracer=jtr)
    router = _router(model, tracer=tr)
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        jrouter.submit(JaxRequest(uid=f"r{i}", prompt=p, max_new_tokens=n))
        router.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
    router.step()
    held = router.metrics.gauge("serve_router_queue_depth").value
    return dict(jout=jrouter.run(), out=router.run(), jrouter=jrouter,
                router=router, jtr=jtr, tr=tr, held=held)


def _margins(jcfg, params, seq, lp):
    logits = np.asarray(JaxGPT(jcfg).apply(
        {"params": params}, jnp.asarray(seq[None])).astype(jnp.float32))[0]
    top2 = np.sort(logits[lp - 1:len(seq) - 1], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


# ---------------------------------------------------------------------------
# the ship-mode stream against JAX
# ---------------------------------------------------------------------------

def test_ship_stream_matches_solo_and_the_jax_fleet(setup, ship_runs):
    jcfg, params, model, prompts = setup
    out, jout = ship_runs["out"], ship_runs["jout"]
    # 5 requests into 4 decode slots: the router held one
    assert ship_runs["held"] >= 1
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        np.testing.assert_array_equal(out[f"r{i}"], _solo(model, p, n),
                                      err_msg=f"r{i} through the fleet")
        assert_tokens_match_above_margin(
            out[f"r{i}"], jout[f"r{i}"],
            lambda: _margins(jcfg, params,
                             np.concatenate([p, jout[f"r{i}"]]), len(p)))
    m = ship_runs["router"].metrics
    assert m.counter("serve_kv_shipments_total").value == 5
    assert m.counter("serve_reroute_total").value == 0
    assert m.gauge("serve_router_queue_depth").value == 0
    for i in range(2):
        assert m.gauge(f"serve_replica{i}_queue_depth").value == 0
        assert m.gauge(f"serve_replica{i}_slot_occupancy").value == 0
        assert m.gauge(f"serve_replica{i}_block_utilization").value == 0


def test_shipment_kv_bytes_equal_jaxs(ship_runs):
    """Per shipment the KV bytes are JAX's; the whole count differs by
    the generator state against JAX's 8-byte key."""
    jm, m = ship_runs["jrouter"].metrics, ship_runs["router"].metrics
    n = m.counter("serve_kv_shipments_total").value
    assert n == jm.counter("serve_kv_shipments_total").value == 5
    key = len(torch.Generator().get_state())
    assert m.counter("serve_kv_transfer_bytes").value - n * key == \
        jm.counter("serve_kv_transfer_bytes").value - n * 8
    ships = [e for u in ship_runs["tr"].uids()
             for e in ship_runs["tr"].events(u) if e["kind"] == "kv_ship"]
    cfg = gpt_tiny()
    kv = 2 * cfg.num_layers * SCFG.max_blocks_per_slot * SCFG.block_size \
        * cfg.hidden_size * 2                            # bf16 k and v
    assert len(ships) == 5 and all(e["nbytes"] == kv + key for e in ships)


def test_trace_holds_jaxs_events_engine_by_engine(ship_runs):
    """The two tracers' documents for the same stream: per request the
    same events in the same order at the same components (router,
    prefill, replicas), the same fields, the same span tree shape and
    token totals."""
    jdoc = ship_runs["jtr"].to_doc_requests()
    doc = ship_runs["tr"].to_doc_requests()
    assert sorted(doc) == sorted(jdoc)

    def strip(events):
        return [{k: v for k, v in e.items() if k not in UNCOMPARED}
                for e in events]

    for uid in doc:
        assert strip(doc[uid]["events"]) == strip(jdoc[uid]["events"]), uid
        assert doc[uid]["tokens"] == jdoc[uid]["tokens"]
        assert [(s["name"], s["where"], s["parent"])
                for s in doc[uid]["spans"]] == \
            [(s["name"], s["where"], s["parent"])
             for s in jdoc[uid]["spans"]]
        assert doc[uid]["trace_id"] == jdoc[uid]["trace_id"]
    chrome = ship_runs["tr"].to_chrome_trace()
    jchrome = ship_runs["jtr"].to_chrome_trace()
    assert [(e["ph"], e["name"]) for e in chrome["traceEvents"]
            if e["ph"] == "M"] == \
        [(e["ph"], e["name"]) for e in jchrome["traceEvents"]
         if e["ph"] == "M"]
    json.dumps(chrome)


# ---------------------------------------------------------------------------
# the port's own fleet: recompute, a replica's death, SLOs, prefix hits
# ---------------------------------------------------------------------------

def test_recompute_mode_matches_solo(setup):
    _, _, model, prompts = setup
    router = _router(model, RouterConfig(transfer="recompute"))
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        router.submit(Request(uid=f"q{i}", prompt=p, max_new_tokens=n))
    out = router.run()
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        np.testing.assert_array_equal(out[f"q{i}"], _solo(model, p, n))
    m = router.metrics
    assert m.counter("serve_kv_transfer_bytes").value == 0
    assert m.counter("serve_kv_shipments_total").value == 0


def test_replica_kill_reroutes_and_stays_equal_to_solo(setup, tmp_path):
    _, _, model, prompts = setup
    flight, tr = FlightRecorder(), RequestTracer()
    path = str(tmp_path / "incident.json")
    router = _router(model, RouterConfig(incident_path=path),
                     flight=flight, tracer=tr)
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        router.submit(Request(uid=f"k{i}", prompt=p, max_new_tokens=n))
    for _ in range(3):
        router.step()
    victim = max(router.replicas, key=lambda r: r.eng.sched.n_active()).index
    rerouted = router.kill_replica(victim)
    assert rerouted
    assert router.kill_replica(victim) == []
    out = router.run()
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        np.testing.assert_array_equal(out[f"k{i}"], _solo(model, p, n),
                                      err_msg=f"k{i} after the kill")
    m = router.metrics
    assert m.counter("serve_reroute_total").value == len(rerouted)
    assert not router.replicas[victim].alive
    assert router.replicas[1 - victim].eng.sched.idle()
    assert validate_incident_file(path) == []
    with open(path) as f:
        rec = json.load(f)
    assert rec["status"] == "replica-killed"
    assert rec["rerouted"] == rerouted
    kinds = [e["kind"] for e in rec["flight"]["events"]]
    assert kinds[0] == "replica_kill" and kinds.count("reroute") == \
        len(rerouted)
    for uid in rerouted:
        evs = tr.events(uid)
        where = [e["where"] for e in evs if e["kind"] == "decode_step"]
        assert f"replica{victim}" in where and \
            f"replica{1 - victim}" in where
        assert [e["from_replica"] for e in evs
                if e["kind"] == "reroute"] == [victim]
        assert tr.tokens_of(uid) >= len(out[uid])


def test_sampled_requests_resume_their_exact_chain_through_a_kill(setup):
    _, _, model, prompts = setup

    def run(kill):
        router = _router(model)
        router.submit(Request(uid="s0", prompt=prompts[0],
                              max_new_tokens=10, temperature=1.0,
                              top_k=50, top_p=0.9, seed=7))
        router.submit(Request(uid="s1", prompt=prompts[1],
                              max_new_tokens=8, temperature=0.8, seed=3))
        if kill:
            for _ in range(3):
                router.step()
            busiest = max(router.replicas,
                          key=lambda r: r.eng.sched.n_active())
            assert router.kill_replica(busiest.index)
        return router.run()

    base, killed = run(False), run(True)
    for uid in ("s0", "s1"):
        np.testing.assert_array_equal(base[uid], killed[uid])


def test_slo_deranks_a_violating_replica(setup):
    _, _, model, _ = setup
    cfg = gpt_tiny()
    slo = (SLObjective(name="decode_p99", kind="quantile",
                       metric="serve_decode_step_seconds", q=0.5,
                       threshold=1e-7, window=8, min_count=2),)
    router = _router(model, RouterConfig(slo=slo))
    rng = np.random.RandomState(0)
    router.submit(Request(uid="w0",
                          prompt=rng.randint(0, cfg.vocab_size, (5,)),
                          max_new_tokens=6))
    router.run()
    assert [ev.violated() for ev in router.slo_evals] == [True, False]
    assert [g.value for g in router._m_rep_slo] == [0.0, 1.0]
    for i in range(2):
        router.submit(Request(
            uid=f"q{i}", prompt=rng.randint(0, cfg.vocab_size, (4,)),
            max_new_tokens=4))
    router.step()
    assert router.replicas[0].eng.sched.n_active() == 0
    assert router.replicas[1].eng.sched.n_active() == 2
    summary = router.slo_summary()
    assert summary["replica0"]["ok"] is False
    assert summary["replica1"]["ok"] is True
    assert set(router.run()) == {"w0", "q0", "q1"}
    assert _router(model).slo_summary() is None


def test_prefix_hit_goes_straight_to_the_replica(setup):
    """A prompt whose blocks a replica's index holds skips the prefill
    worker; the traced fleet records the routing, the prefix hit and the
    copy-on-write fork (kinds JAX's tracer does not know)."""
    _, _, model, prompts = setup
    tr = RequestTracer()
    router = _router(model, tracer=tr)
    p = prompts[3][:8]
    router.submit(Request(uid="a", prompt=p, max_new_tokens=5))
    router.step()
    router.submit(Request(uid="b", prompt=p, max_new_tokens=5))
    out = router.run()
    want = _solo(model, p, 5)
    np.testing.assert_array_equal(out["a"], want)
    np.testing.assert_array_equal(out["b"], want)
    m = router.metrics
    assert m.counter("serve_prefix_direct_admissions_total").value == 1
    assert m.counter("serve_kv_shipments_total").value == 1
    assert [(e["kind"], e["where"]) for e in tr.events("b")][:5] == [
        ("enqueue", "router"), ("enqueue", "replica0"),
        ("prefix_direct", "router"), ("cow_fork", "replica0"),
        ("prefix_hit", "replica0")]
    with pytest.raises(ValueError, match="vocabulary"):
        JaxRequestTracer().record("prefix_hit", "b", "replica0")


# ---------------------------------------------------------------------------
# transfer mechanics, layout, validation
# ---------------------------------------------------------------------------

def test_gather_install_roundtrip_routes_trash():
    L, NB, BS, H, D = 2, 6, 4, 2, 3
    rng = np.random.RandomState(0)
    src_kc = torch.from_numpy(rng.standard_normal(
        (L, NB, BS, H, D)).astype(np.float32))
    src = {"kc": src_kc, "vc": src_kc * 2.0}
    gather = transfer.make_gather(("kc", "vc"))
    shipped = gather(src, torch.tensor([3, 5, 0, 0]))
    assert shipped["kc"].shape == (L, 4, BS, H, D)
    assert torch.equal(shipped["kc"][:, 0], src_kc[:, 3])
    install = transfer.make_install(("kc", "vc"))
    dst = {"kc": torch.zeros(L, NB, BS, H, D),
           "vc": torch.zeros(L, NB, BS, H, D)}
    gens = [torch.Generator(), torch.Generator()]
    key = torch.Generator().manual_seed(11).get_state()
    before = gens[0].get_state()
    install(dst, gens, torch.tensor([1, 2, 0, 0]), shipped, 1, key)
    assert torch.equal(dst["kc"][:, 1], src_kc[:, 3])
    assert torch.equal(dst["kc"][:, 2], src_kc[:, 5])
    assert torch.equal(dst["vc"][:, 2], 2.0 * src_kc[:, 5])
    # the other blocks untouched; the padding hit only the trash block
    assert not dst["kc"][:, 3:].any()
    assert torch.equal(gens[1].get_state(), key)
    assert torch.equal(gens[0].get_state(), before)
    assert transfer.shipment_bytes(shipped, key) == \
        2 * shipped["kc"].numel() * 4 + key.numel()


def test_ship_copies_into_fresh_buffers():
    """On one device the wire still copies: the shipment aliases nothing
    it was gathered into, and its bytes are bytes moved."""
    kv = {"kc": torch.arange(24.0).reshape(1, 2, 3, 4)}
    key = torch.Generator().get_state()
    shp = KVShipment(request=Request(uid="x", prompt=np.ones(3, np.int32),
                                     max_new_tokens=2),
                     kv=kv, first_token=1, prompt_len=3, key=key)
    out = ship(shp, torch.device("cpu"))
    assert out.kv["kc"].data_ptr() != kv["kc"].data_ptr()
    assert out.key.data_ptr() != key.data_ptr()
    assert torch.equal(out.kv["kc"], kv["kc"])
    assert out.nbytes == 24 * 4 + key.numel() and out.uid == "x"
    kv["kc"].zero_()
    assert out.kv["kc"].sum() > 0
    tree = transfer.place_tree({"a": [key, (kv["kc"], 3)]}, "cpu")
    assert tree["a"][0] is key and tree["a"][1][1] == 3
    assert transfer.placement(("cpu", "meta")) == "cpu"


def test_slice_fleet_layout_and_validation():
    slices = slice_fleet(["cpu"] * 8, n_prefill_devices=2,
                         n_decode_replicas=3, devices_per_replica=2)
    assert slices.n_devices == 8
    assert slices.describe() == {"prefill": ["cpu", "cpu"],
                                 "decode": [["cpu", "cpu"]] * 3}
    with pytest.raises(ValueError, match="needs"):
        slice_fleet(["cpu"] * 2, n_decode_replicas=2,
                    devices_per_replica=2)
    with pytest.raises(ValueError, match=">= 1"):
        slice_fleet(["cpu"] * 8, n_decode_replicas=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            slice_fleet()


def test_router_config_and_submit_validation(setup):
    _, _, model, _ = setup
    with pytest.raises(ValueError, match="transfer"):
        RouterConfig(transfer="teleport")
    with pytest.raises(ValueError, match="admit_block_util"):
        RouterConfig(admit_block_util=0.0)
    # the continuous profiler's settings build (JAX's defaults); the
    # wiring itself: tests/test_torch_contprof.py
    from apex_tpu_torch.obs.contprof import ContProfConfig
    rc, jrc = RouterConfig(contprof=ContProfConfig()), JaxRouterConfig()
    assert (rc.contprof.capture_every, rc.contprof_band, rc.contprof_k) \
        == (256, jrc.contprof_band, jrc.contprof_k)
    router = _router(model)
    with pytest.raises(ValueError, match="non-empty"):
        router.submit(Request(uid="e", prompt=np.zeros(0, np.int32),
                              max_new_tokens=4))
    with pytest.raises(ValueError, match="context"):
        router.submit(Request(uid="big", prompt=np.zeros(30, np.int32),
                              max_new_tokens=8))
    with pytest.raises(ValueError, match="decode replicas"):
        DisaggRouter(model, gpt_tiny(), SCFG, RouterConfig(),
                     slices=slice_fleet(["cpu"] * 4, n_decode_replicas=3),
                     registry=Registry())
    # replicas on one device share the model; the worker's pool is one
    # slot's
    assert all(r.eng.model is model for r in router.replicas)
    assert router.prefill.eng.model is model
    assert router.prefill.scfg == dataclasses.replace(
        SCFG, num_slots=1, num_blocks=SCFG.max_blocks_per_slot + 1,
        prefix_cache=False)
