"""apex_tpu_torch ``SpecEngine`` (speculative decoding) on the CPU, with the
shapes of ``tests/l0/test_serve_spec.py``.

One JAX ``SpecEngine`` is built (a module fixture) on gpt_tiny's bf16
serving layout: the port's mixed greedy stream is held against it
wherever JAX's top-2 logit margin exceeds 1e-3 (the near-tie rule of
``tests/test_torch_serve.py``).  Every other case is held against the
port's own solo ``generate()`` or its own plain ``ServeEngine``, exactly:
the port's plain engine is held against JAX by ``tests/test_torch_serve.
py``, and sampled streams draw from ``torch.Generator``s, which draw
other numbers than JAX's keys.  The model is JAX's random gpt_tiny: on
the CPU the port's streams equal its solo ``generate()`` exactly at any
margin, and its small margins make a corrupted cache show in the tokens
(the trained toy LM is held exactly on the card, ``chip_smoke.py``'s
``serve_fleet``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import gpt_tiny as jax_gpt_tiny
from apex_tpu.obs.metrics import Registry as JaxRegistry
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.serve import SpecConfig as JaxSpecConfig
from apex_tpu.serve import SpecEngine as JaxSpecEngine
from apex_tpu.serve import truncated_draft as jax_truncated_draft
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import GPTModel, gpt_tiny
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.obs import Registry, RequestTracer
from apex_tpu_torch.obs.spans import metric_name
from apex_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    SpecConfig,
    SpecEngine,
    advance_key,
    truncated_draft,
)
from apex_tpu_torch.testing import assert_tokens_match_above_margin

SHAPES = dict(num_slots=2, block_size=4, num_blocks=17,
              max_blocks_per_slot=8, prefill_chunk=4)
SCFG = ServeConfig(**SHAPES)
NEWS = (8, 6, 10, 4, 7)


@pytest.fixture(scope="module")
def random_setup():
    """gpt_tiny from JAX's seed 1 in the bf16 serving layout, in both
    packages, and the mixed prompts of the JAX tests."""
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


def _spec(model, cfg, scfg=SCFG, k=3, layers=1, **kw):
    draft, dcfg = truncated_draft(model, cfg, layers)
    return SpecEngine(model, cfg, scfg, draft, dcfg, SpecConfig(k=k),
                      registry=Registry(), device="cpu", **kw)


def _solo(model, cfg, prompt, n, kv_dtype=None):
    return generate(model, cfg, prompt[None], n, device="cpu",
                    kv_dtype=kv_dtype).numpy()[0, len(prompt):]


def _margins(jcfg, params, seq, lp):
    logits = np.asarray(JaxGPT(jcfg).apply(
        {"params": params}, jnp.asarray(seq[None])).astype(jnp.float32))[0]
    top2 = np.sort(logits[lp - 1:len(seq) - 1], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_mixed_greedy_stream_matches_solo_and_the_jax_spec_engine(
        random_setup):
    jcfg, params, model, prompts = random_setup
    cfg = gpt_tiny()
    dp, dcfg = jax_truncated_draft(params, jcfg, 1)
    jeng = JaxSpecEngine(params, jcfg, JaxServeConfig(**SHAPES), dp, dcfg,
                         JaxSpecConfig(k=3), registry=JaxRegistry())
    tracer = RequestTracer()
    eng = _spec(model, cfg, tracer=tracer)
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
        jeng.submit(JaxRequest(uid=f"r{i}", prompt=p, max_new_tokens=n))
    out, jout = eng.run(), jeng.run()
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        np.testing.assert_array_equal(out[f"r{i}"], _solo(model, cfg, p, n),
                                      err_msg=f"r{i} diverged from solo")
        assert_tokens_match_above_margin(
            out[f"r{i}"], jout[f"r{i}"],
            lambda: _margins(jcfg, params,
                             np.concatenate([p, jout[f"r{i}"]]), len(p)))
    m = eng.metrics
    rounds = m.counter("serve_spec_rounds_total").value
    proposed = m.counter("serve_spec_proposed_total").value
    accepted = m.counter("serve_spec_accepted_total").value
    assert rounds == eng.steps > 0
    assert m.counter("serve_spec_draft_steps_total").value == 4 * rounds
    assert proposed > 0 and accepted > 0
    assert m.gauge("serve_spec_acceptance_rate").value == pytest.approx(
        accepted / proposed)
    # every emitted decode token is a proposal accepted or the target's
    # own draw, one a slot a round
    assert m.counter("serve_tokens_total").value == sum(NEWS)
    # the spans: one draft and one verify a round, a draft-prefill and a
    # target prefill chunk per chunk
    chunks = m.counter("serve_prefill_chunks_total").value
    for name, count in (("serve/spec_draft", rounds),
                        ("serve/spec_verify", rounds),
                        ("serve/spec_draft_prefill", chunks),
                        ("serve/prefill_chunk", chunks)):
        assert m.histogram(metric_name(name)).count == count, name
    # the tracer: per request, the verify rounds' tokens + the admission
    # token sum to its stream; spec_draft proposes k every round
    for i, n in enumerate(NEWS):
        evs = tracer.events(f"r{i}")
        assert tracer.tokens_of(f"r{i}") == n
        drafts = [e for e in evs if e["kind"] == "spec_draft"]
        verifies = [e for e in evs if e["kind"] == "spec_verify"]
        assert len(drafts) == len(verifies) > 0
        assert all(e["proposed"] == 3 for e in drafts)
        assert [e["kind"] for e in evs][-1] == "retire"


def test_spec_through_preemption_matches_solo(random_setup):
    _, _, model, prompts = random_setup
    cfg = gpt_tiny()
    scfg = ServeConfig(num_slots=3, block_size=4, num_blocks=9,
                       max_blocks_per_slot=8, prefill_chunk=4)
    tracer = RequestTracer()
    eng = _spec(model, cfg, scfg, tracer=tracer)
    reqs = [(prompts[1][:8], 8), (prompts[3][:8], 8), (prompts[4][:6], 6)]
    for i, (p, n) in enumerate(reqs):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
    out = eng.run()
    assert eng.metrics.counter("serve_preemptions_total").value == 1
    for i, (p, n) in enumerate(reqs):
        np.testing.assert_array_equal(out[f"r{i}"], _solo(model, cfg, p, n),
                                      err_msg=f"r{i} through preemption")
    assert eng.sched.allocator.live_count == 0
    preempted = [u for u in tracer.uids()
                 if any(e["kind"] == "preempt" for e in tracer.events(u))]
    assert len(preempted) == 1
    kinds = [e["kind"] for e in tracer.events(preempted[0])]
    assert kinds.count("admit") == 2 and kinds[-1] == "retire"


def test_spec_kv8_matches_the_int8_engine(random_setup):
    """An int8 target (the verifier writes through ``quantize_kv``) with
    a dense draft cache: streams equal the plain int8 engine's, so
    speculation adds nothing to the int8 format's drift.  (Solo int8
    ``generate()`` prefills with flash attention on unquantized q / k /
    v, so on this random model it differs from every int8 engine at the
    first token; the plain int8 engine equals it on the trained toy LM,
    ``tests/test_torch_int8_kv.py``.)"""
    _, _, model, prompts = random_setup
    cfg = gpt_tiny()
    scfg = dataclasses.replace(SCFG, kv_dtype="int8")
    eng = _spec(model, cfg, scfg)
    assert eng.kc.dtype == torch.int8 and eng.dkc.dtype == torch.bfloat16
    base = ServeEngine(model, cfg, scfg, registry=Registry(), device="cpu")
    news = (6, 8, 5)
    for i, (p, n) in enumerate(zip(prompts[:3], news)):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
        base.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
    out, outb = eng.run(), base.run()
    for i in range(3):
        np.testing.assert_array_equal(out[f"r{i}"], outb[f"r{i}"])
    assert eng.metrics.counter("serve_spec_accepted_total").value > 0


def test_spec_sampled_streams_match_baseline_engine(random_setup):
    """Sampled slots: the verifier draws row by row with the slots'
    generators, so a sampled stream is the plain engine's, bit for bit;
    a greedy batch-mate too."""
    _, _, model, prompts = random_setup
    cfg = gpt_tiny()
    eng = _spec(model, cfg)
    base = ServeEngine(model, cfg, SCFG, registry=Registry(), device="cpu")
    for e in (eng, base):
        e.submit(Request(uid="s", prompt=prompts[0], max_new_tokens=10,
                         temperature=0.8, top_k=12, seed=7))
        e.submit(Request(uid="t", prompt=prompts[1], max_new_tokens=9,
                         temperature=1.0, top_p=0.9, seed=3))
        e.submit(Request(uid="g", prompt=prompts[2], max_new_tokens=6))
    out, outb = eng.run(), base.run()
    for uid in ("s", "t", "g"):
        np.testing.assert_array_equal(out[uid], outb[uid], err_msg=uid)
    assert len(set(out["s"].tolist())) > 1


def test_advance_key_chain_identity_under_partial_accepts(random_setup):
    """After every round, a sampled slot's generator is
    ``advance_key(seed, draws)`` with one draw per emitted token, also
    after rounds that accept some but not all proposals (the state the
    router's replica-kill recovery re-derives)."""
    _, _, model, prompts = random_setup
    cfg = gpt_tiny()
    eng = _spec(model, cfg)
    eng.submit(Request(uid="s", prompt=prompts[1], max_new_tokens=20,
                       temperature=0.7, top_k=20, seed=11))
    with torch.inference_mode():
        eng._admit_and_evict()
    slot = next(i for i in range(eng.sched.num_slots)
                if eng.sched.slots[i] is not None)
    emit_counts = []
    while eng.sched.slots[slot] is not None:
        before = len(eng.sched.slots[slot].emitted)
        eng.step()
        s = eng.sched.slots[slot]
        if s is None:
            break
        emit_counts.append(len(s.emitted) - before)
        draws = len(s.request.prior_tokens) + len(s.emitted)
        assert torch.equal(eng.generators[slot].get_state(),
                           advance_key(11, draws).get_state()), (
            f"after {draws} draws the slot's generator is not the "
            f"draw-count chain")
    assert any(1 < c < 4 for c in emit_counts), emit_counts


def test_full_reach_requests_do_not_wrap_writes(random_setup):
    """prompt + budget == the slot's whole reach, with a draft that
    proposes badly (other random weights): the verifier's and the draft's
    rows past the reach must write to the trash block, not wrap onto live
    history.  The target is the random model, whose small logit margins
    make a corrupted cache position show in its tokens."""
    _, _, model, _ = random_setup
    cfg = gpt_tiny()
    scfg = ServeConfig(num_slots=2, block_size=4, num_blocks=13,
                       max_blocks_per_slot=6, prefill_chunk=4)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(99)
        bad = GPTModel(cfg, device="cpu").to(torch.bfloat16)
    eng = SpecEngine(model, cfg, scfg, bad, cfg, SpecConfig(k=3),
                     registry=Registry(), device="cpu")
    rng = np.random.RandomState(3)
    cases = [rng.randint(0, cfg.vocab_size, (16,)) for _ in range(4)]
    for i, p in enumerate(cases):
        eng.submit(Request(uid=f"w{i}", prompt=p, max_new_tokens=8))
    out = eng.run()
    for i, p in enumerate(cases):
        np.testing.assert_array_equal(out[f"w{i}"], _solo(model, cfg, p, 8),
                                      err_msg=f"w{i} wrapped its writes")


def test_spec_config_and_draft_validation(random_setup):
    _, _, model, _ = random_setup
    cfg = gpt_tiny()
    with pytest.raises(ValueError, match="k="):
        SpecConfig(k=0)
    with pytest.raises(ValueError, match="num_layers"):
        truncated_draft(model, cfg, cfg.num_layers)
    with pytest.raises(ValueError, match="num_layers"):
        truncated_draft(model, cfg, 0)
    with pytest.raises(ValueError, match="vocab"):
        bad_cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
        SpecEngine(model, cfg, SCFG, model, bad_cfg, registry=Registry(),
                   device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        SpecEngine(model, cfg, SCFG, GPTModel(cfg, device="meta"), cfg,
                   registry=Registry(), device="cpu")


def test_truncated_draft_shares_the_targets_tensors(random_setup):
    _, _, model, _ = random_setup
    cfg = gpt_tiny()
    draft, dcfg = truncated_draft(model, cfg, 1)
    assert dcfg == dataclasses.replace(cfg, num_layers=1)
    assert len(draft.blocks) == 1
    assert draft.tok_emb.embedding is model.tok_emb.embedding
    assert draft.ln_f.scale is model.ln_f.scale
    assert draft.lm_head.kernel is model.lm_head.kernel
    assert draft.block_0.ffn_in.kernel is model.block_0.ffn_in.kernel
    assert draft.device == model.device and draft.dtype == model.dtype
