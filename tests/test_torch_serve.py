"""apex_tpu_torch ``ServeEngine`` on the CPU, in the bf16 serving layout
(the JAX package's O2 cast), with the shapes of
``tests/l0/test_serve_engine.py``.

Each greedy stream must equal the port's own solo ``generate()``
exactly, and the JAX ``ServeEngine``'s stream wherever JAX's top-2 logit
margin at that step exceeds 1e-3 (a smaller margin is a recorded near
tie: another framework's rounding may flip it).  Sampled streams use
``torch.Generator``s, which draw other numbers than JAX's keys, so they
are held only to their own seeds.
"""

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
from apex_tpu.serve import ServeEngine as JaxServeEngine
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.obs import Registry
from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
from apex_tpu_torch.serve.sampling import advance_key, sample_tokens
from apex_tpu_torch.testing import assert_tokens_match_above_margin

SHAPES = dict(num_slots=2, block_size=4, num_blocks=17,
              max_blocks_per_slot=8, prefill_chunk=4)
NEWS = (8, 6, 10, 4, 7)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt_tiny()
    params = JaxGPT(jcfg).init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 4), jnp.int32))["params"]
    params = amp.initialize(opt_level="O2", verbosity=0).model_params_from(
        params)                                   # bf16 serving layout
    model = params_from_jax(jax.tree.map(np.asarray, params), gpt_tiny(),
                            device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, jcfg.vocab_size, (n,))
               for n in (5, 12, 3, 20, 9)]
    return jcfg, params, model, prompts


def _margins(jcfg, params, seq, lp):
    """JAX's top-2 logit gap at each generated step of ``seq``."""
    logits = np.asarray(JaxGPT(jcfg).apply(
        {"params": params}, jnp.asarray(seq[None])).astype(jnp.float32))[0]
    top2 = np.sort(logits[lp - 1:len(seq) - 1], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _engine(model, **shapes):
    return ServeEngine(model, gpt_tiny(), ServeConfig(**shapes),
                       registry=Registry(), device="cpu")


def _solo(model, prompt, n):
    return generate(model, gpt_tiny(), prompt[None], n,
                    device="cpu").numpy()[0, len(prompt):]


def test_mixed_stream_matches_solo_and_the_jax_engine(setup):
    jcfg, params, model, prompts = setup
    eng = _engine(model, **SHAPES)
    jeng = JaxServeEngine(params, jcfg, JaxServeConfig(**SHAPES),
                          registry=JaxRegistry())
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
        jeng.submit(JaxRequest(uid=f"r{i}", prompt=p, max_new_tokens=n))
    out, jout = eng.run(), jeng.run()
    for i, (p, n) in enumerate(zip(prompts, NEWS)):
        np.testing.assert_array_equal(out[f"r{i}"], _solo(model, p, n),
                                      err_msg=f"r{i} diverged from solo")
        assert_tokens_match_above_margin(
            out[f"r{i}"], jout[f"r{i}"],
            lambda: _margins(jcfg, params,
                             np.concatenate([p, jout[f"r{i}"]]), len(p)))
    m = eng.metrics
    assert m.counter("serve_admissions_total").value == 5
    assert m.counter("serve_retirements_total").value == 5
    assert m.counter("serve_preemptions_total").value == 0
    assert m.counter("serve_tokens_total").value == sum(NEWS)
    h = m.histogram("serve_decode_step_seconds")
    assert h.count == eng.steps > 0 and h.quantile(0.5) > 0
    assert m.gauge("serve_queue_depth").value == 0
    assert m.gauge("serve_slot_occupancy").value == 0
    assert m.gauge("serve_block_utilization").value == 0


def test_preemption_recompute_preserves_outputs(setup):
    _, _, model, prompts = setup
    eng = _engine(model, num_slots=3, block_size=4, num_blocks=9,
                  max_blocks_per_slot=8, prefill_chunk=4)
    preempts = []
    orig = eng.sched.preempt
    eng.sched.preempt = lambda slot, key: (preempts.append(slot),
                                           orig(slot, key))[1]
    reqs = [(prompts[0][:8], 8), (prompts[1][:8], 8), (prompts[3][:6], 6)]
    for i, (p, n) in enumerate(reqs):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=n))
    out = eng.run()
    assert len(preempts) == 1
    for i, (p, n) in enumerate(reqs):
        np.testing.assert_array_equal(out[f"r{i}"], _solo(model, p, n))
    assert eng.sched.allocator.live_count == 0
    m = eng.metrics
    assert m.counter("serve_admissions_total").value == 4
    assert m.counter("serve_preemptions_total").value == 1
    assert m.counter("serve_retirements_total").value == 3


def test_prefix_cache_full_prompt_hit_forks_and_keeps_outputs(setup):
    """A second request with the same block-aligned prompt maps the
    first's blocks, forks the last one copy-on-write and re-runs one
    token; both streams equal solo."""
    _, _, model, prompts = setup
    eng = _engine(model, **SHAPES)
    p = prompts[1][:8]
    eng.submit(Request(uid="a", prompt=p, max_new_tokens=5))
    eng.step()                         # "a" admitted, its blocks registered
    eng.submit(Request(uid="b", prompt=p, max_new_tokens=5))
    out = eng.run()
    assert eng.metrics.counter("serve_prefix_cow_copies_total").value == 1
    assert eng.sched.prefix_hits == 1
    assert eng.metrics.counter("serve_prefill_chunks_total").value == 3
    want = _solo(model, p, 5)
    np.testing.assert_array_equal(out["a"], want)
    np.testing.assert_array_equal(out["b"], want)


def test_one_token_budget_finishes_on_prefill(setup):
    _, _, model, prompts = setup
    eng = _engine(model, **SHAPES)
    eng.submit(Request(uid="one", prompt=prompts[0], max_new_tokens=1))
    np.testing.assert_array_equal(eng.run()["one"],
                                  _solo(model, prompts[0], 1))


def test_sampled_streams_follow_their_seeds_not_their_batch_mates(setup):
    _, _, model, prompts = setup

    def run(reqs):
        eng = _engine(model, **dict(SHAPES, num_slots=3))
        for r in reqs:
            eng.submit(r)
        return eng.run()

    knobs = dict(max_new_tokens=8, temperature=1.0, top_k=50, top_p=0.9)
    first = run([Request(uid="a", prompt=prompts[0], seed=7, **knobs),
                 Request(uid="c", prompt=prompts[0], seed=8, **knobs)])
    second = run([Request(uid="x", prompt=prompts[2], max_new_tokens=9),
                  Request(uid="a", prompt=prompts[0], seed=7, **knobs),
                  Request(uid="k1", prompt=prompts[0], max_new_tokens=8,
                          temperature=2.0, top_k=1, seed=3)])
    np.testing.assert_array_equal(first["a"], second["a"])
    assert not np.array_equal(first["a"], first["c"])
    # top_k = 1 can only emit the argmax, at any temperature
    np.testing.assert_array_equal(second["k1"], _solo(model, prompts[0], 8))


def test_sample_tokens_draws_once_per_slot_and_resumes():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.standard_normal((3, 32)).astype(
        np.float32))
    gens = [advance_key(s, 0) for s in (1, 2, 3)]
    greedy = sample_tokens(logits, gens, torch.zeros(3),
                           torch.zeros(3, dtype=torch.int32), torch.ones(3))
    assert greedy.tolist() == logits.argmax(-1).tolist()
    # greedy slots still drew one uniform each: the generators moved
    for g, seed in zip(gens, (1, 2, 3)):
        assert torch.equal(g.get_state(), advance_key(seed, 1).get_state())
    top3 = set(torch.argsort(-logits[0])[:3].tolist())
    g = advance_key(0, 0)
    seen = {int(sample_tokens(logits[:1], [g], torch.full((1,), 1.5),
                              torch.full((1,), 3), torch.ones(1))[0])
            for _ in range(50)}
    assert seen <= top3 and len(seen) > 1
    tok = sample_tokens(logits[:1], [advance_key(9, 0)],
                        torch.full((1,), 2.0), torch.zeros(1),
                        torch.full((1,), 1e-6))
    assert int(tok[0]) == int(logits[0].argmax())
