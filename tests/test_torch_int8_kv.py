"""The port's int8 KV cache (``kv_dtype="int8"``: ``generate``, the paged
pools of ``serve/paged.py`` and ``ServeEngine``) against the JAX
package's, on the CPU.

The model is the JAX package's ``train_toy_lm`` (gpt_tiny trained 50
steps at O2 on a periodic stream, bf16 parameters), brought across by
``params_from_jax``: a random model's near-uniform logits would measure
tie-breaking, not the cache format.  Made once for the module.

Tolerances:

- int8 ``generate`` gives JAX's int8 tokens exactly (greedy, the trained
  margins); the port's int8 stream matches its dense stream at 0.9 of
  the tokens or more (the JAX package's documented tolerance,
  ``tests/l0/test_quant.py``; measured 1.0);
- the cached attention with scales is within 1e-6 of JAX's (the same
  fp32 math, summed in another order); the scale gather equal;
- the engine's int8 stream equals solo int8 ``generate`` exactly, and its
  quantization-error gauge lies in (0, 0.1) (JAX's bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.generate import _attn_cached as jax_attn_cached
from apex_tpu.models.generate import generate as jax_generate
from apex_tpu.models.gpt import train_toy_lm as jax_train_toy_lm
from apex_tpu.serve import paged as jax_paged
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import gpt_tiny, train_toy_lm
from apex_tpu_torch.models.generate import _attn_cached, generate
from apex_tpu_torch.obs import Registry
from apex_tpu_torch.serve import (Request, ServeConfig, ServeEngine,
                                  gather_slot_scales, make_scale_pools)

NEW = 12


@pytest.fixture(scope="module")
def toy():
    """``(jax cfg, jax params, port model, prompts (2, 8))``."""
    jcfg, params, ids = jax_train_toy_lm()
    model = params_from_jax(jax.tree.map(np.asarray, params), gpt_tiny(),
                            device="cpu")
    return jcfg, params, model, ids[:2, :8]


@pytest.fixture(scope="module")
def int8_tokens(toy):
    """JAX's and the port's int8 greedy streams of the two prompts."""
    jcfg, params, model, prompt = toy
    want = np.asarray(jax_generate(params, jcfg, jnp.asarray(prompt), NEW,
                                   kv_dtype="int8"))
    got = generate(model, gpt_tiny(), prompt, NEW, device="cpu",
                   kv_dtype="int8").numpy()
    return want, got


def test_int8_generate_gives_jaxs_tokens(int8_tokens):
    want, got = int8_tokens
    np.testing.assert_array_equal(got, want)


def test_int8_matches_dense_within_the_documented_tolerance(toy,
                                                            int8_tokens):
    _, _, model, prompt = toy
    dense = generate(model, gpt_tiny(), prompt, NEW, device="cpu").numpy()
    q = int8_tokens[1]
    assert float(np.mean(dense[:, 8:] == q[:, 8:])) >= 0.9


def test_int8_generate_is_deterministic(toy, int8_tokens):
    _, _, model, prompt = toy
    again = generate(model, gpt_tiny(), prompt, NEW, device="cpu",
                     kv_dtype="int8").numpy()
    np.testing.assert_array_equal(again, int8_tokens[1])


def test_other_kv_dtypes_are_refused(toy):
    _, _, model, prompt = toy
    with pytest.raises(ValueError, match="kv_dtype"):
        generate(model, gpt_tiny(), prompt, 4, device="cpu",
                 kv_dtype="int4")


@pytest.mark.parametrize("mask_rank", [2, 3])
def test_cached_attention_with_scales_matches_jax(mask_rank):
    rng = np.random.default_rng(5)
    b, lq, m, h, d = 2, 3, 10, 4, 16
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    kc = rng.integers(-127, 128, (b, m, h, d)).astype(np.int8)
    vc = rng.integers(-127, 128, (b, m, h, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (b, m)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (b, m)).astype(np.float32)
    valid = np.arange(m)[None, :] <= (6 + np.arange(lq))[:, None]
    if mask_rank == 3:
        valid = np.stack([valid, np.roll(valid, 1, axis=1)])
    want = np.asarray(jax_attn_cached(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(valid), 0.25, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    got = _attn_cached(*(torch.from_numpy(a) for a in (q, kc, vc, valid)),
                       0.25, k_scale=torch.from_numpy(ks),
                       v_scale=torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_scale_pools_and_their_gather_match_jax():
    ks, vs = make_scale_pools(2, 5, 4, "cpu")
    jks, _ = jax_paged.make_scale_pools(2, 5, 4)
    assert ks.shape == vs.shape == jks.shape and ks.dtype == torch.float32
    pool = np.random.default_rng(2).standard_normal((5, 4)).astype(
        np.float32)
    table = np.array([[1, 3, 0], [4, 2, 2]])
    want = np.asarray(jax_paged.gather_slot_scales(jnp.asarray(pool),
                                                   jnp.asarray(table)))
    got = gather_slot_scales(torch.from_numpy(pool),
                             torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)


def _engine(model, prefix_cache=True):
    scfg = ServeConfig(num_slots=2, block_size=4, num_blocks=11,
                       max_blocks_per_slot=5, prefill_chunk=4,
                       kv_dtype="int8", prefix_cache=prefix_cache)
    assert scfg.int8_kv and not ServeConfig().int8_kv
    assert ServeConfig(kv_dtype=torch.int8).int8_kv
    return ServeEngine(model, gpt_tiny(), scfg, registry=Registry(),
                       device="cpu")


def test_engine_int8_equals_solo_and_reports_its_error(toy):
    _, _, model, prompt = toy
    eng = _engine(model)
    assert eng.kc.dtype == torch.int8 and eng.ks.dtype == torch.float32
    eng.submit(Request(uid="a", prompt=prompt[0], max_new_tokens=6))
    eng.submit(Request(uid="b", prompt=prompt[1][:5], max_new_tokens=6))
    outs = eng.run()
    for uid, p in (("a", prompt[0]), ("b", prompt[1][:5])):
        solo = generate(model, gpt_tiny(), p[None], 6, device="cpu",
                        kv_dtype="int8").numpy()[0, len(p):]
        np.testing.assert_array_equal(outs[uid], solo)
    err = eng.metrics.gauge("serve_kv_quant_error").value
    assert 0.0 < err < 0.1


def test_a_prefix_cache_hit_copies_the_scale_pools(toy):
    """The same 8-token prompt twice: the second admission matches it
    whole and forks its last block copy-on-write; the fork carries the
    block's scales (else its positions would dequantize to zeros) and
    the stream still equals solo int8 ``generate``."""
    _, _, model, prompt = toy
    eng = _engine(model)
    forks = []
    cow = eng._cow_copy

    def recording(src, dst):
        forks.append((src, dst))
        cow(src, dst)
    eng._cow_copy = recording
    p = prompt[0]
    eng.submit(Request(uid="first", prompt=p, max_new_tokens=3))
    eng.run()
    eng.submit(Request(uid="again", prompt=p, max_new_tokens=6))
    outs = eng.run()
    assert len(forks) == 1
    src, dst = forks[0]
    for pool in (eng.ks, eng.vs, eng.kc, eng.vc):
        assert torch.equal(pool[:, dst], pool[:, src])
    assert bool((eng.ks[:, dst] > 0).all())
    solo = generate(model, gpt_tiny(), p[None], 6, device="cpu",
                    kv_dtype="int8").numpy()[0, len(p):]
    np.testing.assert_array_equal(outs["again"], solo)


def test_train_toy_lm_returns_the_serving_layout():
    cfg, model, ids = train_toy_lm(steps=2, device="cpu")
    assert ids.shape == (8, 64) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids[0, :4], [0, 7, 14, 5])
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    again = train_toy_lm(steps=2, device="cpu")[1]
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
