"""``params_from_jax``: a JAX GPT checkpoint brought across in both the
loop layout (``block_{i}``) and the scan layout (``layers/block``); the
port's ``GPTModel.forward`` logits against JAX ``GPTModel.apply`` (its
jnp path) in fp32 within ``atol = 1e-4`` (rope tables, layer norm and
softmax round differently in the two frameworks, and the differences
pass through several layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import gpt_tiny as jax_gpt_tiny
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import GPTConfig, gpt_tiny

#: 2 layers at hidden 128, so the layer norm sees a multiple of 128
WIDE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256)


def _init(jcfg, seed=1):
    params = jax.jit(JaxGPT(jcfg).init)(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 4), jnp.int32))["params"]
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kind", ["tiny", "wide"])
def test_loop_layout_logits_match_jax(kind):
    jcfg = jax_gpt_tiny() if kind == "tiny" else JaxConfig(**WIDE)
    cfg = gpt_tiny() if kind == "tiny" else GPTConfig(**WIDE)
    params, tree = _init(jcfg)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 19))
    want = np.asarray(jax.jit(JaxGPT(jcfg).apply)({"params": params},
                                                  jnp.asarray(ids)))
    model = params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_scan_layout_loads_and_matches_jax():
    jcfg = dataclasses.replace(jax_gpt_tiny(), scan_layers=True)
    params, tree = _init(jcfg, seed=2)
    assert "layers" in tree
    ids = np.random.RandomState(1).randint(0, 512, (1, 11))
    want = np.asarray(jax.jit(JaxGPT(jcfg).apply)({"params": params},
                                                  jnp.asarray(ids)))
    model = params_from_jax(tree, gpt_tiny(), device="cpu")
    np.testing.assert_array_equal(
        model.block_1.attention.qkv.kernel.numpy(),
        tree["layers"]["block"]["attention"]["qkv"]["kernel"][1])
    got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_leaves_and_the_o2_serving_cast():
    params, tree = _init(jax_gpt_tiny())
    o2 = amp.initialize(opt_level="O2", verbosity=0).model_params_from(
        params)
    o2_tree = jax.tree.map(np.asarray, o2)
    from_bf16 = params_from_jax(o2_tree, gpt_tiny(), device="cpu")
    cast_here = params_from_jax(tree, gpt_tiny(), device="cpu",
                                dtype=torch.bfloat16)
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[".".join(prefix + (k,))] = v
    walk(o2_tree, ())
    for name, p in from_bf16.state_dict().items():
        want = flat[name]
        assert str(want.dtype) == "bfloat16" and p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.float().numpy(),
                                      want.astype(np.float32))
        assert torch.equal(p, cast_here.state_dict()[name])
    assert not any(p.requires_grad for p in from_bf16.parameters())


def test_names_must_match_the_model():
    _, tree = _init(jax_gpt_tiny())
    del tree["ln_f"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tree, gpt_tiny(), device="cpu")
