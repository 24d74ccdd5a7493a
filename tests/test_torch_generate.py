"""apex_tpu_torch ``generate()`` against JAX ``generate()`` (jnp path)
on the CPU, fp32.

Greedy tokens must be equal wherever JAX's top-2 logit margin at that
step exceeds 1e-3.  A divergence at a smaller margin is a recorded near
tie, not a failure: two frameworks round the same fp32 math differently
and can flip a pick that close; after it the streams are no longer
comparable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import gpt_tiny as jax_gpt_tiny
from apex_tpu.models.generate import generate as jax_generate
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.models.generate import generate, greedy_argmax
from apex_tpu_torch.testing import assert_tokens_match_above_margin


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt_tiny()
    params = JaxGPT(jcfg).init(jax.random.PRNGKey(3),
                               jnp.zeros((1, 4), jnp.int32))["params"]
    model = params_from_jax(jax.tree.map(np.asarray, params), gpt_tiny(),
                            device="cpu")
    return jcfg, params, model


def _margins(jcfg, params, seq, lp):
    """JAX's top-2 logit gap at each generated step of ``seq``."""
    logits = np.asarray(JaxGPT(jcfg).apply({"params": params},
                                           jnp.asarray(seq[None])))[0]
    top2 = np.sort(logits[lp - 1:len(seq) - 1], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("n_prompt", [4, 13, 30])
def test_greedy_tokens_match_jax(setup, n_prompt):
    jcfg, params, model = setup
    prompt = np.random.RandomState(n_prompt).randint(0, 512, (n_prompt,))
    want = np.asarray(jax_generate(params, jcfg, jnp.asarray(prompt[None]),
                                   10))[0]
    got = generate(model, gpt_tiny(), prompt[None], 10,
                   device="cpu").numpy()[0]
    np.testing.assert_array_equal(got[:n_prompt], prompt)
    assert_tokens_match_above_margin(
        got[n_prompt:], want[n_prompt:],
        lambda: _margins(jcfg, params, want, n_prompt))


def test_batched_prompts_decode_each_row(setup):
    _, _, model = setup
    prompts = np.random.RandomState(9).randint(0, 512, (3, 6))
    both = generate(model, gpt_tiny(), prompts, 5, device="cpu")
    for i in range(3):
        one = generate(model, gpt_tiny(), prompts[i:i + 1], 5,
                       device="cpu")
        assert torch.equal(both[i], one[0])


def test_greedy_argmax_picks_the_lowest_tied_index():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [2.0, 2.0, 2.0, 2.0]])
    assert greedy_argmax(logits).tolist() == [1, 0]
    nan = torch.full((1, 4), float("nan"))
    assert greedy_argmax(nan).tolist() == [3]


def test_sampling_reproduces_from_its_generator(setup):
    _, _, model = setup
    prompt = np.arange(7)[None]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(model, gpt_tiny(), prompt, 12, temperature=1.5,
                        generator=g, device="cpu")
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    with pytest.raises(ValueError, match="generator"):
        generate(model, gpt_tiny(), prompt, 2, temperature=1.0,
                 device="cpu")
