"""The serving slice is untouched by the training slice: ``generate()``
and ``ServeEngine`` run under ``no_grad`` and must never enter the
layer-norm or flash-attention ``autograd.Function``s (so they cost serving
nothing and launch exactly the forward kernels), and their greedy tokens
stay the ones the serving slice produced before the backward kernels
existed (pinned below, fp32 and bf16, from a seeded model)."""

import numpy as np
import pytest
import torch

from apex_tpu_torch.attention import FlashAttention
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.normalization.fused_layer_norm import LayerNormFunction
from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine

CFG = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=256)
#: greedy tokens of the three prompts below, 6 new each, recorded on the
#: serving slice's tree (identical in fp32 and bf16 for this model)
PINNED = [[426, 418, 69, 460, 433, 434], [487, 446, 54, 434, 311, 222],
          [189, 487, 45, 26, 310, 26]]


@pytest.fixture
def no_autograd_functions(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the serving path entered an autograd.Function")
    monkeypatch.setattr(FlashAttention, "apply", refuse)
    monkeypatch.setattr(LayerNormFunction, "apply", refuse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_outputs_are_unchanged(dtype, no_autograd_functions):
    torch.manual_seed(3)
    model = GPTModel(CFG, device="cpu").requires_grad_(False).to(dtype)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, (n,)) for n in (7, 13, 4)]
    solo = [generate(model, CFG, p[None], 6, device="cpu")[0, len(p):]
            .tolist() for p in prompts]
    eng = ServeEngine(model, CFG, ServeConfig(
        num_slots=2, block_size=4, num_blocks=17, max_blocks_per_slot=8,
        prefill_chunk=4), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=6))
    out = eng.run()
    assert solo == PINNED
    assert [out[f"r{i}"].tolist() for i in range(3)] == PINNED


def test_a_trainable_model_under_no_grad_skips_them_too(
        no_autograd_functions):
    torch.manual_seed(3)
    model = GPTModel(CFG, device="cpu")   # parameters require grad
    with torch.no_grad():
        logits = model(torch.zeros((1, 5), dtype=torch.long))
    assert logits.grad_fn is None
