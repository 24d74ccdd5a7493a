"""amp O2 with ``half_dtype=torch.float16`` (NVIDIA Apex's classic O2:
fp16 compute, fp32 masters, a dynamic loss scale) on a 2-layer GPT: the
port's train step (``amp.initialize`` + ``FusedAdam`` +
``make_train_step``, on the CPU through the kernels' plain versions)
against the JAX package's ``make_train_step(amp.initialize(FusedAdam(lr=
3e-3), opt_level="O2", half_dtype=jnp.float16), loss_fn)`` from the same
initial parameters, on the synthetic stream of ``examples/gpt_lm.py``, for
3 steps.  On the card the same step reaches the layer-norm, flash, unscale
and Adam kernels in fp16 (``tests/test_torch_gpu.py``, ``chip_smoke.py``'s
``fp16_o2`` phase).

Tolerance: per-step losses within ``2e-2`` absolute, the bound of the bf16
O2 test (``tests/test_torch_train.py``): XLA on the CPU and PyTorch round
the half activations at other places (fused elementwise chains against one
rounding per op), and the port's attention rotates with half tables (the
kernel format) where the JAX CPU path rotates in fp32.  fp16 keeps three
more mantissa bits than bf16, so the measured gap is smaller (~3e-4); the
bound is not tightened, since it is the rounding places and not the type
that set it.  ``loss_scale`` and ``overflow`` must be equal at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import GPTConfig, lm_loss
from apex_tpu_torch.optimizers import FusedAdam

STEPS = 3
CONFIGS = {
    "tiny": dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128),
    # head width 64, the tensor-core kernels' on the card
    "d64": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=256),
}


def _stream(vocab, b=4, l=32):
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return ((base + np.arange(l)[None, :]) % vocab).astype(np.int32)


def _jax_run(kw, ids):
    model = JaxGPT(JaxConfig(**kw))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.asarray(ids[:, :16]))["params"]
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3), opt_level="O2",
                           half_dtype=jnp.float16, verbosity=0)
    state = a.init(params)

    def loss_fn(p, x):
        return jax_lm_loss(model.apply({"params": p}, x)[:, :-1], x[:, 1:])

    step = jax.jit(jax_amp.make_train_step(a, loss_fn))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jnp.asarray(ids))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return jax.tree.map(np.asarray, params), metrics


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o2_fp16_steps_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    tree, jm = _jax_run(kw, ids)
    model = params_from_jax(tree, GPTConfig(**kw), device="cpu",
                            trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device="cpu"),
                       opt_level="O2", half_dtype=torch.float16,
                       device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    x = torch.from_numpy(ids).long()
    tm = []
    for _ in range(STEPS):
        m = step(x)
        tm.append({k: float(m[k]) for k in ("loss", "loss_scale",
                                            "overflow")})
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 2e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"]
        assert j["overflow"] == t["overflow"]
    assert tm[-1]["loss"] < tm[0]["loss"]
    # fp16 compute parameters, the rounding of the fp32 masters
    assert all(p.dtype == torch.float16 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in a.masters.values())
    for n, p in model.named_parameters():
        assert torch.equal(p, a.masters[n].to(torch.float16)), n


def test_o2_fp16_overflow_is_skipped():
    """An fp16 gradient that overflows (a loss times inf) skips the step:
    masters unchanged, the scale halved, as JAX's dynamic scaler does."""
    kw = CONFIGS["tiny"]
    ids = _stream(kw["vocab_size"])
    tree = JaxGPT(JaxConfig(**kw)).init(jax.random.PRNGKey(0),
                                        jnp.asarray(ids[:, :16]))["params"]
    model = params_from_jax(jax.tree.map(np.asarray, tree),
                            GPTConfig(**kw), device="cpu", trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device="cpu"),
                       opt_level="O2", half_dtype=torch.float16,
                       device="cpu")
    before = {n: t.clone() for n, t in a.masters.items()}
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]) * float("inf"))
    m = step(torch.from_numpy(ids).long())
    assert float(m["overflow"]) == 1.0
    assert float(m["loss_scale"]) == 2.0 ** 15
    assert all(torch.equal(before[n], t) for n, t in a.masters.items())
