"""The port's GPT train step (``amp.initialize`` + ``FusedAdam`` +
``make_train_step``, on the CPU through the kernels' plain versions)
against the JAX package's ``make_train_step(amp.initialize(FusedAdam(lr=
3e-3), opt_level=...), loss_fn)`` (its jnp path), from the same initial
parameters, on the synthetic stream of ``examples/gpt_lm.py`` (next
token = token + 1), for 7 steps.

Tolerances:

- O0 (fp32): per-step losses within ``1e-5`` absolute (measured: at
  most 1e-6).  Final fp32 masters: every element within ``1e-4`` and
  all but 0.01% of them within ``1e-5``.  Both run the same fp32 math,
  but the frameworks sum matmuls, softmax and layer-norm rows in other
  orders: the first step's gradients agree within ~1e-7 absolute
  (checked here at ``5e-7``), and over 7 Adam steps at lr 3e-3, whose
  ``m / sqrt(v)`` normalises every element's step, a handful of
  elements drift apart by up to ~5e-5 (measured) while the rest stay
  within 1e-5.
- O2 (bf16 compute, fp32 masters) and O3 (bf16 compute, no masters:
  FusedAdam steps the bf16 parameters with bf16 gradients): per-step
  losses within ``2e-2`` absolute.  XLA on the CPU and PyTorch round bf16 activations at other
  places (fused elementwise chains vs one rounding per op), and the
  port's attention rotates with bf16 tables (the kernel format) where
  the JAX CPU path rotates in fp32; ``loss_scale`` and ``overflow`` must
  be equal at every step.  The O2 cast leaves ``ln*`` in bf16 on both
  sides.
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
from apex_tpu_torch.convert import params_from_jax, params_to_numpy
from apex_tpu_torch.models import GPTConfig, lm_loss
from apex_tpu_torch.optimizers import FusedAdam

STEPS = 7
CONFIGS = {
    "tiny": dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128),
    # head width 64, the kernels' on the card
    "d64": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=256),
}


def _stream(vocab, b=4, l=32):
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return ((base + np.arange(l)[None, :]) % vocab).astype(np.int32)


def _jax_run(kw, opt_level, ids):
    model = JaxGPT(JaxConfig(**kw))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.asarray(ids[:, :16]))["params"]
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3),
                           opt_level=opt_level, verbosity=0)
    state = a.init(params)

    def loss_fn(p, x):
        logits = model.apply({"params": p}, x)
        return jax_lm_loss(logits[:, :-1], x[:, 1:])

    step = jax.jit(jax_amp.make_train_step(a, loss_fn))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jnp.asarray(ids))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return (jax.tree.map(np.asarray, params), metrics,
            jax.tree.map(np.asarray, state.master_params))


def _torch_run(kw, opt_level, tree, ids):
    model = params_from_jax(tree, GPTConfig(**kw), device="cpu",
                            trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device="cpu"),
                       opt_level=opt_level, device="cpu")

    def loss_fn(m, x):
        return lm_loss(m(x)[:, :-1], x[:, 1:])

    step = amp.make_train_step(a, model, loss_fn)
    x = torch.from_numpy(ids).long()
    metrics = []
    for _ in range(STEPS):
        m = step(x)
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return model, a, metrics


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o0_fp32_steps_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    tree, jm, jmaster = _jax_run(kw, "O0", ids)
    model, a, tm = _torch_run(kw, "O0", tree, ids)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 1e-5, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"] == 1.0
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    got = dict(_leaves(params_to_numpy(a.masters)))
    want = dict(_leaves(jmaster))
    assert set(got) == set(want)
    beyond, total = 0, 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-4, rtol=0,
                                   err_msg="/".join(path))
        beyond += int((np.abs(got[path] - w) > 1e-5).sum())
        total += w.size
    assert beyond <= 1e-4 * total, (beyond, total)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o0_first_step_gradients_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    jmodel = JaxGPT(JaxConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(ids[:, :16]))["params"]
    x = jnp.asarray(ids)
    want = jax.grad(lambda p: jax_lm_loss(
        jmodel.apply({"params": p}, x)[:, :-1], x[:, 1:]))(params)
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            GPTConfig(**kw), device="cpu", trainable=True)
    t = torch.from_numpy(ids).long()
    lm_loss(model(t)[:, :-1], t[:, 1:]).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[tuple(name.split("."))],
                                   atol=5e-7, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o2_bf16_steps_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    tree, jm, _ = _jax_run(kw, "O2", ids)
    model, a, tm = _torch_run(kw, "O2", tree, ids)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 2e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"]
        assert j["overflow"] == t["overflow"]
    assert tm[-1]["loss"] < tm[0]["loss"]
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["block_0.ln1.scale"] == torch.bfloat16
    assert dtypes["ln_f.bias"] == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in a.masters.values())
    # the compute params are the bf16 rounding of the masters
    for n, p in model.named_parameters():
        assert torch.equal(p, a.masters[n].to(torch.bfloat16)), n


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o3_bf16_steps_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    tree, jm, jparams = _jax_run(kw, "O3", ids)
    model, a, tm = _torch_run(kw, "O3", tree, ids)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 2e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"] == 1.0
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    # no masters: the optimizer stepped the model's own bf16 parameters,
    # and JAX carried bf16 parameters too
    assert all(a.masters[n] is p for n, p in model.named_parameters())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(w.dtype == jnp.bfloat16 for _, w in _leaves(jparams))
    for p in model.parameters():
        st = a.optimizer.state[p]
        assert st["exp_avg"].dtype == torch.float32
        assert int(st["step"]) == STEPS
