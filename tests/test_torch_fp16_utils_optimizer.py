"""The port's legacy master-weight wrapper (``apex_tpu_torch.fp16_utils.
FP16_Optimizer``) against the JAX package's ``apex_tpu.fp16_utils.
FP16Optimizer``, on the conformance MLP ``(64, 64)`` over 32 features, 6
steps from the same weights and data (numpy, seed 0):

- inner SGD(0.05, momentum 0.9) (optax's ``sgd`` with momentum is
  PyTorch's SGD with ``dampening=0``) and the port's ``FusedAdam(1e-2)``
  (JAX's ``FusedAdam``);
- a static scale of 128, a dynamic one (init ``2**10``, window 2) with an
  inf planted in step 2's input, and a ``clip_norm`` of 0.5.

fp32 model: losses and masters within 1e-5; scales and overflows equal.
A bf16 model (the O2 layout: fp32 masters, bf16 copies, bf16 inputs):
scales and overflows equal, losses within 2e-2; XLA's and PyTorch's bf16
products round differently, so the masters are held to what the inner
optimizer can make of that: SGD's within 1e-2 (2^-8 of a gradient,
carried by lr 0.05 and momentum over 5 steps; measured 2.4e-3), Adam's
within its drift bound, twice lr a step taken (Adam moves an element by
at most about lr a step whatever its gradient: its first steps are
sign-like, and a small gradient's sign can differ; measured 3.1e-2).
``state_dict`` round-trips: a restored wrapper steps on bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.fp16_utils import FP16Optimizer as JaxFP16Optimizer
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_ce
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.convert import mlp_params_from_jax
from apex_tpu_torch.fp16_utils import FP16_Optimizer, FP16Optimizer
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam

STEPS = 6
FEATURES = (64, 64)
IN = 32


def _data(seed=0, inject_at=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(STEPS, 32, IN).astype(np.float32)
    y = rng.randint(0, 10, (STEPS, 32))
    if inject_at is not None:
        x[inject_at, 0, 0] = np.inf
    return x, y


def _jax_params(seed=0):
    return JaxMLP(features=FEATURES).init(jax.random.PRNGKey(seed),
                                          jnp.zeros((1, IN)))["params"]


def _names(params):
    return [(layer, leaf) for layer in sorted(params)
            for leaf in ("kernel", "bias")]


def _jax_run(inner, half, steps=STEPS, inject_at=None, clip_norm=None,
             **kw):
    model = JaxMLP(features=FEATURES)
    params = _jax_params()
    dtype = jnp.bfloat16 if half else jnp.float32
    opt = JaxFP16Optimizer(tx=inner, model_dtype=dtype, **kw)
    state = opt.init(params)
    x, y = _data(inject_at=inject_at)

    def loss_fn(p, xb, yb):
        return jax_ce(model.apply({"params": p}, xb).astype(jnp.float32), yb)

    losses, scales, overflows = [], [], []
    for i in range(steps):
        loss, grads = opt.backward(state, loss_fn,
                                   jnp.asarray(x[i], dtype), jnp.asarray(y[i]))
        state, info = opt.step(state, grads, clip_norm=clip_norm)
        losses.append(float(loss))
        scales.append(float(info["loss_scale"]))
        overflows.append(bool(info["overflow"]))
    masters = [np.asarray(state.master_params[l][k])
               for l, k in _names(params)]
    return losses, scales, overflows, masters


def _port_model(half):
    model = mlp_params_from_jax(_jax_params(), FEATURES, in_features=IN,
                                device="cpu", trainable=True)
    if half:
        model = model.to(torch.bfloat16)
    return model


def _port_opt(kind, model, **kw):
    inner = (torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
             if kind == "sgd" else
             FusedAdam(model.parameters(), lr=1e-2, device="cpu"))
    return FP16_Optimizer(inner, **kw)


def _port_steps(opt, model, half, first, last, inject_at=None,
                clip_norm=None):
    x, y = _data(inject_at=inject_at)
    dtype = torch.bfloat16 if half else torch.float32
    losses, scales, overflows = [], [], []
    for i in range(first, last):
        opt.zero_grad()
        loss = cross_entropy_loss(
            model(torch.from_numpy(x[i]).to(dtype)).float(),
            torch.from_numpy(y[i]))
        opt.backward(loss)
        info = opt.step(clip_norm=clip_norm)
        losses.append(float(loss.detach()))
        scales.append(float(info["loss_scale"]))
        overflows.append(bool(info["overflow"]))
    return losses, scales, overflows


def _port_run(kind, half, inject_at=None, clip_norm=None, **kw):
    model = _port_model(half)
    opt = _port_opt(kind, model, **kw)
    out = _port_steps(opt, model, half, 0, STEPS, inject_at, clip_norm)
    return out + ([m.detach().numpy() for m in opt.master_params],
                  model, opt)


def _inner(kind):
    return (optax.sgd(0.05, momentum=0.9) if kind == "sgd"
            else JaxFusedAdam(lr=1e-2))


CASES = {
    "static128": dict(static_loss_scale=128.0),
    "dynamic_inf_at_2": dict(dynamic_loss_scale=True, init_scale=2.0 ** 10,
                             scale_window=2, inject_at=2),
    "clip0.5": dict(static_loss_scale=1.0, clip_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["sgd", "fused_adam"])
def test_fp32_model_matches_jax(kind, case):
    kw = CASES[case]
    want = _jax_run(_inner(kind), False, **kw)
    got = _port_run(kind, False, **kw)
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    if kw.get("inject_at") is not None:
        assert got[2][kw["inject_at"]] and sum(got[2]) == 1
        assert not np.isnan(got[0][-1])


@pytest.mark.parametrize("kind", ["sgd", "fused_adam"])
def test_bf16_model_tracks_jax(kind):
    kw = CASES["dynamic_inf_at_2"]
    want = _jax_run(_inner(kind), True, **kw)
    got = _port_run(kind, True, **kw)
    assert got[1] == want[1] and got[2] == want[2]
    finite = [i for i in range(STEPS) if not got[2][i]]
    np.testing.assert_allclose(np.asarray(got[0])[finite],
                               np.asarray(want[0])[finite], rtol=0,
                               atol=2e-2)
    taken = STEPS - sum(got[2])
    tol = 1e-2 if kind == "sgd" else 2 * 1e-2 * taken * 1.01
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    model = got[4]
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    for p, m in zip(model.parameters(), got[5].master_params):
        assert torch.equal(p.detach(), m.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["sgd", "fused_adam"])
def test_state_dict_round_trips(kind):
    kw = dict(dynamic_loss_scale=True, init_scale=2.0 ** 10, scale_window=2)
    model = _port_model(False)
    opt = _port_opt(kind, model, **kw)
    _port_steps(opt, model, False, 0, 3)
    saved = opt.state_dict()
    assert float(saved["loss_scale"]) == 2.0 ** 11
    assert int(saved["unskipped"]) == 1
    other = _port_model(False)
    restored = _port_opt(kind, other, **kw)
    restored.load_state_dict(saved)
    assert all(torch.equal(p, q) for p, q in
               zip(other.parameters(), model.parameters()))
    a = _port_steps(opt, model, False, 3, STEPS)
    b = _port_steps(restored, other, False, 3, STEPS)
    assert a == b
    assert all(torch.equal(m, n) for m, n in
               zip(opt.master_params, restored.master_params))


def test_update_master_grads_and_clip_match_jax():
    model = _port_model(False)
    opt = _port_opt("sgd", model, static_loss_scale=64.0)
    x, y = _data()
    loss = cross_entropy_loss(model(torch.from_numpy(x[0])),
                              torch.from_numpy(y[0]))
    opt.backward(loss)
    grads, finite = opt.update_master_grads()
    assert bool(finite) and all(g.dtype == torch.float32 for g in grads)
    clipped, norm = opt.clip_master_grads(grads, 0.1)
    jopt = JaxFP16Optimizer(tx=optax.sgd(0.05), static_loss_scale=64.0,
                            model_dtype=jnp.float32)
    state = jopt.init(_jax_params())
    jmodel = JaxMLP(features=FEATURES)
    _, jgrads = jopt.backward(
        state, lambda p, xb, yb: jax_ce(jmodel.apply({"params": p}, xb), yb),
        jnp.asarray(x[0]), jnp.asarray(y[0]))
    master, jfinite = jopt.update_master_grads(state, jgrads)
    jclipped, jnorm = jopt.clip_master_grads(master, 0.1)
    assert bool(jfinite)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    names = _names(state.master_params)
    for g, (l, k) in zip(clipped, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(jclipped[l][k]),
                                   rtol=0, atol=1e-6)


def test_step_with_closure_and_refusals():
    model = _port_model(False)
    opt = _port_opt("sgd", model, static_loss_scale=8.0)
    x, y = _data()
    loss, info = opt.step_with_closure(lambda: cross_entropy_loss(
        model(torch.from_numpy(x[0])), torch.from_numpy(y[0])))
    assert not bool(info["overflow"]) and float(info["loss_scale"]) == 8.0
    assert np.isfinite(float(loss.detach()))
    assert FP16_Optimizer is FP16Optimizer
    p = torch.nn.Parameter(torch.ones(3))
    inner = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    p.grad = torch.ones(3)
    inner.step()
    with pytest.raises(ValueError, match="not stepped"):
        FP16Optimizer(inner)
