"""The port's weight normalization (``apex_tpu_torch.reparameterization``)
against the JAX package's on the CPU, on the MLP of
``tests/l0/test_reparameterization.py`` (JAX's initial parameters, or
seeded numpy tensors): the decomposition's shapes and its identity,
``dim=None``, ``‖w‖ == g``, the ``name=`` restriction, the gradients with
respect to ``g`` and ``v``, 20 SGD steps and the round trip after them,
each within 1e-6 (the decomposition) or 1e-5 (gradients and training).
The module form (forward-pre hooks) agrees with the dict form, and under
amp O2 its ``_g`` / ``_v`` leaves are cast as JAX casts them."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_xent
from apex_tpu.reparameterization import WeightNorm as JaxWeightNorm
from apex_tpu.reparameterization import apply_weight_norm as jax_apply
from apex_tpu.reparameterization import merge as jax_merge
from apex_tpu.reparameterization import remove_weight_norm as jax_remove
from apex_tpu.reparameterization import reparameterized_apply as jax_rapply
from apex_tpu_torch import amp
from apex_tpu_torch.convert import mlp_params_from_jax
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.reparameterization import (
    WeightNorm,
    apply_weight_norm,
    merge,
    remove_weight_norm,
    reparameterized_apply,
)
from apex_tpu_torch.rnn import mLSTM

DEC_TOL = 1e-6
TOL = 1e-5
FEATURES, CLASSES, IN = (16, 16), 4, 8


@pytest.fixture(scope="module")
def setup():
    jm = JaxMLP(features=FEATURES, num_classes=CLASSES)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IN)))["params"]
    rng = np.random.RandomState(3)
    x = rng.randn(64, IN).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    return jm, p, x, y


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict)
            else np.asarray(v.detach() if isinstance(v, torch.Tensor)
                            else v) for k, v in tree.items()}


def _assert_trees(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees(got[k], want[k], tol)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=k)


def _port_model():
    from apex_tpu_torch.models.mlp import MLP
    return MLP(FEATURES, CLASSES, IN, device="cpu")


def _port_apply(variables, x):
    """The port MLP as a function of its params dict (flax's variables
    layout), through ``functional_call``."""
    model = _port_model()
    flat = {f"{k}.{n}": t for k, sub in variables["params"].items()
            for n, t in sub.items()}
    return functional_call(model, flat, (x,))


def test_decomposition_shapes_and_identity(setup):
    _, p, _, _ = setup
    want = jax_apply(p)
    got = apply_weight_norm(_torch_tree(p))
    assert "kernel" not in got["AmpDense_0"] and "bias" in got["AmpDense_0"]
    assert tuple(got["AmpDense_0"]["kernel_g"].shape) == (1, 16)
    _assert_trees(_np(got), _np(want), DEC_TOL)
    _assert_trees(_np(merge(got, WeightNorm())),
                  _np(jax_merge(want, JaxWeightNorm())), DEC_TOL)
    _assert_trees(_np(merge(got, WeightNorm())), _np(p), DEC_TOL)


@pytest.mark.parametrize("dim", [None, 0, -1])
def test_dims_match_jax(dim):
    w = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    jaux = JaxWeightNorm(dim=dim, eps=1e-3).reparameterize("k", jnp.asarray(w))
    aux = WeightNorm(dim=dim, eps=1e-3).reparameterize("k", torch.tensor(w))
    _assert_trees(_np(aux), _np(jaux), DEC_TOL)
    if dim is None:
        assert tuple(aux["k_g"].shape) == (1, 1)
        np.testing.assert_allclose(float(aux["k_g"][0, 0]),
                                   np.linalg.norm(w), rtol=1e-6)
    aux["k_g"] = aux["k_g"] * 2.0
    jaux = dict(jaux, k_g=jaux["k_g"] * 2.0)
    got = WeightNorm(dim=dim, eps=1e-3).compute_weight("k", aux)
    want = JaxWeightNorm(dim=dim, eps=1e-3).compute_weight("k", jaux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DEC_TOL,
                               atol=DEC_TOL)


def test_effective_weight_norm_equals_g():
    w = torch.tensor(np.random.RandomState(2).randn(8, 4).astype(np.float32))
    wn = WeightNorm()
    aux = wn.reparameterize("kernel", w)
    aux["kernel_g"] = aux["kernel_g"] * 2.0
    merged = wn.compute_weight("kernel", aux)
    np.testing.assert_allclose(merged.norm(dim=0).numpy(),
                               aux["kernel_g"][0].numpy(), rtol=TOL)


def test_half_weights_norm_in_fp32_and_cast_back():
    w = np.random.RandomState(4).randn(16, 8).astype(np.float32)
    wb = torch.tensor(w).to(torch.bfloat16)
    aux = WeightNorm().reparameterize("k", wb)
    jaux = JaxWeightNorm().reparameterize("k", jnp.asarray(w, jnp.bfloat16))
    assert aux["k_g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(aux["k_g"].float().numpy(),
                                  np.asarray(jaux["k_g"], np.float32))
    got = WeightNorm().compute_weight("k", aux)
    want = JaxWeightNorm().compute_weight("k", jaux)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_named_leaf_restriction(setup):
    _, p, _, _ = setup
    t = _torch_tree(p)
    got = apply_weight_norm(t, name="kernel")
    assert "kernel_v" in got["AmpDense_0"]
    none = apply_weight_norm(t, name="nonexistent")
    _assert_trees(_np(none), _np(p), 0.0)
    _assert_trees(_np(apply_weight_norm(t, name="bias")),
                  _np(jax_apply(p, name="bias")), DEC_TOL)


def test_gradients_wrt_g_and_v_match_jax(setup):
    jm, p, x, y = setup
    jw = jax_apply(p)
    jfn = jax_rapply(jm.apply, JaxWeightNorm())
    jg = jax.grad(lambda q: jax_xent(jfn({"params": q}, jnp.asarray(x)),
                                     jnp.asarray(y)))(jw)
    tw = apply_weight_norm(_torch_tree(p))
    leaves = [t.requires_grad_(True) for sub in tw.values()
              for t in sub.values()]
    fn = reparameterized_apply(_port_apply, WeightNorm())
    loss = cross_entropy_loss(fn({"params": tw}, torch.tensor(x)),
                              torch.tensor(y))
    grads = torch.autograd.grad(loss, leaves)
    got = {}
    it = iter(grads)
    for k, sub in tw.items():
        got[k] = {n: next(it).numpy() for n in sub}
    assert float(np.abs(got["AmpDense_0"]["kernel_g"]).sum()) > 0
    _assert_trees(got, _np(jg), TOL)


def test_training_and_the_round_trip_match_jax(setup):
    jm, p, x, y = setup
    jfn = jax_rapply(jm.apply, JaxWeightNorm())
    jw = jax_apply(p)
    tx = optax.sgd(0.5)
    opt = tx.init(jw)

    @jax.jit
    def jstep(q, opt):
        loss, g = jax.value_and_grad(
            lambda q: jax_xent(jfn({"params": q}, jnp.asarray(x)),
                               jnp.asarray(y)))(q)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(q, up), opt, loss

    fn = reparameterized_apply(_port_apply, WeightNorm())
    tw = apply_weight_norm(_torch_tree(p))
    jl, tl = [], []
    for _ in range(20):
        jw, opt, loss = jstep(jw, opt)
        jl.append(float(loss))
        leaves = [t.requires_grad_(True) for sub in tw.values()
                  for t in sub.values()]
        loss = cross_entropy_loss(fn({"params": tw}, torch.tensor(x)),
                                  torch.tensor(y))
        grads = iter(torch.autograd.grad(loss, leaves))
        tw = {k: {n: (t - 0.5 * next(grads)).detach()
                  for n, t in sub.items()} for k, sub in tw.items()}
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[-1] < tl[0]
    _assert_trees(_np(tw), _np(jw), TOL)
    plain = remove_weight_norm(tw)
    assert "kernel" in plain["AmpDense_0"]
    assert "kernel_g" not in plain["AmpDense_0"]
    _assert_trees(_np(plain), _np(jax_remove(jw)), TOL)
    xs = torch.tensor(x[:4])
    np.testing.assert_allclose(
        _port_apply({"params": plain}, xs).numpy(),
        fn({"params": tw}, xs).numpy(), atol=TOL)


def test_module_form_agrees_with_the_dict_form(setup):
    _, p, x, y = setup
    model = mlp_params_from_jax(p, FEATURES, CLASSES, IN, device="cpu",
                                trainable=True)
    apply_weight_norm(model)
    names = sorted(n for n, _ in model.named_parameters())
    assert names == sorted(f"AmpDense_{i}.{k}" for i in range(3)
                           for k in ("bias", "kernel_g", "kernel_v"))
    loss = cross_entropy_loss(model(torch.tensor(x)), torch.tensor(y))
    mg = dict(zip([n for n, _ in model.named_parameters()],
                  torch.autograd.grad(loss, list(model.parameters()))))
    tw = apply_weight_norm(_torch_tree(p))
    leaves = [t.requires_grad_(True) for sub in tw.values()
              for t in sub.values()]
    fn = reparameterized_apply(_port_apply, WeightNorm())
    dl = cross_entropy_loss(fn({"params": tw}, torch.tensor(x)),
                            torch.tensor(y))
    dg = iter(torch.autograd.grad(dl, leaves))
    for k, sub in tw.items():
        for n, t in sub.items():
            np.testing.assert_array_equal(
                getattr(getattr(model, k), n).detach().numpy(),
                t.detach().numpy())
            np.testing.assert_allclose(mg[f"{k}.{n}"].numpy(),
                                       next(dg).numpy(), rtol=1e-6,
                                       atol=1e-7)
    assert float(loss.detach()) == pytest.approx(float(dl.detach()), rel=1e-6)
    with torch.no_grad():
        model.AmpDense_0.kernel_g.mul_(1.5)
        tw["AmpDense_0"]["kernel_g"] = tw["AmpDense_0"]["kernel_g"] * 1.5
    remove_weight_norm(model)
    plain = remove_weight_norm(tw)
    assert not any(m._forward_pre_hooks for m in model.modules())
    for k, sub in plain.items():
        for n, t in sub.items():
            np.testing.assert_array_equal(
                getattr(getattr(model, k), n).detach().numpy(),
                t.detach().numpy())


def test_o2_casts_the_g_and_v_leaves_as_jax_does():
    """amp O2 keeps only normalization-named paths in fp32: the module
    form adds no such name on the way to ``w_hh_g`` / ``w_hh_v``, so they
    go to bf16 as the JAX tree's leaves do."""
    model = mLSTM(4, 8, device="cpu")
    apply_weight_norm(model)
    a = amp.initialize(model, FusedAdam(model.parameters(), device="cpu"),
                       opt_level="O2", device="cpu")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["layer_0_fwd.w_hh_g"] == torch.bfloat16
    assert dtypes["layer_0_fwd.w_hh_v"] == torch.bfloat16
    assert all(m.dtype == torch.float32 for m in a.masters.values())
    step = amp.make_train_step(
        a, model, lambda m, xs: (m(xs)[0].float() ** 2).mean())
    info = step(torch.randn(5, 3, 4))
    assert not bool(info["overflow"])
    assert model.layer_0_fwd.w_hh.dtype == torch.bfloat16
