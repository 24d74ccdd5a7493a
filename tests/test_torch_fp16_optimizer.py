"""The port's flat-buffer ``FP16Optimizer`` and ``fp16_utils`` (on the CPU
through the kernels' plain versions) against the JAX package's
``apex_tpu.optimizers.FP16Optimizer`` and ``apex_tpu.fp16_utils.
fp16util`` (their jnp paths), on the same values made with numpy.

Tolerances: the flat fp32 master within ``1e-6`` absolute after 5 steps
(both run the same fp32 Adam arithmetic; the bias-corrected step size
and the clip's combined scale go through ``pow``, ``sqrt`` and a
division whose last bit two libraries may round differently);
``overflow`` and ``loss_scale`` equal at every step; ``grad_norm``
within ``1e-6`` relative (an fp32 sum of squares in another order).
The fused copies of ``fp16util`` bitwise; its norms within ``1e-6``
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.fp16_utils import fp16util as jfu
from apex_tpu.optimizers import FP16Optimizer as JaxFP16Optimizer
from apex_tpu_torch import fp16_utils as tfu
from apex_tpu_torch.ops.cuda import packed_adam, packed_sumsq
from apex_tpu_torch.optimizers import FP16Optimizer

STEPS = 5


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": (rng.standard_normal((64, 48)) * 0.05)
                      .astype(np.float32),
                      "bias": np.zeros(48, np.float32)},
            "embed": (rng.standard_normal((70000,)) * 0.02)
            .astype(np.float32),
            "ln": {"scale": np.ones(48, np.float32)}}


def _grads(tree, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2
                                   * scale).astype(np.float32), tree)


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0])
@pytest.mark.parametrize("dynamic", [False, True])
def test_fp16_optimizer_matches_jax(dynamic, max_grad_norm):
    """5 steps from scaled bf16 gradients; step 3 holds an inf, which both
    skip (the dynamic scale halves, the static one stays)."""
    tree = _tree()
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=max_grad_norm,
              dynamic_loss_scale=dynamic, static_loss_scale=128.0)
    jopt = JaxFP16Optimizer(jax.tree.map(jnp.asarray, tree), **kw)
    js = jopt.init()
    leaves = jax.tree.leaves(tree)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in leaves]
    opt = FP16Optimizer(params, device="cpu", **kw)
    assert all(p.dtype == torch.bfloat16 for p in params)
    total = sum(a.size for a in leaves)
    for s in range(STEPS):
        scale = float(js.scaler_state.loss_scale)
        assert float(opt.loss_scale) == scale
        g = _grads(tree, 10 + s, scale)
        if s == 2:
            g["dense"]["kernel"][3, 4] = np.inf
        gl = jax.tree.leaves(g)
        js, jhalf, jinfo = jopt.step(js, jax.tree.map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), g))
        info = opt.step([torch.from_numpy(a).to(torch.bfloat16)
                         for a in gl])
        assert bool(info["overflow"]) == bool(jinfo["overflow"]) == (s == 2)
        assert float(info["loss_scale"]) == float(jinfo["loss_scale"])
        if s != 2:
            np.testing.assert_allclose(float(info["grad_norm"]),
                                       float(jinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(opt.master.numpy(),
                                   np.asarray(js.master)[:total], atol=1e-6,
                                   rtol=0)
        # the model's parameters are the bf16 copy of the flat master
        for p, m in zip(params, opt.master_params()):
            assert torch.equal(p, m.to(torch.bfloat16))
    assert int(opt.step_count) == int(js.step) == STEPS - 1
    if dynamic:
        assert float(opt.loss_scale) == 2.0 ** 15


def test_one_k5_and_one_k9_call_a_step_and_the_state_round_trips():
    tree = _tree(1)
    leaves = jax.tree.leaves(tree)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in leaves]
    opt = FP16Optimizer(params, lr=1e-2, dynamic_loss_scale=True,
                        max_grad_norm=1.0, device="cpu")
    calls = {"adam": 0, "sumsq": 0}
    import apex_tpu_torch.optimizers.fp16_optimizer as mod

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap
    mod.packed_adam = counted("adam", packed_adam)
    mod.packed_sumsq = counted("sumsq", packed_sumsq)
    try:
        for s in range(2):
            opt.step([torch.from_numpy(a).to(torch.bfloat16) for a in
                      jax.tree.leaves(_grads(tree, s, 1024.0))])
    finally:
        mod.packed_adam, mod.packed_sumsq = packed_adam, packed_sumsq
    assert calls == {"adam": 2, "sumsq": 2}
    sd = {k: v.clone() for k, v in opt.state_dict().items()}
    params2 = [torch.nn.Parameter(torch.from_numpy(a.copy()))
               for a in leaves]
    opt2 = FP16Optimizer(params2, lr=1e-2, dynamic_loss_scale=True,
                         max_grad_norm=1.0, device="cpu")
    opt2.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(params, params2))
    g = [torch.from_numpy(a).to(torch.bfloat16) for a in
         jax.tree.leaves(_grads(tree, 9, 1024.0))]
    i1, i2 = opt.step(g), opt2.step(g)
    assert torch.equal(opt.master, opt2.master)
    assert float(i1["grad_norm"]) == float(i2["grad_norm"])
    with pytest.raises(ValueError, match="gradients for"):
        opt.step(g[:-1])


def _fu_tree(seed=2):
    rng = np.random.RandomState(seed)
    return {"conv": {"kernel": rng.standard_normal((5, 3)).astype(
                np.float32)},
            "bn": {"scale": rng.standard_normal(3).astype(np.float32)},
            "head": [rng.standard_normal(70001).astype(np.float32) * 3,
                     rng.standard_normal(4).astype(np.float32)]}


def _to_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)
                                                   .copy()).to(
        dtype or torch.float32), tree)


def _same(t_tree, j_tree, exact=True):
    tl, jl = jax.tree.leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        want = np.asarray(jnp.asarray(j).astype(jnp.float32))
        if exact:
            np.testing.assert_array_equal(t.float().numpy(), want)
        else:
            np.testing.assert_allclose(t.float().numpy(), want, rtol=1e-6)


def test_fp16util_conversions_match_jax():
    tree = _fu_tree()
    jt = jax.tree.map(jnp.asarray, tree)
    tt = _to_torch(tree)
    _same(tfu.tree_to_half(tt), jfu.tree_to_half(jt))
    _same(tfu.tree_to_float(tfu.tree_to_half(tt)),
          jfu.tree_to_float(jfu.tree_to_half(jt)))
    _same(tfu.convert_network(tt, torch.bfloat16),
          jfu.convert_network(jt, jnp.bfloat16))
    _same(tfu.BN_convert_float(tfu.tree_to_half(tt)),
          jfu.BN_convert_float(jfu.tree_to_half(jt)))
    # a module converts in place, with the same filter on its names
    m = torch.nn.Module()
    m.conv = torch.nn.Linear(3, 5)
    m.bn = torch.nn.LayerNorm(5)
    assert tfu.convert_network(m, torch.bfloat16) is m
    assert m.conv.weight.dtype == torch.bfloat16
    assert m.bn.weight.dtype == torch.float32


def test_fp16util_master_params_match_jax():
    tree = _fu_tree()
    jt = jax.tree.map(jnp.asarray, tree)
    tt = _to_torch(tree, torch.bfloat16)
    jh = jfu.tree_to_half(jt)
    _, tm = tfu.prep_param_lists(tt)
    _, jm = jfu.prep_param_lists(jh)
    _same(tm, jm)
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(jax.tree.leaves(tm), jax.tree.leaves(tt)))
    _, (tflat, tun) = tfu.prep_param_lists(tt, flat_master=True)
    _, (jflat, jun) = jfu.prep_param_lists(jh, flat_master=True)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    _same(tun(tflat), jun(jflat))
    _same(tfu.model_grads_to_master_grads(tt),
          jfu.model_grads_to_master_grads(jh))
    _same(tfu.master_params_to_model_params(_to_torch(tree), torch.bfloat16),
          jfu.master_params_to_model_params(jt, jnp.bfloat16))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_grad_norm_matches_jax(max_norm):
    tree = _fu_tree(3)
    jt = jfu.tree_to_half(jax.tree.map(jnp.asarray, tree))
    tt = _to_torch(tree, torch.bfloat16)
    tc, tn = tfu.clip_grad_norm(tt, max_norm)
    jc, jn = jfu.clip_grad_norm(jt, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for t, j in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert t.dtype == torch.bfloat16
        # one bf16 rounding of an fp32 product whose factor agrees to 1e-6
        np.testing.assert_allclose(
            t.float().numpy(), np.asarray(j.astype(jnp.float32)),
            rtol=2.0 ** -8, atol=0)
    tc1, tn1 = tfu.clip_grad_norm(tt, max_norm, norm_type=1.0)
    jc1, jn1 = jfu.clip_grad_norm(jt, max_norm, norm_type=1.0)
    np.testing.assert_allclose(float(tn1), float(jn1), rtol=1e-6)


def test_fp16_model_runs_the_network_in_half():
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 3)
    ref = torch.nn.Linear(4, 3)
    ref.load_state_dict(net.state_dict())
    m = tfu.FP16Model(net)
    x = torch.randn(2, 4)
    y = m(x)
    assert y.dtype == torch.bfloat16 and net.weight.dtype == torch.bfloat16
    want = torch.nn.functional.linear(x.bfloat16(), ref.weight.bfloat16(),
                                      ref.bias.bfloat16())
    assert torch.equal(y, want)
