"""The port's SyncBatchNorm at world size one against the JAX package's
``SyncBatchNorm(axis_name=None)`` (and its exported functions), on the
CPU: the train-mode output, the gradients of the input, scale and bias,
the running stats and eval mode.

Tolerances: fp32 ``rtol = atol = 1e-5`` (SyncBN's, ``BASELINE.md:19``;
the two sum the statistics in other orders).  bf16 input: the output and
the input gradient within 1 bf16 ulp (both compute in fp32 and round
once), or ``2**-16`` absolute where the backward cancels toward zero;
the statistics, running stats and the fp32 scale / bias gradients
within ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.parallel import sync_batchnorm as jbn
from apex_tpu_torch.parallel import BatchNorm, SyncBatchNorm
from apex_tpu_torch.parallel import sync_batchnorm as tbn
from apex_tpu_torch.testing import BF16_CANCEL_ATOL, bf16_ulp_distance

SHAPE = (4, 6, 5, 8)      # NHWC


def _inputs(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = (1 + 0.2 * rng.random_sample(c)).astype(np.float32)
    return x, dy, scale, bias, mean, var


def _jax(x, dy, scale, bias, mean, var, dtype, train=True, fused=True):
    bn = jbn.SyncBatchNorm(fused_backward=fused)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    jx = jnp.asarray(x).astype(dtype)

    def f(x_, s_, b_):
        vv = {"params": {"scale": s_, "bias": b_},
              "batch_stats": v["batch_stats"]}
        y, mut = bn.apply(vv, x_, use_running_average=not train,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), (y, mut)

    (_, (y, mut)), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        jx, v["params"]["scale"], v["params"]["bias"])
    f32 = lambda a: np.array(a.astype(jnp.float32))  # noqa: E731
    return (f32(y), [f32(g) for g in grads],
            {k: np.asarray(a) for k, a in mut["batch_stats"].items()})


def _torch(x, dy, scale, bias, mean, var, dtype, train=True, fused=True):
    bn = SyncBatchNorm(x.shape[-1], fused_backward=fused, device="cpu")
    with torch.no_grad():
        for name, a in (("scale", scale), ("bias", bias), ("mean", mean),
                        ("var", var)):
            getattr(bn, name).copy_(torch.from_numpy(a))
    bn.train(train)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = bn(tx)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    grads = [tx.grad.float().numpy(), bn.scale.grad.numpy(),
             bn.bias.grad.numpy()]
    return (y.detach(), tx.grad, grads,
            {"mean": bn.mean.numpy(), "var": bn.var.numpy()})


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_fp32_matches_jax(train, fused):
    args = _inputs(0)
    jy, jg, jstats = _jax(*args, jnp.float32, train, fused)
    y, _, g, stats = _torch(*args, torch.float32, train, fused)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-5, atol=1e-5)
    if not train:       # eval mode leaves the running stats alone
        assert np.array_equal(stats["mean"], args[4])
        assert np.array_equal(stats["var"], args[5])


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_input_matches_jax(fused):
    args = _inputs(1)
    jy, jg, jstats = _jax(*args, jnp.bfloat16, fused=fused)
    y, dx, g, stats = _torch(*args, torch.bfloat16, fused=fused)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert bf16_ulp_distance(y, torch.from_numpy(jy).to(torch.bfloat16)) <= 1
    assert bf16_ulp_distance(dx, torch.from_numpy(jg[0]).to(torch.bfloat16),
                             BF16_CANCEL_ATOL) <= 1
    for a, b in zip(g[1:], jg[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        assert stats[k].dtype == np.float32
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_equals_autograd_through_the_stats(dtype):
    args = _inputs(2)
    _, _, g1, s1 = _torch(*args, dtype, fused=True)
    _, _, g0, s0 = _torch(*args, dtype, fused=False)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    for k in s1:
        assert np.array_equal(s1[k], s0[k])


def test_the_module_returns_its_output_and_updates_the_running_stats():
    args = _inputs(3)
    bn = BatchNorm(SHAPE[-1], device="cpu")
    assert BatchNorm is SyncBatchNorm
    x = torch.from_numpy(args[0])
    y = bn(x)
    assert y is not None and y.shape == x.shape and y.dtype == x.dtype
    n = x.numel() // SHAPE[-1]
    x64 = x.double().reshape(n, -1)
    torch.testing.assert_close(bn.mean, (0.1 * x64.mean(0)).float(),
                               rtol=1e-5, atol=1e-6)
    unbiased = x64.var(0, unbiased=True)
    torch.testing.assert_close(bn.var, (0.9 + 0.1 * unbiased).float(),
                               rtol=1e-5, atol=1e-6)
    # per-call use_running_average beats the training flag
    before = bn.mean.clone()
    bn(x, use_running_average=True)
    assert torch.equal(bn.mean, before)


def test_channel_axis_one_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((3, 5, 4, 2)).astype(np.float32)
    jy, _ = jbn.SyncBatchNorm(channel_axis=1).init_with_output(
        jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    bn = SyncBatchNorm(5, channel_axis=1, device="cpu")
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_a_synced_batchnorm_without_a_process_group_names_initialize():
    x = torch.zeros(2, 3, 3, 8)
    for kw in (dict(axis_name="data"),
               dict(axis_name="data", process_group=[[0, 1]])):
        bn = SyncBatchNorm(8, device="cpu", **kw)
        with pytest.raises(RuntimeError, match="initialize"):
            bn(x)
        # eval makes no collective, so it needs no group
        assert bn.eval()(x).shape == x.shape
    with pytest.raises(ValueError, match="ProcessGroup"):
        SyncBatchNorm(8, axis_name="model", device="cpu")
    with pytest.raises(ValueError, match="axis_name"):
        SyncBatchNorm(8, process_group=[[0, 1]], device="cpu")


def test_exported_functions_match_jax():
    x, dy, scale, _, mean, _ = _inputs(5)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    jx, jdy = jnp.asarray(x), jnp.asarray(dy)
    for got, want in zip(tbn.welford_mean_var_c_last(tx)[:2],
                         jbn.welford_mean_var_c_last(jx)[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    invstd = (1 + np.abs(mean)).astype(np.float32)
    targs = (torch.from_numpy(mean), torch.from_numpy(invstd),
             torch.from_numpy(scale))
    jargs = (jnp.asarray(mean), jnp.asarray(invstd), jnp.asarray(scale))
    for got, want in zip(tbn.reduce_bn_c_last(tdy, tx, *targs),
                         jbn.reduce_bn_c_last(jdy, jx, *jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    md, mdx = (np.float32(0.3) * scale, np.float32(-0.2) * scale)
    got = tbn.batchnorm_backward_c_last(tdy, tx, *targs,
                                        torch.from_numpy(md),
                                        torch.from_numpy(mdx))
    want = jbn.batchnorm_backward_c_last(jdy, jx, *jargs, jnp.asarray(md),
                                         jnp.asarray(mdx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got = tbn.batchnorm_forward_c_last(tx, *targs, torch.from_numpy(mean))
    want = jbn.batchnorm_forward_c_last(jx, *jargs, jnp.asarray(mean))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rng = np.random.RandomState(6)
    means = rng.standard_normal((3, 4)).astype(np.float32)
    vars_ = rng.random_sample((3, 4)).astype(np.float32)
    counts = np.array([5.0, 7.0, 2.0], np.float32)
    for got, want in zip(
            tbn.welford_parallel(*map(torch.from_numpy,
                                      (means, vars_, counts))),
            jbn.welford_parallel(*map(jnp.asarray, (means, vars_, counts)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
