"""K16's plain version and the port's conv route, on the CPU, against the
JAX package: ``conv1x1`` under ``jax.grad`` (its Pallas backward in
interpret mode where a tile divides M, the lax transpose where none
does), ``routeable``, ``lax.padtype_to_pads`` and
``lax.conv_general_dilated``.

Tolerances: dx ``rtol = atol = 1e-5`` and dW ``rtol = 1e-4, atol =
1e-3``, as ``tests/l0/test_conv1x1.py`` holds the JAX kernel against the
lax transpose (fp32 sums over up to 256 channels or M rows, in other
orders); conv outputs and gradients through the route ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from apex_tpu.ops.pallas.experimental import conv1x1 as c1
from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.ops.cuda import conv1x1 as tc1
from apex_tpu_torch.ops.cuda import conv1x1_bwd, conv1x1_bwd_ref
from apex_tpu_torch.testing import bf16_ulp_distance

DN = ("NHWC", "HWIO", "NHWC")


def _jax_grads(x, w, dy):
    def loss(x, w):
        return jnp.sum(c1.conv1x1(x, w).astype(jnp.float32)
                       * dy.astype(jnp.float32))
    return jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))


def _case(b, h, wd, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, h, wd, cin)).astype(np.float32)
    w = (rng.standard_normal((1, 1, cin, cout)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((b, h, wd, cout)).astype(np.float32)
    return x, w, dy


# JAX's test shapes (M 128, 128, 256: the Pallas kernel), its remainder
# case (M 9) and a ragged M with channel counts off the vector width
@pytest.mark.parametrize("b,h,wd,cin,cout", [
    (2, 8, 8, 64, 256), (2, 8, 8, 256, 64), (1, 16, 16, 128, 128),
    (1, 3, 3, 64, 64), (3, 5, 7, 24, 40)])
def test_plain_backward_matches_jax_conv1x1(b, h, wd, cin, cout):
    x, w, dy = _case(b, h, wd, cin, cout, cin + cout)
    jdx, jdw = _jax_grads(x, w, dy)
    m = b * h * wd
    dx, dw = conv1x1_bwd(torch.from_numpy(x).reshape(m, cin),
                         torch.from_numpy(dy).reshape(m, cout),
                         torch.from_numpy(w).reshape(cin, cout))
    np.testing.assert_allclose(dx.reshape(x.shape).numpy(), np.asarray(jdx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.reshape(w.shape).numpy(), np.asarray(jdw),
                               rtol=1e-4, atol=1e-3)


def test_plain_backward_keeps_each_dtype_and_sums_in_fp32():
    x, w, dy = _case(2, 4, 4, 32, 48, 7)
    args = [torch.from_numpy(a).reshape(-1, a.shape[-1]).to(torch.bfloat16)
            for a in (x, dy)]
    w2 = torch.from_numpy(w).reshape(32, 48).to(torch.bfloat16)
    dx, dw = conv1x1_bwd_ref(args[0], args[1], w2)
    assert dx.dtype == dw.dtype == torch.bfloat16
    x64, dy64, w64 = (t.double() for t in (args[0], args[1], w2))
    assert bf16_ulp_distance(dx, (dy64 @ w64.t()).to(torch.bfloat16)) <= 1
    assert bf16_ulp_distance(dw, (x64.t() @ dy64).to(torch.bfloat16)) <= 1


def test_the_wrapper_refuses_other_devices():
    t = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1x1_bwd(t, t, torch.empty((8, 8), device="meta"))


def test_routeable_predicate(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FUSED_CONV1X1", "1")
    x = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16)
    w11 = torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16)

    def ok(**kw):
        return tc1.routeable(
            x, kw.pop("kernel", w11), kw.pop("strides", (1, 1)),
            kw.pop("padding", "SAME"), kw.pop("dn", DN),
            kw.pop("extra", {}))
    assert ok()
    assert ok(padding="VALID")
    assert not ok(dn=None)
    assert not ok(kernel=torch.zeros((3, 3, 64, 128), dtype=torch.bfloat16))
    assert not ok(strides=(2, 2))
    assert not ok(padding=[(1, 1), (0, 0)])
    assert ok(padding=[(0, 0), (0, 0)])
    assert not ok(extra={"feature_group_count": 2})
    assert not ok(kernel=torch.zeros((1, 1, 64, 128)))       # mixed dtypes
    assert not ok(kernel=w11.to(torch.float64)) and not tc1.routeable(
        x.double(), w11.double(), (1, 1), "SAME", DN, {})
    monkeypatch.setenv("APEX_TPU_FUSED_CONV1X1", "0")
    assert not ok()
    monkeypatch.delenv("APEX_TPU_FUSED_CONV1X1")
    assert not tc1.enabled() and not ok()


@pytest.mark.parametrize("hw,k,s,pad", [
    (224, 7, 2, "SAME"), (112, 3, 2, "SAME"), (56, 3, 2, "SAME"),
    (56, 1, 2, "SAME"), (14, 2, 1, "SAME"), (9, 3, 1, "SAME"),
    (7, 3, 2, "VALID"), (10, 4, 3, "SAME")])
def test_pads_are_lax_padtype_to_pads(hw, k, s, pad):
    want = lax.padtype_to_pads((hw, hw + 1), (k, k), (s, s), pad)
    got = amp_ops.pads_of((hw, hw + 1), (k, k), (s, s), pad)
    assert got == tuple(tuple(p) for p in want)


@pytest.mark.parametrize("k,s,pad,groups,dil", [
    (7, 2, "SAME", 1, 1), (3, 2, "SAME", 1, 1), (3, 1, "SAME", 1, 1),
    (1, 2, "SAME", 1, 1), (2, 1, "SAME", 1, 1), (3, 1, [(1, 2), (0, 1)],
                                                 1, 1),
    (3, 1, "VALID", 2, 1), (3, 1, "SAME", 1, 2)])
def test_conv_route_matches_lax(k, s, pad, groups, dil):
    rng = np.random.RandomState(k * 10 + s)
    x = rng.standard_normal((2, 13, 12, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8 // groups, 6)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), pad, rhs_dilation=(dil, dil),
        dimension_numbers=DN, feature_group_count=groups)
    dy = rng.standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: lax.conv_general_dilated(
        a, b, (s, s), pad, rhs_dilation=(dil, dil), dimension_numbers=DN,
        feature_group_count=groups), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = amp_ops.conv_general_dilated(
        tx, tw, (s, s), pad, rhs_dilation=(dil, dil), dimension_numbers=DN,
        feature_group_count=groups)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-4)


def test_the_route_hands_the_library_conv_channels_last_views():
    x = torch.randn(2, 6, 6, 8)
    xc = x.permute(0, 3, 1, 2)
    assert xc.is_contiguous(memory_format=torch.channels_last)
    assert xc.data_ptr() == x.data_ptr()
    w = torch.randn(3, 3, 8, 4)
    y = amp_ops.conv_general_dilated(x, w, (2, 2), "SAME",
                                     dimension_numbers=DN)
    assert y.shape == (2, 3, 3, 4) and y.is_contiguous()
    # the asymmetric pad keeps the layout too
    padded, sym = amp_ops.pad_nchw(xc, ((0, 1), (0, 1)))
    assert sym == (0, 0)
    assert padded.is_contiguous(memory_format=torch.channels_last)


def test_unported_conv_options_raise():
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2)
    with pytest.raises(NotImplementedError):
        amp_ops.conv_general_dilated(x, w, (1, 1), "SAME")    # NCHW default
    # lhs_dilation is ported (the transposed conv); with a string padding
    # it raises as lax does
    with pytest.raises(ValueError, match="String padding"):
        amp_ops.conv_general_dilated(x, w, (1, 1), "SAME", lhs_dilation=(2, 2),
                                     dimension_numbers=DN)
    with pytest.raises(NotImplementedError, match="batch_group_count"):
        amp_ops.conv_general_dilated(x, w, (1, 1), "SAME",
                                     dimension_numbers=DN,
                                     batch_group_count=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_switched_route_takes_k16_and_matches_the_conv_backward(
        monkeypatch, dtype):
    x, w, dy = _case(2, 5, 5, 16, 24, 3)
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    tdy = torch.from_numpy(dy).to(dtype)

    def run(switch):
        monkeypatch.setenv("APEX_TPU_FUSED_CONV1X1", switch)
        a = tx.clone().requires_grad_(True)
        b = tw.clone().requires_grad_(True)
        y = amp_ops.conv_general_dilated(a, b, (1, 1), "SAME",
                                         dimension_numbers=DN)
        y.backward(tdy)
        return y, a.grad, b.grad

    y1, dx1, dw1 = run("1")
    y0, dx0, dw0 = run("0")
    assert "_Conv1x1" in type(y1.grad_fn).__name__
    assert "_Conv1x1" not in type(y0.grad_fn).__name__
    assert torch.equal(y1, y0)                      # the same forward
    m = 2 * 5 * 5
    rdx, rdw = conv1x1_bwd_ref(tx.reshape(m, 16), tdy.reshape(m, 24),
                               tw.reshape(16, 24))
    assert torch.equal(dx1, rdx.reshape(dx1.shape))
    assert torch.equal(dw1, rdw.reshape(dw1.shape))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx1, dx0, rtol=tol, atol=tol)
    torch.testing.assert_close(dw1, dw0, rtol=tol, atol=tol)
    if dtype == torch.float32:
        jdx, jdw = _jax_grads(x, w, dy)
        np.testing.assert_allclose(dx1.numpy(), np.asarray(jdx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(dw1.numpy(), np.asarray(jdw), rtol=1e-4,
                                   atol=1e-3)


def test_conv1x1_forward_is_the_library_conv():
    x, w, _ = _case(1, 4, 4, 8, 8, 1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = F.conv2d(tx.permute(0, 3, 1, 2),
                    tw.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert torch.equal(tc1.conv1x1(tx, tw), want)
