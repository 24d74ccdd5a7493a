"""apex_tpu_torch layer norm (the plain version of the CUDA kernel, on
the CPU) against the JAX package's ``fused_layer_norm_affine`` (its jnp
path, the CPU default).

Tolerances: fp32 ``atol = rtol = 1e-5`` (the two sum the row in
different orders); bf16 at most 1 ulp (both compute in fp32, and the
two frameworks can round the fp32 result to bf16 differently), except
where the affine sum cancels toward zero: there the two fp32 results
differ by more than a bf16 ulp of the tiny result, and an absolute
``2**-16`` holds instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization.fused_layer_norm import (
    fused_layer_norm_affine as jax_layer_norm,
)
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
)
from apex_tpu_torch.ops.cuda import (
    layer_norm_bwd,
    layer_norm_bwd_ref,
    layer_norm_fwd,
    layer_norm_fwd_ref,
)
from apex_tpu_torch.testing import BF16_CANCEL_ATOL, bf16_ulp_distance


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n2", [64, 96, 768, 1000])
def test_layer_norm_matches_jax(n2, dtype, affine):
    rng = np.random.RandomState(n2)
    x = (rng.standard_normal((3, 5, n2)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(n2).astype(np.float32) if affine else None
    b = rng.standard_normal(n2).astype(np.float32) if affine else None
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = jax_layer_norm(jx, None if w is None else jnp.asarray(w),
                          None if b is None else jnp.asarray(b), n2, 1e-5)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = None if w is None else torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    got = fused_layer_norm_affine(tx, tw, tb, n2, 1e-5)
    y_ref, mean, inv = layer_norm_fwd_ref(tx.reshape(-1, n2), tw, tb, 1e-5)
    assert got.dtype == tdt and got.shape == tx.shape
    assert torch.equal(got.reshape(-1, n2), y_ref)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert bf16_ulp_distance(got, want.to(tdt), BF16_CANCEL_ATOL) <= 1
    x64 = tx.double().reshape(-1, n2)
    torch.testing.assert_close(mean.double(), x64.mean(1), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(
        inv.double(), torch.rsqrt(x64.var(1, unbiased=False) + 1e-5),
        atol=1e-5, rtol=1e-5)


def test_module_names_its_parameters_as_flax():
    ln = FusedLayerNorm(16)
    assert set(dict(ln.named_parameters())) == {"scale", "bias"}
    x = torch.randn(2, 3, 16)
    torch.testing.assert_close(ln(x), fused_layer_norm(x, 16), atol=0,
                               rtol=0)


def test_normalized_shape_is_checked():
    with pytest.raises(ValueError, match="normalized_shape"):
        fused_layer_norm(torch.zeros(2, 8), 16)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = layer_norm_fwd.launches
    x = torch.randn(4, 40)
    y, _, _ = layer_norm_fwd(x, None, None, 1e-5)
    assert torch.equal(y, layer_norm_fwd_ref(x, None, None, 1e-5)[0])
    assert layer_norm_fwd.launches == before


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n2", [64, 96, 768, 1000])
def test_layer_norm_gradients_match_jax(n2, dtype, affine):
    """``(dx, dγ, dβ)`` of ``fused_layer_norm_affine`` (the backward's
    plain version through ``LayerNormFunction``) against ``jax.grad`` of
    the JAX function.  fp32: dx ``1e-5``, dγ/dβ ``1e-4`` (sums over 15
    rows).  bf16 inputs and weights: dx within 2 bf16 ulps of the largest
    |dx| (both compute in fp32 from the same bf16 values, then round dx
    to bf16; the closed-form backward and JAX's autodiff of the forward
    round at other places), dγ/dβ (rounded to the bf16 weight dtype)
    within 2 bf16 ulps of their largest value."""
    rng = np.random.RandomState(n2 + 1)
    x = (rng.standard_normal((3, 5, n2)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((3, 5, n2)).astype(np.float32)
    w = rng.standard_normal(n2).astype(np.float32)
    b = rng.standard_normal(n2).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jdy, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, dy, w, b))

    if affine:
        def f(xx, ww, bb):
            return jnp.sum(jax_layer_norm(xx, ww, bb, n2, 1e-5)
                           .astype(jnp.float32) * jdy.astype(jnp.float32))
        want = jax.grad(f, argnums=(0, 1, 2))(jx, jw, jb)
    else:
        def f(xx):
            return jnp.sum(jax_layer_norm(xx, None, None, n2, 1e-5)
                           .astype(jnp.float32) * jdy.astype(jnp.float32))
        want = (jax.grad(f)(jx),)
    want = [torch.from_numpy(np.array(t.astype(jnp.float32))) for t in want]
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_() if affine else None
    tb = torch.from_numpy(b).to(tdt).requires_grad_() if affine else None
    y = fused_layer_norm_affine(tx, tw, tb, n2, 1e-5)
    y.backward(torch.from_numpy(dy).to(tdt))
    got = [tx.grad] + ([tw.grad, tb.grad] if affine else [])
    assert all(g.dtype == tdt for g in got)
    if dtype == "float32":
        tols = [1e-5, 1e-4, 1e-4]
    else:
        tols = [2 * 2.0 ** -8 * float(w_.abs().max()) for w_ in want]
    for g, w_, tol in zip(got, want, tols):
        torch.testing.assert_close(g.float(), w_, atol=tol, rtol=0)


def test_layer_norm_backward_is_the_plain_version_of_the_kernel():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    b = torch.zeros(40)
    dy = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    _, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    before = layer_norm_bwd.launches
    got = layer_norm_bwd(dy, x, w, mean, inv)
    for g, r in zip(got, layer_norm_bwd_ref(dy, x, w, mean, inv)):
        assert torch.equal(g, r)
    assert layer_norm_bwd.launches == before
    # and matches autograd of the plain forward
    xx, ww, bb = (t.clone().requires_grad_() for t in (x, w, b))
    torch.nn.functional.layer_norm(xx, (40,), ww, bb, 1e-5).backward(dy)
    for g, r in zip(got, (xx.grad, ww.grad, bb.grad)):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def test_no_grad_calls_build_no_autograd_node():
    x = torch.randn(4, 32, requires_grad=True)
    with torch.no_grad():
        y = fused_layer_norm(x, 32)
    assert y.grad_fn is None
    assert fused_layer_norm(x, 32).grad_fn is not None
