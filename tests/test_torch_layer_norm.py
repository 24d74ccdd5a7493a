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
from apex_tpu_torch.ops.cuda import layer_norm_fwd, layer_norm_fwd_ref
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
