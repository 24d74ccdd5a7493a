"""apex_tpu_torch attention (the plain version of the flash kernel, on
the CPU) against the JAX package's ``apex_tpu.attention.attention`` (its
jnp path, the CPU default).

Tolerances: fp32 ``atol = 2e-5`` (the score products sum in another
order); bf16 ``atol = 2e-2`` (both compute in fp32 from the same bf16
inputs and round the output to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.attention import attention as jax_attention
from apex_tpu.ops.pallas.flash_attention import _jnp_attention
from apex_tpu_torch.attention import attention
from apex_tpu_torch.ops.cuda import flash_attn_fwd, flash_attn_fwd_ref

NEG_INF = -1e30
SHAPES = [(2, 37, 3, 64), (1, 50, 2, 128), (2, 16, 2, 64)]


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_matches_jax(shape, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, shape[1])
    jo, jlse = jax_attention(jq, jk, jv, causal=causal, return_lse=True)
    to, tlse = attention(tq, tk, tv, causal=causal, return_lse=True)
    atol = 2e-5 if dtype == "float32" else 2e-2
    assert to.dtype == tq.dtype and to.shape == tq.shape
    np.testing.assert_allclose(to.float().numpy(), _np(jo), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(tlse.numpy(), _np(jlse), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_key_mask_and_a_row_that_sees_no_key(causal, dtype):
    """Batch 0's keys are all masked, so each of its rows sees no key:
    zeros and lse = NEG_INF, the flash kernel's convention (the JAX
    package's ``_jnp_attention`` holds it too).  Batch 1 is partly
    masked and checked against ``apex_tpu.attention.attention``."""
    shape = (2, 21, 2, 64)
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, 5)
    mask = np.random.RandomState(1).rand(2, 21) > 0.4
    mask[0] = False
    mask[1, 0] = True                  # causal row 0 of batch 1 sees key 0
    to, tlse = attention(tq, tk, tv, causal=causal,
                         kv_mask=torch.from_numpy(mask), return_lse=True)
    assert torch.all(to[0] == 0) and torch.all(tlse[0] == NEG_INF)
    atol = 2e-5 if dtype == "float32" else 2e-2
    ko, klse = _jnp_attention(jq, jk, jv, causal=causal,
                              kv_mask=jnp.asarray(mask),
                              scale=1 / 8.0, return_lse=True)
    np.testing.assert_allclose(to.float().numpy(), _np(ko), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(tlse.numpy(), _np(klse), atol=atol,
                               rtol=1e-5)
    jo, jlse = jax_attention(jq, jk, jv, causal=causal,
                             kv_mask=jnp.asarray(mask), return_lse=True)
    np.testing.assert_allclose(to[1].float().numpy(), _np(jo)[1],
                               atol=atol, rtol=0)
    np.testing.assert_allclose(tlse[1].numpy(), _np(jlse)[1], atol=atol,
                               rtol=1e-5)


def test_explicit_scale_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 9, 2, 64), "float32", 2)
    jo = jax_attention(jq, jk, jv, causal=True, scale=0.3)
    to = attention(tq, tk, tv, causal=True, scale=0.3)
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=2e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    _, (tq, tk, tv) = _inputs((1, 12, 2, 64), "float32", 3)
    before = flash_attn_fwd.launches
    o = flash_attn_fwd(tq, tk, tv, causal=True)
    assert torch.equal(o, flash_attn_fwd_ref(tq, tk, tv, causal=True)[0])
    assert flash_attn_fwd.launches == before
