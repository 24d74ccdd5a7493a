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
from apex_tpu_torch.ops.cuda import (
    flash_attn_bwd,
    flash_attn_bwd_ref,
    flash_attn_fwd,
    flash_attn_fwd_ref,
)

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


def _rope_tables(b, l, d, theta=10000.0):
    """JAX half-width tables and the port's kernel-format tables, from
    the same positions."""
    from apex_tpu.ops.rope import rope_tables as jax_rope_tables
    from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
    pos = np.broadcast_to(np.arange(l)[None], (b, l))
    jcos, jsin = jax_rope_tables(jnp.asarray(pos), d, theta)
    cos, sin = rope_tables(torch.from_numpy(pos.copy()), d, theta)
    return (jcos, jsin), rope_kernel_tables(cos, sin, b, l, d,
                                            torch.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_rope_forward_matches_jax_pre_rotated(shape, causal):
    """``attention(..., rope=)`` (rotation inside the kernel's plain
    version) against JAX ``attention(apply_rope(q), apply_rope(k), v)``
    (the pre-rotated path), fp32 ``atol = 2e-5``."""
    from apex_tpu.ops.rope import apply_rope as jax_apply_rope
    b, l, h, d = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "float32", 11 + l)
    (jcos, jsin), tables = _rope_tables(b, l, d)
    jo, jlse = jax_attention(jax_apply_rope(jq, jcos, jsin),
                             jax_apply_rope(jk, jcos, jsin), jv,
                             causal=causal, return_lse=True)
    to, tlse = attention(tq, tk, tv, causal=causal, return_lse=True,
                         rope=tables)
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), _np(jlse), atol=2e-5,
                               rtol=1e-5)


GRAD_CASES = [  # (shape, causal, masked, rope); L = 37 and 50 are not
    # multiples of 16
    ((2, 37, 3, 64), True, False, True),
    ((2, 37, 3, 64), False, False, True),
    ((2, 37, 3, 64), True, True, False),
    ((2, 37, 3, 64), False, True, True),
    ((1, 50, 2, 128), True, False, False),
    ((1, 50, 2, 128), False, True, True),
]


@pytest.mark.parametrize("shape,causal,masked,rope", GRAD_CASES)
def test_gradients_match_jax(shape, causal, masked, rope):
    """dq, dk, dv of ``attention`` (``FlashAttention``, whose backward is
    the fused flash backward's plain version) against ``jax.grad`` of
    JAX's ``_jnp_attention`` on ``apply_rope``-rotated q and k (or
    unrotated), fp32 ``atol = 1e-4``.  The masked cases mask every key of
    batch 0, so each of its rows sees no key and gets zero gradients, as
    in JAX's flash convention."""
    from apex_tpu.ops.rope import apply_rope as jax_apply_rope
    b, l, h, d = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "float32", 3 * l + d)
    do = np.random.RandomState(l).standard_normal(shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.random.RandomState(l + 1).rand(b, l) > 0.4
        mask[:, 0] = True
        mask[0, :] = False                      # a fully masked batch row
    (jcos, jsin), tables = _rope_tables(b, l, d)

    def f(q, k, v):
        if rope:
            q, k = (jax_apply_rope(t, jcos, jsin) for t in (q, k))
        o = _jnp_attention(q, k, v, causal=causal,
                           kv_mask=None if mask is None
                           else jnp.asarray(mask),
                           scale=1 / d ** 0.5)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o = attention(q, k, v, causal=causal,
                  kv_mask=None if mask is None else torch.from_numpy(mask),
                  rope=tables if rope else None)
    o.backward(torch.from_numpy(do))
    for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    if masked:
        assert torch.all(q.grad[0] == 0)


def test_lse_cotangent_folds_into_the_backward():
    """A gradient through the returned lse (ring attention merges partial
    results with it) matches autograd of the materialising version."""
    _, (tq, tk, tv) = _inputs((1, 19, 2, 64), "float32", 4)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o, lse = attention(q, k, v, causal=True, return_lse=True)
    (o.sum() + (lse * 0.5).sum()).backward()
    q2, k2, v2 = (t.clone().requires_grad_() for t in (tq, tk, tv))
    s = torch.einsum("bqhd,bkhd->bhqk", q2, k2) / 8.0
    s = s.masked_fill(~torch.ones(19, 19, dtype=torch.bool).tril(), NEG_INF)
    o2 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v2)
    lse2 = torch.logsumexp(s, -1).permute(0, 2, 1)
    (o2.sum() + (lse2 * 0.5).sum()).backward()
    for a, b_ in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b_.grad, atol=1e-5, rtol=0)


def test_backward_is_the_plain_version_and_no_grad_builds_no_node():
    _, (tq, tk, tv) = _inputs((1, 12, 2, 64), "float32", 3)
    with torch.no_grad():
        o = attention(tq.requires_grad_(), tk, tv, causal=True)
    assert o.grad_fn is None
    o, lse = flash_attn_fwd(tq, tk, tv, causal=True, return_lse=True)
    do = torch.randn_like(o)
    before = flash_attn_bwd.launches
    got = flash_attn_bwd(tq, tk, tv, o, lse, do, causal=True)
    want = flash_attn_bwd_ref(tq, tk, tv, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attn_bwd.launches == before


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_wide_heads_match_jax(causal, masked):
    """A head width above 512 (D 520, which the card's generic kernels
    take since their rows moved to shared memory): ``attention``'s
    forward and gradients against JAX's ``_jnp_attention`` and
    ``jax.grad`` of it, fp32 (``atol = 2e-5``; the gradients ``1e-4``,
    the bound of the other gradient tests)."""
    shape = (1, 40, 2, 520)
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "float32", 520)
    do = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.random.RandomState(4).rand(1, 40) > 0.3
        mask[:, 0] = True
    jmask = None if mask is None else jnp.asarray(mask)
    scale = 1 / 520 ** 0.5

    def f(q, k, v):
        return _jnp_attention(q, k, v, causal=causal, kv_mask=jmask,
                              scale=scale, return_lse=True)

    (jo, jlse), vjp = jax.vjp(f, jq, jk, jv)
    want = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o, lse = attention(*leaves, causal=causal, return_lse=True,
                       kv_mask=None if mask is None
                       else torch.from_numpy(mask))
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), _np(jo), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), _np(jlse), atol=2e-5,
                               rtol=1e-5)
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")
