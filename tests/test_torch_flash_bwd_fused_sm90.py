"""The host side of the Hopper fused flash backward (K4, and K18 behind
``flash_attention_mh``: one kernel in ``csrc/flash_bwd_fused_sm90.cu``)
on the CPU: the plain version of its finish pass (the dq partial planes
summed, inverse-rotated, rounded and scaled), the route table at the
kernel's plane size (one plane a 64-key consumer warpgroup), and the fused
route at the head widths that TMA pads (40 and 96) against the JAX
package.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
marker ``gpu``).  Tolerances: the finish pass's plain version is held
bitwise to numpy's float32 emulation of the kernel's arithmetic (the
planes added in ascending order, each product and sum of the rotation
rounded on its own, one rounding to the storage type, the scale product
rounded again); against JAX's ``dq_part.sum(axis=0).astype(dtype)`` times
the rule's scale within two units in the last place of the storage type
(XLA's reduction adds the planes in its own order, which can move a sum
across a rounding boundary of the type, and the scale rounds once more);
the fp32 gradients within ``atol = 1e-4`` of ``jax.grad`` of JAX's
``_jnp_attention`` and of JAX's own fused Pallas route in interpret mode,
the bound of ``tests/test_torch_long_context.py`` (all three sum the
score products in other orders).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import flash_attention as jax_fa
from apex_tpu.ops.pallas.experimental.flash_mh import (
    flash_attention_mh as jax_flash_mh)
from apex_tpu.ops.rope import apply_rope as jax_apply_rope
from apex_tpu_torch.ops.cuda import (
    bwd_route,
    flash_attn_bwd,
    flash_attn_fwd,
    flash_bwd_finish,
    flash_bwd_finish_ref,
    fused_bwd,
    fused_bwd_partials_bytes,
    launch_counts,
    mh_bwd_route,
    mh_partials_bytes,
)
from apex_tpu_torch.ops.cuda.flash_attention import BWD_KEY_TILE
from apex_tpu_torch.ops.experimental import flash_attention_mh
from test_torch_flash_attention import _np
from test_torch_long_context import _case

ENV = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"
GiB = 1 << 30
_NP_TYPES = {torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}


# -- the finish pass --------------------------------------------------------

def _planes(n, b, l, h, d, causal, seed):
    """Random fp32 planes; under causality each plane's rows before its
    keys hold NaN, which the finish pass must never read."""
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((n, b, l, h, d)).astype(np.float32)
    if causal:
        for j in range(n):
            planes[j, :, :BWD_KEY_TILE * j] = np.nan
    return planes


def _tables_np(b, l, d, np_type, seed):
    """Full-width ``(cos, signed sin)`` tables ``(B, L, D)`` in the storage
    type, as ``rope_kernel_tables`` lays them out."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 6.3, (b, l, d // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang), np.cos(ang)], -1)
    sin = np.concatenate([-np.sin(ang), np.sin(ang)], -1)
    return cos.astype(np_type), sin.astype(np_type)


def _finish_np(planes, causal, tables, scale, np_type):
    """numpy float32 emulation of the finish kernel: ascending adds of the
    planes that reach each row, the lane rotation with the sine negated
    (each product and the sum rounded on its own), one rounding to the
    type, the product with the scale rounded to the type, rounded again."""
    n, b, l, h, d = planes.shape
    acc = np.zeros((b, l, h, d), np.float32)
    for j in range(n):
        r0 = BWD_KEY_TILE * j if causal else 0
        acc[:, r0:] = (acc[:, r0:] + planes[j, :, r0:]).astype(np.float32)
    if tables is not None:
        cos, sin = (t.astype(np.float32)[:, :, None, :] for t in tables)
        hd = d // 2
        swapped = np.concatenate([acc[..., hd:], acc[..., :hd]], -1)
        acc = (acc * cos).astype(np.float32) \
            + (swapped * -sin).astype(np.float32)
    out = acc.astype(np.float32).astype(np_type).astype(np.float32)
    s = np.float32(np.asarray(scale, np.float32).astype(np_type))
    return (out * s).astype(np.float32).astype(np_type)


FINISH_CASES = [  # (n, b, l, h, d, causal, rope, dtype)
    (3, 2, 300, 2, 72, True, True, torch.bfloat16),
    (3, 2, 300, 2, 72, False, False, torch.float16),
    (4, 1, 512, 3, 64, True, False, torch.bfloat16),
    (1, 2, 37, 2, 40, False, True, torch.float16),
    (2, 1, 200, 1, 128, True, True, torch.float16),
]


@pytest.mark.parametrize("n,b,l,h,d,causal,rope,dtype", FINISH_CASES)
def test_finish_pass_plain_version_is_the_kernels_arithmetic(
        n, b, l, h, d, causal, rope, dtype):
    """The plain finish pass, bitwise against numpy's emulation of the
    kernel's order and roundings; the planes' unreached causal rows (NaN
    here) are skipped, and the wrapper on CPU tensors is the plain
    version."""
    np_type = _NP_TYPES[dtype]
    planes = _planes(n, b, l, h, d, causal, seed=n * l + d)
    tables = _tables_np(b, l, d, np_type, seed=d) if rope else None
    scale = 1.0 / d ** 0.5
    want = _finish_np(planes, causal, tables, scale, np_type)
    t_tables = None if tables is None else tuple(
        torch.from_numpy(t.astype(np.float32)).to(dtype) for t in tables)
    got = flash_bwd_finish_ref(torch.from_numpy(planes), causal=causal,
                               rope=t_tables, scale=scale, dtype=dtype)
    assert got.dtype == dtype and not torch.isnan(got).any()
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    before = launch_counts()
    wrapped = flash_bwd_finish(torch.from_numpy(planes), causal=causal,
                               rope=t_tables, scale=scale, dtype=dtype)
    assert torch.equal(wrapped, got) and launch_counts() == before


@pytest.mark.parametrize("n,b,l,h,d,causal,rope,dtype",
                         [c for c in FINISH_CASES if not c[6]])
def test_finish_pass_matches_jax_plane_sum(n, b, l, h, d, causal, rope,
                                           dtype):
    """Without rope, the finish pass against what the JAX rule does with
    the fused kernel's planes: ``dq_part.sum(axis=0).astype(dtype)`` (a
    dead block's plane rows are zeros there) times ``jnp.asarray(scale,
    dtype)``, within two units in the last place of the type."""
    np_type = _NP_TYPES[dtype]
    planes = _planes(n, b, l, h, d, causal, seed=7 * l + d)
    scale = 1.0 / d ** 0.5
    got = flash_bwd_finish_ref(torch.from_numpy(planes), causal=causal,
                               scale=scale, dtype=dtype).float().numpy()
    jdt = jnp.dtype(np_type)
    dq_part = jnp.asarray(np.nan_to_num(planes, nan=0.0))
    want = np.asarray((dq_part.sum(axis=0).astype(jdt)
                       * jnp.asarray(scale, jdt)).astype(jnp.float32))
    eps = float(jnp.finfo(jdt).eps)
    np.testing.assert_allclose(got, want, rtol=2 * eps, atol=1e-6)


# -- the routes at the kernel's plane size ----------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [40, 96])
def test_fused_route_takes_every_padded_width(dtype, d):
    """K4 takes the widths it refused before (40 and 96 run padded to 64
    and 128), as K18 did, within the budget; over it both take K13 +
    K14."""
    planes = fused_bwd_partials_bytes(2, 256, 4, d, dtype)
    assert planes == mh_partials_bytes(2, 256, 4, d) \
        == 4 * 2 * 256 * 4 * d * 4
    for route in (bwd_route, mh_bwd_route):
        assert route(dtype, d, planes, GiB) == "fused"
        assert route(dtype, d, planes, planes - 1) == "two_pass"


@pytest.mark.parametrize("shape", [(8, 2048, 12, 64), (32, 512, 16, 64),
                                   (2, 1000, 4, 40)])
def test_gate_at_the_plane_size_exactly(monkeypatch, shape):
    """The gate compares one fp32 plane a 64-key tile with the budget:
    fused at exactly the planes' bytes, two-pass one byte under."""
    b, l, h, d = shape
    planes = -(-l // 64) * b * l * h * d * 4
    assert fused_bwd_partials_bytes(b, l, h, d, torch.bfloat16) == planes
    assert mh_partials_bytes(b, l, h, d) == planes
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    monkeypatch.setenv(ENV, str(planes))
    assert fused_bwd(q)
    monkeypatch.setenv(ENV, str(planes - 1))
    assert not fused_bwd(q)


def test_gpt_small_train_shape_keeps_the_two_pass_route(monkeypatch):
    """gpt_small's B8 x L2048 backward: 32 planes of 50.3 MB (1.61 GB)
    exceed the default 1 GiB, so it stays on K13 + K14 (the plane size
    was chosen so: at one plane a 128-key tile, 805 MB, it would take K4,
    whose whole call was slower there on the card, PERF.md); raised to 2
    GiB it takes K4 and K18; BERT's B32 x L512 (537 MB) takes K4."""
    monkeypatch.delenv(ENV, raising=False)
    assert fused_bwd_partials_bytes(8, 2048, 12, 64, torch.bfloat16) \
        == 1_610_612_736
    for dtype in (torch.bfloat16, torch.float16):
        assert bwd_route(dtype, 64, 1_610_612_736, GiB) == "two_pass"
        assert mh_bwd_route(dtype, 64, 1_610_612_736, 2 * GiB) == "fused"
    gpt = torch.empty((8, 2048, 12, 64), dtype=torch.bfloat16, device="meta")
    assert not fused_bwd(gpt)
    assert fused_bwd(torch.empty((32, 512, 16, 64), dtype=torch.bfloat16,
                                 device="meta"))
    monkeypatch.setenv(ENV, str(2 * GiB))
    assert fused_bwd(gpt)


# -- the fused route at padded head widths ----------------------------------

PADDED_CASES = [  # (shape, causal, masked, rope); L not a multiple of 64
    ((2, 150, 3, 40), True, False, True),
    ((2, 150, 3, 40), False, True, False),
    ((1, 37, 2, 96), True, False, True),
    ((1, 137, 2, 96), False, True, False),
]


def _fused(tq, tk, tv, do, kw):
    """dq, dk, dv of :func:`flash_attn_bwd` on its fused route (the plain
    version on CPU tensors)."""
    o, lse = flash_attn_fwd(tq, tk, tv, return_lse=True, **kw)
    return flash_attn_bwd(tq, tk, tv, o, lse, torch.from_numpy(do), **kw)


@pytest.mark.parametrize("shape,causal,masked,rope", PADDED_CASES)
def test_fused_route_at_padded_widths_matches_jax_grad(
        monkeypatch, shape, causal, masked, rope):
    """The fused route at head widths 40 and 96 (which the card now runs
    through K4 at 64 and 128) against ``jax.grad`` of JAX's
    ``_jnp_attention`` on ``apply_rope``-rotated q and k, fp32."""
    monkeypatch.setenv(ENV, str(1 << 40))
    (jq, jk, jv), (tq, tk, tv), do, mask, (jcos, jsin), kw = _case(
        shape, causal, masked, rope)
    assert fused_bwd(tq)

    def f(q, k, v):
        if rope:
            q, k = (jax_apply_rope(t, jcos, jsin) for t in (q, k))
        o = jax_fa._jnp_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            scale=1 / shape[-1] ** 0.5)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    got = _fused(tq, tk, tv, do, kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape,causal,masked,rope", PADDED_CASES)
def test_fused_route_at_padded_widths_matches_jax_fused_pallas(
        monkeypatch, shape, causal, masked, rope):
    """The same inputs through JAX's own fused route (``_flash_bwd_fused``:
    the Pallas ``_bwd_fused_kernel`` in interpret mode, its planes summed
    by XLA, taken while the budget holds them), against the port's fused
    route; and ``flash_attention_mh`` (K18's route, no rope) against JAX's
    multi-head function."""
    monkeypatch.setenv(ENV, str(1 << 40))
    (jq, jk, jv), (tq, tk, tv), do, mask, (jcos, jsin), kw = _case(
        shape, causal, masked, rope)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        o = jax_fa.flash_attention(q, k, v, causal=causal, kv_mask=jmask,
                                   rope=(jcos, jsin) if rope else None)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    got = _fused(tq, tk, tv, do, kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")

    def g_mh(q, k, v):
        return jnp.sum(jax_flash_mh(q, k, v, causal=causal, kv_mask=jmask)
                       * jnp.asarray(do))

    want = jax.grad(g_mh, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = flash_attention_mh(*leaves, causal=causal, kv_mask=kw["kv_mask"])
    o.backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), atol=1e-4,
                                   rtol=0, err_msg=f"mh d{name}")
