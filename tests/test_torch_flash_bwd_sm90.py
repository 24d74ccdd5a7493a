"""The host side of the two-pass flash backward (K13 dq, K14 dk / dv) on
the CPU: the TMA map geometry through which the Hopper kernels read their
operands (:func:`tma_geometry`), the plain version of their prologue (q
pre-scaled in bf16 and rotated, k rotated), and the two-pass route at the
head widths that TMA pads (40 and 96) against the JAX package.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
marker ``gpu``).  Tolerances: the prologue's plain version is held bitwise
to numpy's float32 emulation of the kernel's arithmetic (each product and
sum rounded on its own, then one rounding to bf16); the fp32 gradients
within ``atol = 1e-4`` of ``jax.grad`` of JAX's ``_jnp_attention`` and of
JAX's own two-pass Pallas route in interpret mode, the bound of
``tests/test_torch_long_context.py`` (both sum the score products in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import flash_attention as jax_fa
from apex_tpu.ops.rope import apply_rope as jax_apply_rope
from apex_tpu_torch.ops.cuda import flash_attention as port_fa
from apex_tpu_torch.ops.cuda import (
    flash_bwd_prologue,
    flash_bwd_prologue_ref,
    tma_geometry,
    two_pass_bwd,
)
from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
from test_torch_flash_attention import _np
from test_torch_long_context import _case, _two_pass

ENV = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"


def _fused_qkv(b, l, h, d):
    """q, k, v as the GPT block makes them: strided views of one
    ``(B, L, 3 H D)`` product."""
    rng = np.random.default_rng(b * l + d)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, l, 3 * h * d), np.float32)).to(torch.bfloat16)
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1)]


# -- the TMA map geometry ---------------------------------------------------

@pytest.mark.parametrize("d,padded", [(40, 64), (64, 64), (96, 128),
                                      (128, 128)])
@pytest.mark.parametrize("b,l,h", [(8, 2048, 12), (2, 100, 4), (1, 1000, 3)])
def test_geometry_of_the_fused_qkv_views(b, l, h, d, padded):
    """Each view of the fused qkv product maps as (D, H, L, B) with its own
    byte strides (the row of a token spans all three), a box of 64
    columns by 64 rows, and the padded width the kernels run at; L need
    not be a multiple of 64 (TMA zero-fills the rows past it)."""
    for t in _fused_qkv(b, l, h, d):
        g = tma_geometry(t)
        row = 3 * h * d * 2
        assert g.dims == (d, h, l, b)
        assert g.strides == (d * 2, row, (l * row if b > 1 else d * 2))
        assert g.box == (64, 1, 64, 1)
        assert g.padded_d == padded
        assert g.words() == g.dims + g.strides
        assert all(s % 16 == 0 for s in g.strides)


def test_geometry_of_a_contiguous_tensor():
    """The prologue's contiguous q^ / k^ (and the gpt_small train shape's
    dO): the packed strides."""
    t = torch.zeros((8, 2048, 12, 64), dtype=torch.bfloat16)
    g = tma_geometry(t)
    assert g.dims == (64, 12, 2048, 8)
    assert g.strides == (128, 12 * 128, 2048 * 12 * 128)


def test_geometry_ignores_the_stride_of_an_extent_one_dim():
    """A dimension of extent 1 is never stepped over: whatever stride
    PyTorch reports for it, the map takes the row's bytes."""
    base = torch.zeros(4096, dtype=torch.bfloat16)
    t = base.as_strided((1, 16, 1, 40), (3, 40, 5, 1))
    g = tma_geometry(t)
    assert g.dims == (40, 1, 16, 1)
    assert g.strides == (80, 80, 80)


@pytest.mark.parametrize("what,make,match", [
    ("fp32", lambda: torch.zeros((1, 64, 2, 64)), "bf16"),
    ("3-d", lambda: torch.zeros((64, 2, 64), dtype=torch.bfloat16), "bf16"),
    ("D 36", lambda: torch.zeros((1, 64, 2, 36), dtype=torch.bfloat16),
     "head dim"),
    ("D 136", lambda: torch.zeros((1, 64, 2, 136), dtype=torch.bfloat16),
     "head dim"),
    ("D strided", lambda: torch.zeros((1, 64, 64, 2), dtype=torch.bfloat16)
     .transpose(2, 3), "unit stride"),
    ("base 8 B off", lambda: torch.zeros(
        (1, 64, 2, 72), dtype=torch.bfloat16)[..., 4:68], "16-byte"),
    ("row stride 72 B", lambda: torch.zeros(
        (1, 64, 2, 36), dtype=torch.bfloat16).as_strided(
            (1, 64, 1, 32), (4608, 36, 36, 1)), "multiple of 16"),
])
def test_geometry_refuses_what_tma_refuses(what, make, match):
    """Each operand TMA cannot map raises ``ValueError`` in the wrapper's
    helper, before any launch."""
    with pytest.raises(ValueError, match=match):
        tma_geometry(make())


# -- the prologue's plain version -------------------------------------------

def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("d", [40, 64, 128])
def test_prologue_prescale_without_rope_is_the_kernels_arithmetic(d):
    """Without tables q^ is q times the scale rounded to bf16, the product
    taken in float32 and rounded once to bf16; k^ is k itself."""
    q, k, _ = _fused_qkv(2, 33, 3, d)
    scale = 1.0 / d ** 0.5
    qh, kh = flash_bwd_prologue_ref(q, k, scale=scale)
    s_b = np.float32(float(torch.tensor(scale, dtype=torch.bfloat16)))
    want = _bf16(q.float().numpy() * s_b)
    assert torch.equal(qh, want)
    assert kh is k


def test_prologue_rotation_is_the_kernels_arithmetic():
    """With tables q^ = rot(q pre-scaled) and k^ = rot(k), each lane pair
    (c, c + D/2) rotated as ``lo * cos + hi * sin`` in float32 with each
    product and the sum rounded (the kernels' ``__fmul_rn`` /
    ``__fadd_rn``), then rounded to bf16."""
    b, l, h, d = 2, 33, 3, 40
    q, k, _ = _fused_qkv(b, l, h, d)
    cos, sin = rope_tables(torch.arange(l)[None].expand(b, l), d, 10000.0)
    tables = rope_kernel_tables(cos, sin, b, l, d, torch.bfloat16)
    scale = 1.0 / d ** 0.5
    qh, kh = flash_bwd_prologue_ref(q, k, scale=scale, rope=tables)
    c = tables[0].float().numpy()[:, :, None, :]
    s = tables[1].float().numpy()[:, :, None, :]

    def rot(x):
        x = x.float().numpy()
        xr = np.concatenate([x[..., d // 2:], x[..., :d // 2]], axis=-1)
        return _bf16(np.float32(x * c) + np.float32(xr * s))

    s_b = np.float32(float(torch.tensor(scale, dtype=torch.bfloat16)))
    assert torch.equal(qh, rot(_bf16(q.float().numpy() * s_b)))
    assert torch.equal(kh, rot(k))


def test_the_scale_rounds_to_bf16_as_torch_does():
    """The wrappers round the softmax scale to bf16 without making a tensor
    (host time on every call); the value is ``torch.tensor(scale,
    dtype=torch.bfloat16)``'s, over magnitudes from 1e-8 to 1e8 and the
    head widths' own ``1 / sqrt(D)``."""
    rng = np.random.default_rng(0)
    vals = (list(rng.standard_normal(5000) * 10.0 ** rng.integers(-8, 9, 5000))
            + [d ** -0.5 for d in range(8, 129, 8)] + [0.0, 1.0, 0.125])
    for v in vals:
        assert port_fa._bf16_scale(float(v)) == float(
            torch.tensor(float(v), dtype=torch.bfloat16)), v


def test_prologue_wrapper_on_cpu_tensors_is_the_plain_version():
    """The wrapper runs its plain version for CPU tensors, with or without
    tables, and launches nothing."""
    b, l, h, d = 1, 20, 2, 64
    q, k, _ = _fused_qkv(b, l, h, d)
    cos, sin = rope_tables(torch.arange(l)[None], d, 10000.0)
    tables = rope_kernel_tables(cos, sin, b, l, d, torch.bfloat16)
    before = flash_bwd_prologue.launches
    for rope in (None, tables):
        got = flash_bwd_prologue(q, k, scale=0.125, rope=rope)
        want = flash_bwd_prologue_ref(q, k, scale=0.125, rope=rope)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert flash_bwd_prologue.launches == before


# -- the two-pass route at padded head widths -------------------------------

PADDED_CASES = [  # (shape, causal, masked, rope); L not a multiple of 64
    ((2, 50, 3, 40), True, False, True),
    ((2, 50, 3, 40), False, True, False),
    ((1, 37, 2, 96), True, False, True),
    ((1, 37, 2, 96), False, True, False),
]


@pytest.mark.parametrize("shape,causal,masked,rope", PADDED_CASES)
def test_two_pass_route_at_padded_widths_matches_jax_grad(
        monkeypatch, shape, causal, masked, rope):
    """The two-pass plain versions at head widths 40 and 96 (which the card
    runs at 64 and 128) against ``jax.grad`` of JAX's ``_jnp_attention``
    on ``apply_rope``-rotated q and k, fp32."""
    monkeypatch.setenv(ENV, "0")
    (jq, jk, jv), (tq, tk, tv), do, mask, (jcos, jsin), kw = _case(
        shape, causal, masked, rope)

    def f(q, k, v):
        if rope:
            q, k = (jax_apply_rope(t, jcos, jsin) for t in (q, k))
        o = jax_fa._jnp_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            scale=1 / shape[-1] ** 0.5)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    got = _two_pass(tq, tk, tv, do, kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape,causal,masked,rope", PADDED_CASES)
def test_two_pass_route_at_padded_widths_matches_jax_two_pass_pallas(
        monkeypatch, shape, causal, masked, rope):
    """The same inputs through JAX's own two-pass route (``_flash_bwd``:
    the Pallas ``_dq_kernel`` / ``_dkv_kernel`` in interpret mode, forced
    by the budget variable at 0), against :func:`two_pass_bwd`."""
    monkeypatch.setenv(ENV, "0")
    (jq, jk, jv), (tq, tk, tv), do, mask, (jcos, jsin), kw = _case(
        shape, causal, masked, rope)

    def f(q, k, v):
        o = jax_fa.flash_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            rope=(jcos, jsin) if rope else None)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    got = _two_pass(tq, tk, tv, do, kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    from apex_tpu_torch.ops.cuda import attn_delta, flash_attn_fwd
    o, lse = flash_attn_fwd(tq, tk, tv, return_lse=True, **kw)
    delta = attn_delta(o, torch.from_numpy(do), None)
    whole = two_pass_bwd(tq, tk, tv, torch.from_numpy(do), lse, delta, **kw)
    assert all(torch.equal(a, b) for a, b in zip(whole, got))
