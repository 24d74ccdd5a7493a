"""The host side of the Hopper flash forward (K2 and K17, one kernel in
``csrc/flash_fwd_sm90.cu``) and of the kernel routes, on the CPU: the TMA
map geometry of the forward's operands, the plain arithmetic of the
forward's prologue (k rotated) and of the q tile it pre-scales and rotates
in shared memory, the route table (which kernel each dtype, head width and
partials budget takes), the CPU tensors' plain versions, and the repaired
cases (fp16, fp32 and head widths other than 64 / 128 through
``flash_attention_mh`` and ``attention``) against the JAX package.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
marker ``gpu``).  Tolerances: the prologue and the q preparation bitwise
against numpy's float32 emulation of the kernels' arithmetic (each product
and sum rounded on its own, then one rounding to the storage type); against
JAX, ``atol = 2e-5`` in fp32 (both exact fp32, other summation orders) and
``2e-2`` in bf16 / fp16 (both compute in fp32 from the same half inputs and
round their outputs), the bounds of ``tests/test_torch_flash_mh.py`` and
``tests/test_torch_flash_attention.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.attention import attention as jax_attention
from apex_tpu.ops.pallas.experimental.flash_mh import (
    flash_attention_mh as jax_flash_mh)
from apex_tpu_torch.attention import attention
from apex_tpu_torch.ops.cuda import (
    KERNELS,
    bwd_route,
    flash_attn_bwd,
    flash_attn_fwd,
    flash_attn_fwd_ref,
    flash_bwd_prologue_ref,
    flash_bwd_simt,
    flash_fwd_prologue,
    flash_fwd_prologue_ref,
    flash_fwd_simt,
    flash_mh_bwd,
    flash_mh_fwd,
    flash_mh_fwd_ref,
    fwd_route,
    launch_counts,
    mh_bwd_route,
    tma_geometry,
)
from apex_tpu_torch.ops.cuda.flash_attention import MAX_HEAD_DIM
from apex_tpu_torch.ops.experimental import flash_attention_mh
from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables

BUDGET = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"
GiB = 1 << 30


def _fused_qkv(b, l, h, d, dtype):
    """q, k, v as the GPT block makes them: strided views of one ``(B, L,
    3 H D)`` product."""
    rng = np.random.default_rng(b * l + d)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, l, 3 * h * d), np.float32)).to(dtype)
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1)]


def _tables(b, l, d, dtype):
    cos, sin = rope_tables(torch.arange(l)[None].expand(b, l), d, 10000.0)
    return rope_kernel_tables(cos, sin, b, l, d, dtype)


# -- the forward's TMA maps --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,padded", [(40, 64), (64, 64), (96, 128),
                                      (128, 128)])
def test_forward_maps_of_the_fused_qkv_views(d, padded, dtype):
    """K2 reads q, k (or the prologue's contiguous k^) and v straight out
    of the fused qkv product: (D, H, L, B) with the token row's byte
    stride, in bf16 and fp16 alike, padded to 64 or 128."""
    b, l, h = 2, 100, 3
    row = 3 * h * d * 2
    for t in _fused_qkv(b, l, h, d, dtype):
        g = tma_geometry(t)
        assert g.dims == (d, h, l, b)
        assert g.strides == (2 * d, row, l * row)
        assert g.padded_d == padded


@pytest.mark.parametrize("b,l,h,d", [(8, 2048, 12, 64), (32, 512, 16, 64),
                                     (1, 4096, 6, 128), (2, 1000, 4, 40)])
def test_forward_maps_of_the_multi_head_layout(b, l, h, d):
    """K17's (B, L, H * D) tensors, seen as (B, L, H, D), are the same maps
    with the packed strides: one head a block reads its columns through
    the H dimension, no transposed copy."""
    x = torch.zeros((b, l, h * d), dtype=torch.bfloat16)
    g = tma_geometry(x.view(b, l, h, d))
    assert g.dims == (d, h, l, b)
    assert g.strides == (2 * d, 2 * h * d, (2 * l * h * d if b > 1
                                            else 2 * d))
    assert g.box == (64, 1, 64, 1)


def test_forward_maps_refuse_fp32():
    """fp32 takes the generic kernel: TMA maps are bf16 / fp16 only."""
    with pytest.raises(ValueError, match="bf16 or fp16"):
        tma_geometry(torch.zeros((1, 64, 2, 64)))


# -- the plain arithmetic of the forward's prologue and q preparation --------

def _round(x, dtype):
    return torch.from_numpy(x).to(dtype).float().numpy()


def _emulate_rotation(x, cos, sin, dtype):
    """numpy float32 emulation: (lo, hi) -> (lo c + hi s, hi c' + lo s'),
    each product and the sum rounded on its own, then to ``dtype``."""
    half = x.shape[-1] // 2
    xr = np.concatenate([x[..., half:], x[..., :half]], axis=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = np.float32(x) * np.float32(c) + np.float32(xr) * np.float32(s)
    return _round(out.astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [40, 64, 128])
def test_forward_prologue_is_the_rotation_bitwise(d, dtype):
    """k^ (the forward prologue's only output) is k rotated in fp32 and
    rounded to k's dtype, bitwise numpy's emulation, and bitwise the k^ of
    the backward's prologue: forward and backward read one k^."""
    b, l, h = 2, 50, 3
    _, k, _ = _fused_qkv(b, l, h, d, dtype)
    tables = _tables(b, l, d, dtype)
    got = flash_fwd_prologue_ref(k, tables)
    assert got.dtype == dtype
    want = _emulate_rotation(k.float().numpy(),
                             tables.cos_full.float().numpy(),
                             tables.sin_signed.float().numpy(), dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    q, _, _ = _fused_qkv(b, l, h, d, dtype)
    _, kh = flash_bwd_prologue_ref(q, k, scale=d ** -0.5, rope=tables)
    assert torch.equal(got, kh)
    # the wrapper on CPU tensors: the plain version, no launch
    before = flash_fwd_prologue.launches
    assert torch.equal(flash_fwd_prologue(k, tables), got)
    assert flash_fwd_prologue.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [40, 96])
def test_q_preparation_is_the_pre_scale_then_the_rotation(d, dtype):
    """What each consumer warpgroup writes over its q rows in shared memory:
    q times the scale rounded to q's dtype (the product rounded), then
    rotated as k is; the plain version (the backward prologue's q^) holds
    that arithmetic bitwise, at a scale that is not a power of two."""
    b, l, h = 1, 37, 2
    q, k, _ = _fused_qkv(b, l, h, d, dtype)
    tables = _tables(b, l, d, dtype)
    scale = d ** -0.5
    s_t = np.float32(float(torch.tensor(scale, dtype=dtype)))
    scaled = _round(q.float().numpy() * s_t, dtype)
    want = _emulate_rotation(scaled, tables.cos_full.float().numpy(),
                             tables.sin_signed.float().numpy(), dtype)
    qh, _ = flash_bwd_prologue_ref(q, k, scale=scale, rope=tables)
    np.testing.assert_array_equal(qh.float().numpy(), want)


# -- the route table -------------------------------------------------------

FWD_ROUTES = [
    (torch.bfloat16, 64, "sm90"), (torch.float16, 64, "sm90"),
    (torch.bfloat16, 8, "sm90"), (torch.float16, 40, "sm90"),
    (torch.bfloat16, 96, "sm90"), (torch.float16, 128, "sm90"),
    (torch.bfloat16, 136, "simt"), (torch.float16, 192, "simt"),
    (torch.bfloat16, 512, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 40, "simt"), (torch.float32, 256, "simt"),
]


@pytest.mark.parametrize("dtype,d,route", FWD_ROUTES)
def test_forward_route(dtype, d, route):
    """bf16 / fp16 up to D 128 take K2 / K17; fp32, and half types above
    128, the generic kernel."""
    assert fwd_route(dtype, d) == route


BWD_ROUTES = [  # (dtype, (b, l, h, d), budget, flash_attn_bwd, flash_mh_bwd)
    (torch.bfloat16, (32, 512, 16, 64), GiB, "fused", "fused"),   # BERT
    (torch.float16, (32, 512, 16, 64), GiB, "fused", "fused"),
    (torch.bfloat16, (8, 2048, 12, 64), GiB, "two_pass", "two_pass"),
    (torch.float16, (8, 2048, 12, 64), GiB, "two_pass", "two_pass"),
    (torch.bfloat16, (8, 2048, 12, 64), 2 * GiB, "fused", "fused"),
    (torch.bfloat16, (2, 256, 4, 40), GiB, "fused", "fused"),
    (torch.float16, (2, 256, 4, 96), GiB, "fused", "fused"),
    (torch.float16, (2, 256, 4, 96), 0, "two_pass", "two_pass"),
    (torch.bfloat16, (2, 256, 4, 192), GiB, "simt", "simt"),
    (torch.float16, (2, 256, 4, 256), 0, "simt", "simt"),
    (torch.float32, (8, 2048, 12, 64), 0, "simt", "simt"),
    (torch.float32, (2, 256, 4, 40), GiB, "simt", "simt"),
]


@pytest.mark.parametrize("dtype,shape,budget,route,mh_route", BWD_ROUTES)
def test_backward_routes(dtype, shape, budget, route, mh_route):
    """The backward's kernels as a pure function of the dtype, the head
    width and the partial planes' bytes (one plane a 64-key tile) against
    the budget: K4 and K18 take every half-type width up to 128 within the
    budget; the two-pass kernels the half-type cases over it (gpt_small's
    (8, 2048) planes, 1.61 GB, exceed 1 GiB); the generic pair fp32 and
    half types above 128."""
    b, l, h, d = shape
    planes = -(-l // 64) * b * l * h * d * 4
    assert bwd_route(dtype, d, planes, budget) == route
    assert mh_bwd_route(dtype, d, planes, budget) == mh_route


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 9672),
                                     (torch.float32, 1020),
                                     (torch.float16, 44),
                                     (torch.int32, 64),
                                     (torch.float64, 64)])
def test_routes_refuse_what_no_kernel_takes(dtype, d):
    """D above MAX_HEAD_DIM (9664: the generic kernels' six fp32 rows of a
    warp fill one block's shared memory), D not a multiple of 8, and
    dtypes other than fp32 / bf16 / fp16 raise on every route."""
    assert MAX_HEAD_DIM == 9664
    with pytest.raises(ValueError):
        fwd_route(dtype, d)
    with pytest.raises(ValueError):
        bwd_route(dtype, d, 0, GiB)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [520, 1024, 2048])
def test_wide_heads_take_the_generic_kernels(dtype, d):
    """Head widths above 512, which the generic kernels refused before
    (their rows now live in shared memory there), route to them forward
    and backward, within the budget or not."""
    assert fwd_route(dtype, d) == "simt"
    for budget in (0, GiB):
        assert bwd_route(dtype, d, 0, budget) == "simt"
        assert mh_bwd_route(dtype, d, 0, budget) == "simt"


def test_every_route_kernel_counts_its_own_launches():
    """The generic kernels and the forward's prologue have counters of
    their own beside K2 / K17's."""
    for name in ("flash_attn_fwd", "flash_mh_fwd", "flash_fwd_prologue",
                 "flash_fwd_simt", "flash_bwd_simt", "flash_attn_bwd",
                 "flash_mh_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                 "flash_bwd_prologue", "flash_bwd_finish"):
        assert name in KERNELS and name in launch_counts()


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.float32, 40),
                                     (torch.bfloat16, 192)])
def test_cpu_tensors_take_the_plain_versions(dtype, d):
    """On CPU tensors every forward and backward wrapper, whatever its
    route on the card, runs its plain version and counts no launch."""
    b, l, h = 1, 40, 2
    q, k, v = _fused_qkv(b, l, h, d, dtype)
    tables = _tables(b, l, d, dtype)
    before = launch_counts()
    o, lse = flash_attn_fwd(q, k, v, causal=True, rope=tables,
                            return_lse=True)
    ro, rlse = flash_attn_fwd_ref(q, k, v, causal=True, rope=tables)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    so, slse = flash_fwd_simt(q, k, v, causal=True, rope=tables,
                              return_lse=True)
    assert torch.equal(so, ro) and torch.equal(slse, rlse)
    mo, mlse = flash_mh_fwd(q, k, v, causal=True)
    rmo, rmlse = flash_mh_fwd_ref(q, k, v, causal=True)
    assert torch.equal(mo, rmo) and torch.equal(mlse, rmlse)
    do = torch.ones_like(o)
    got = flash_attn_bwd(q, k, v, o, lse, do, causal=True, rope=tables)
    simt = flash_bwd_simt(q, k, v, o, lse, do, causal=True, rope=tables)
    assert all(torch.equal(a, s) for a, s in zip(got, simt))
    assert all(t.dtype == dtype for t in got)
    flash_mh_bwd(q, k, v, mo, mlse, do, causal=True)
    assert launch_counts() == before


# -- the repaired cases against the JAX package ----------------------------

def _mh_inputs(shape, dtype, seed, masked):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal(shape[:3]).astype(np.float32) * 0.1
    mask = None
    if masked:
        mask = rng.rand(*shape[:2]) > 0.3
        mask[:, 0] = True
    # both sides start from the same values in the storage type
    q, k, v, do = (torch.from_numpy(t).to(dtype) for t in (q, k, v, do))
    return q, k, v, do, dlse, mask


def _np32(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


MH_REPAIRS = {  # (shape, causal, masked, dtype)
    "fp16_causal": ((2, 128, 4, 64), True, False, torch.float16),
    "fp16_masked_d40": ((1, 100, 3, 40), False, True, torch.float16),
    "fp32_causal": ((2, 128, 4, 64), True, False, torch.float32),
    "fp32_d40": ((1, 100, 3, 40), True, False, torch.float32),
    "fp32_d192": ((1, 64, 2, 192), True, False, torch.float32),
    "bf16_d192": ((1, 64, 2, 192), False, True, torch.bfloat16),
    "fp16_d256": ((1, 64, 2, 256), True, False, torch.float16),
}


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("case", sorted(MH_REPAIRS))
def test_flash_attention_mh_repairs_match_jax(case, route, monkeypatch):
    """``flash_attention_mh`` in fp16 and fp32 and at D 40, 192 and 256
    (the dtypes and widths the card's kernels refused before), forward
    and gradients with a cotangent on the lse, against the JAX function
    (its Pallas kernels in interpret mode) on the same inputs; both sides
    of the port's partials gate."""
    shape, causal, masked, dtype = MH_REPAIRS[case]
    # JAX's fused route is the oracle of both (the variable steers both
    # packages; JAX's own fallback route raises: ROADMAP.md Queue 3)
    monkeypatch.setenv(BUDGET, str(1 << 40))
    q, k, v, do, dlse, mask = _mh_inputs(shape, dtype, len(case), masked)
    jdt = jnp.dtype(str(dtype).split(".")[-1])
    km = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jax_flash_mh(q_, k_, v_, causal=causal, kv_mask=km,
                            block_q=128, block_k=128, return_lse=True)

    jin = [jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v)]
    (jo, jlse), vjp = jax.vjp(f, *jin)
    jgrads = vjp((jnp.asarray(do.float().numpy()).astype(jdt),
                  jnp.asarray(dlse)))
    if route == "two_pass":
        monkeypatch.setenv(BUDGET, "0")
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o, lse = flash_attention_mh(
        tq, tk, tv, causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask),
        return_lse=True)
    torch.autograd.backward((o, lse), (do, torch.from_numpy(dlse)))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and tq.grad.dtype == dtype
    for name, got, want in (("o", o, jo), ("lse", lse, jlse),
                            ("dq", tq.grad, jgrads[0]),
                            ("dk", tk.grad, jgrads[1]),
                            ("dv", tv.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   _np32(want), atol=tol, rtol=tol,
                                   err_msg=f"{case} {route} {name}")


ATTN_REPAIRS = {  # (shape, causal, dtype)
    "fp16_d64": ((2, 37, 3, 64), True, torch.float16),
    "fp16_d40": ((1, 50, 2, 40), False, torch.float16),
    "bf16_d40": ((2, 37, 3, 40), True, torch.bfloat16),
    "bf16_d96": ((1, 50, 2, 96), True, torch.bfloat16),
    "fp16_d96": ((2, 37, 2, 96), False, torch.float16),
    "fp32_d40": ((2, 37, 3, 40), True, torch.float32),
    "fp32_d96": ((1, 50, 2, 96), False, torch.float32),
}


@pytest.mark.parametrize("case", sorted(ATTN_REPAIRS))
def test_attention_repairs_match_jax(case):
    """``attention`` in fp16 and at D 40 / 96 (which K2 and K4 refused
    before), forward and gradients, against the JAX package's
    ``attention`` (its jnp path) on the same inputs."""
    shape, causal, dtype = ATTN_REPAIRS[case]
    q, k, v, do, _, _ = _mh_inputs(shape, dtype, len(case), False)
    jdt = jnp.dtype(str(dtype).split(".")[-1])
    jin = [jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v)]
    jo, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal=causal),
                      *jin)
    jgrads = vjp(jnp.asarray(do.float().numpy()).astype(jdt))
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = attention(tq, tk, tv, causal=causal)
    o.backward(do)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype
    for name, got, want in (("o", o, jo), ("dq", tq.grad, jgrads[0]),
                            ("dk", tk.grad, jgrads[1]),
                            ("dv", tv.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   _np32(want), atol=tol, rtol=tol,
                                   err_msg=f"{case} {name}")
