"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a card each test skips (decided in the
``cuda`` fixture, never at import).  Run on the card with
``python -m pytest -m gpu tests/test_torch_*.py``.

Tolerances: layer norm, fp32 ``atol = rtol = 1e-5`` and bf16 / fp16 at
most 1 ulp (the kernel sums in another order, then rounds the fp32
result) or ``2**-16`` absolute where the affine sum cancels toward zero,
on every route;
flash attention, fp32 ``atol = 2e-5`` and bf16 ``atol = 2e-2`` against
the plain version run in fp32 on the same bf16 inputs (the kernel
rounds the pre-scaled q and the probabilities to bf16 for the tensor
cores, as the TPU kernel does).  The backward kernels: fp32 ``atol =
1e-5`` (dw, db: also ``rtol = 1e-5``, row sums), bf16 within 2 bf16 ulps
of the largest element against the plain version in bf16 (both compute
in fp32 and round at the same places, but sum in other orders); both run
twice for equal bits; so do the two-pass backward's K13 (dq) and K14
(dk / dv), whose dq, dk and dv lie within the same 2 ulps (and the row
and norm limits) of K4's, the two being separate kernels that sum in
other orders; their prologue (q^, k^) equals its plain version bit for
bit.  Adam and the unscale equal their plain versions
bit for bit (every product and sum rounded on its own).  LAMB: stage 1's
m, v and u equal the plain version's bit for bit, its norm partials and
the total sum of squares are within ``rtol = 1e-5`` (sums in another
order); stage 2's p within ``rtol = 1e-6, atol = 1e-7`` in fp32 and 1
bf16 ulp in bf16 (its per-leaf norm sums differ in order, so the trust
ratio may differ in its last bit); stages 1, 2 and the sum of squares
repeat bitwise.  axpby (K10) and the whole-tree Adam (K11) equal their
plain versions bit for bit, and K11 equals K5 run leaf by leaf; the
per-tensor sums of squares (K12) are within ``rtol = 1e-6`` (another
order) and repeat bitwise.  The fused 1x1-conv backward (K16): dx and dW
within 2 ulps of each result's largest element in bf16 / fp16 and
``1e-5`` of it in fp32 (both sum in fp32 and round once, in other
orders), at ResNet-50's 12 shapes, at small and ragged ones and on each
route of ``conv1x1_route`` (a misaligned view takes the CUDA-core
route); two runs equal bit for bit.  The layer-norm backward on each
route of ``ln_bwd_route`` holds the same tolerances, and a view at an
odd element offset equals the 16-byte groups' result bit for bit.  The generic flash kernels (tiled up to D 256, a warp a
row above): o and lse within 2e-5 and the gradients within 1e-5 of the
plain version in fp32, half types within 2 bf16 ulps of each result's
largest element (q is pre-scaled in the half type); two runs equal bit
for bit, and a strided or misaligned view equal bit for bit to the same
call on contiguous copies.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops.cuda import (
    flash_attn_bwd,
    flash_attn_bwd_ref,
    flash_attn_fwd,
    flash_attn_fwd_ref,
    flash_bwd_simt,
    flash_fwd_simt,
    lamb_stage1,
    lamb_stage1_ref,
    lamb_stage2,
    lamb_stage2_ref,
    layer_norm_bwd,
    layer_norm_bwd_ref,
    layer_norm_fwd,
    layer_norm_fwd_ref,
    packed_adam,
    packed_adam_ref,
    packed_adam_tree,
    packed_adam_tree_ref,
    packed_axpby,
    packed_axpby_ref,
    packed_scale,
    packed_scale_ref,
    packed_sumsq,
    packed_sumsq_ref,
    sumsq_per_tensor,
    sumsq_per_tensor_ref,
)
from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE, ChunkTable
from apex_tpu_torch.testing import BF16_CANCEL_ATOL, bf16_ulp_distance

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n2", [64, 96, 768, 1000, 2304])
def test_layer_norm_kernel_matches_plain(cuda, n2, dtype, affine):
    rng = np.random.RandomState(n2)
    x = _randn(rng, (37, n2), dtype, cuda) * 3 + 1
    w = b = None
    if affine:
        w = _randn(rng, (n2,), dtype, cuda)
        b = _randn(rng, (n2,), dtype, cuda)
    before = layer_norm_fwd.launches
    y, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert layer_norm_fwd.launches == before + 1
    y_ref, mean_ref, inv_ref = layer_norm_fwd_ref(x, w, b, 1e-5)
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(inv, inv_ref, atol=1e-5, rtol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    else:
        assert bf16_ulp_distance(y, y_ref, BF16_CANCEL_ATOL) <= 1


#: (x dtype, w dtype) pairs K1 takes
LN_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
            (torch.float16, torch.float32)]


def _ln_close(y, y_ref):
    from apex_tpu_torch.testing import half_ulp_distance
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    else:
        assert half_ulp_distance(y, y_ref, BF16_CANCEL_ATOL) <= 1


def _ln_route_cases():
    """(n1, n2, route, pair, offset) for every K1 route that takes the
    shape (the route's register capacity, and for the 16-byte forms a
    width of whole groups at an aligned start)."""
    from apex_tpu_torch.ops.cuda.layer_norm import (BLOCK_GROUPS_MAX,
                                                    WARP_GROUPS_MAX)
    cases = []
    for n1, n2 in ((8, 768), (300, 1024), (37, 770), (5, 4096)):
        for route in ("warp_vec", "warp_scalar", "block_vec",
                      "block_scalar", "loop_vec", "loop_scalar"):
            kind, access = route.split("_")
            for pair in LN_PAIRS:
                per = 16 // pair[0].itemsize
                groups = -(-n2 // per)
                if (kind == "warp" and groups > WARP_GROUPS_MAX) or (
                        kind == "block" and groups > BLOCK_GROUPS_MAX):
                    continue
                for offset in (0, 1):
                    if access == "vec" and (n2 % per or offset):
                        continue
                    cases.append(pytest.param(
                        n1, n2, route, pair, offset,
                        id=f"{n1}x{n2}-{route}-{pair[0]}-{pair[1]}-"
                           f"off{offset}"))
    return cases


@pytest.mark.parametrize("n1,n2,route,pair,offset", _ln_route_cases())
def test_layer_norm_kernel_routes_match_plain(cuda, n1, n2, route, pair,
                                              offset):
    """Every K1 route that takes the shape, in every dtype pair: within
    the tolerance of the plain version (fp32 1e-5; bf16 / fp16 1 ulp, or
    2**-16 where the affine sum cancels), statistics within 1e-5, one
    launch a call, two runs equal bit for bit, the stats-free call's y
    bit for bit the stats call's; ``offset`` 1: x a view at an odd
    element offset (the scalar forms)."""
    xdt, wdt = pair
    rng = np.random.RandomState(n1 + n2)
    base = _randn(rng, (n1 * n2 + offset,), xdt, cuda) * 3 + 1
    x = base[offset:].view(n1, n2)
    w, b = (_randn(rng, (n2,), wdt, cuda) for _ in range(2))
    before = layer_norm_fwd.launches
    y, mean, inv = layer_norm_fwd(x, w, b, 1e-5, route=route)
    again = layer_norm_fwd(x, w, b, 1e-5, route=route)
    bare, no_mean, no_inv = layer_norm_fwd(x, w, b, 1e-5, stats=False,
                                           route=route)
    torch.cuda.synchronize()
    assert layer_norm_fwd.launches == before + 3
    assert no_mean is None and no_inv is None
    assert all(torch.equal(a, c) for a, c in zip((y, mean, inv), again))
    assert torch.equal(y, bare)
    y_ref, mean_ref, inv_ref = layer_norm_fwd_ref(x, w, b, 1e-5)
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(inv, inv_ref, atol=1e-5, rtol=1e-5)
    _ln_close(y, y_ref)


@pytest.mark.parametrize("kind", ["warp", "block", "loop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_layer_norm_vector_and_scalar_routes_agree_bitwise(cuda, kind,
                                                           dtype):
    """The 16-byte and the element form of a route sum the same groups in
    the same order: equal bits."""
    rng = np.random.RandomState(9)
    x = _randn(rng, (64, 1024), dtype, cuda)
    w, b = (_randn(rng, (1024,), dtype, cuda) for _ in range(2))
    vec = layer_norm_fwd(x, w, b, 1e-5, route=f"{kind}_vec")
    scalar = layer_norm_fwd(x, w, b, 1e-5, route=f"{kind}_scalar")
    assert all(torch.equal(a, c) for a, c in zip(vec, scalar))


def test_layer_norm_kernel_default_routes(cuda):
    """Without ``route`` the call takes ``ln_fwd_route``'s choice: a
    misaligned view the scalar form, and a vector route refuses one; rows
    of a 3-D tensor are normalized in place of a reshape (y keeps x's
    shape, the statistics are one per row)."""
    from apex_tpu_torch.ops.cuda import ln_fwd_route
    rng = np.random.RandomState(10)
    base = _randn(rng, (8 * 768 + 1,), torch.bfloat16, cuda)
    x = base[1:].view(8, 768)
    w, b = (_randn(rng, (768,), torch.bfloat16, cuda) for _ in range(2))
    assert ln_fwd_route(8, 768, torch.bfloat16, aligned=False) \
        == "block_scalar"
    y = layer_norm_fwd(x, w, b, 1e-5)[0]
    assert torch.equal(y, layer_norm_fwd(x, w, b, 1e-5,
                                         route="block_scalar")[0])
    with pytest.raises(ValueError, match="16-byte"):
        layer_norm_fwd(x, w, b, 1e-5, route="block_vec")
    x3 = _randn(rng, (2, 4, 768), torch.bfloat16, cuda)
    y3, mean, inv = layer_norm_fwd(x3, w, b, 1e-5)
    y2 = layer_norm_fwd(x3.view(8, 768), w, b, 1e-5)
    assert y3.shape == x3.shape and mean.shape == inv.shape == (8,)
    assert torch.equal(y3.view(8, 768), y2[0])


def test_layer_norm_kernel_fp32_affine_on_bf16(cuda):
    rng = np.random.RandomState(3)
    x = _randn(rng, (8, 768), torch.bfloat16, cuda)
    w = _randn(rng, (768,), torch.float32, cuda)
    b = _randn(rng, (768,), torch.float32, cuda)
    y, _, _ = layer_norm_fwd(x, w, b, 1e-5)
    assert bf16_ulp_distance(y, layer_norm_fwd_ref(x, w, b, 1e-5)[0],
                             BF16_CANCEL_ATOL) <= 1


CASES = [(2, 77, 3, 64), (1, 130, 2, 128), (1, 64, 2, 64), (3, 5, 2, 128)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CASES)
def test_flash_kernel_matches_plain(cuda, shape, dtype, causal, masked):
    bsz, l, h, d = shape
    rng = np.random.RandomState(l + d)
    q, k, v = (_randn(rng, shape, dtype, cuda) for _ in range(3))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[0, :] = False            # batch 0: every row sees no key
    # K2 in bf16, the generic kernel in fp32 (the route's own counter)
    counter = flash_attn_fwd if dtype == torch.bfloat16 else flash_fwd_simt
    before = counter.launches
    o, lse = flash_attn_fwd(q, k, v, causal=causal, kv_mask=mask,
                            return_lse=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    o_ref, lse_ref = flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                        causal=causal, kv_mask=mask)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref, atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=atol * 10, rtol=1e-5)
    if masked:
        assert torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)


def test_flash_kernel_reads_strided_qkv_split(cuda):
    """q/k/v split out of one fused projection output: strided views,
    read in place."""
    rng = np.random.RandomState(0)
    qkv = _randn(rng, (2, 50, 3 * 4 * 64), torch.bfloat16, cuda)
    q, k, v = (t.reshape(2, 50, 4, 64) for t in qkv.split(256, dim=-1))
    assert not v.is_contiguous()
    o = flash_attn_fwd(q, k, v, causal=True)
    o_ref, _ = flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                  causal=True)
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    # a head width off a multiple of 8, or above 9664 (the generic
    # kernels' rows fill a block's shared memory there): no kernel takes it
    for d in (36, 9672):
        q = torch.zeros((1, 8, 2, d), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attn_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 9, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Lq == Lk"):
        flash_attn_fwd(q, k, k)
    x = torch.zeros((4, 64), device=cuda)
    _, mean, inv = layer_norm_fwd(x, None, None, 1e-5)
    with pytest.raises(ValueError, match="dy must match"):
        layer_norm_bwd(torch.zeros((4, 32), device=cuda), x, None, mean,
                       inv)


def test_serve_engine_launches_layer_norm_kernel_per_step(cuda):
    """The launch counters replace the JAX engine's trace counts: every
    decode step launches the layer-norm kernel 2 x layers + 1 times,
    and solo generate() launches flash attention once per layer (this
    fp32 model's on the generic kernel, the route of fp32)."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    # 2 layers, 2 heads of 64
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    torch.manual_seed(0)
    model = GPTModel(cfg, device=cuda).requires_grad_(False)
    eng = ServeEngine(model, cfg, ServeConfig(num_slots=2, block_size=4,
                                              num_blocks=17,
                                              max_blocks_per_slot=8,
                                              prefill_chunk=4),
                      device=cuda)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in (5, 12, 3)]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=f"r{i}", prompt=p, max_new_tokens=6))
    # admissions run prefill chunks (also layer norm); count one decode
    # step on its own once every request is in
    eng.step()
    eng.step()
    reset_launch_counts()
    eng.step()
    assert launch_counts()["layer_norm_fwd"] == 2 * cfg.num_layers + 1
    out = eng.run()
    for i, p in enumerate(prompts):
        reset_launch_counts()
        solo = generate(model, cfg, p[None], 6, device=cuda)
        assert launch_counts()["flash_fwd_simt"] == cfg.num_layers
        assert launch_counts()["flash_attn_fwd"] == 0
        assert out[f"r{i}"].shape == (6,)
        assert solo.shape == (1, len(p) + 6)


def _bf16_tol(ref):
    return 2 * 2.0 ** -8 * max(1.0, float(ref.float().abs().max()))


def _assert_rows_close(got, ref):
    """The scale-aware check beside ``_bf16_tol`` (as ``chip_smoke.py``'s
    ``scaled_errs``): each row's max error within 2**-6 of that row's max
    |ref| (at least 1% of the median non-zero row's; a zero row must be
    zero), and ||err|| / ||ref|| within 1e-2."""
    err = got.float() - ref.float()
    row_ref = ref.float().abs().amax(dim=-1)
    live = row_ref[row_ref > 0]
    floor = max(1e-2 * float(live.median()) if live.numel() else 0.0,
                torch.finfo(torch.float32).tiny)
    row = float((err.abs().amax(dim=-1)
                 / torch.clamp(row_ref, min=floor)).max())
    assert row <= 2.0 ** -6, row
    if live.numel():
        assert float(err.norm() / ref.float().norm()) <= 1e-2


def _tables(b, l, d, dtype, dev):
    from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
    pos = torch.arange(l, device=dev)[None].expand(b, l)
    cos, sin = rope_tables(pos, d, 10000.0)
    return tuple(rope_kernel_tables(cos, sin, b, l, d, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CASES)
def test_flash_kernel_with_rope_matches_plain(cuda, shape, dtype):
    bsz, l, h, d = shape
    rng = np.random.RandomState(l + 2 * d)
    q, k, v = (_randn(rng, shape, dtype, cuda) for _ in range(3))
    rope = _tables(bsz, l, d, dtype, cuda)
    o, lse = flash_attn_fwd(q, k, v, causal=True, return_lse=True,
                            rope=rope)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attn_fwd_ref(q, k, v, causal=True, rope=rope)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=atol * 10, rtol=1e-5)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CASES)
def test_flash_backward_kernel_matches_plain(cuda, shape, dtype, causal,
                                             masked, rope):
    bsz, l, h, d = shape
    rng = np.random.RandomState(3 * l + d)
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[:, 0] = True
        mask[0, :] = False            # batch 0: every row sees no key
    kw = dict(causal=causal, kv_mask=mask,
              rope=_tables(bsz, l, d, dtype, cuda) if rope else None)
    o, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    counter = flash_attn_bwd if dtype == torch.bfloat16 else flash_bwd_simt
    before = counter.launches
    got = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    # one launch of K4 a call in bf16, two of the generic pair (dk/dv,
    # then dq) in fp32
    assert counter.launches == before + 2 * (
        1 if dtype == torch.bfloat16 else 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = flash_attn_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, r in zip(got, ref):
        assert a.dtype == dtype and a.shape == q.shape
        tol = 1e-5 if dtype == torch.float32 else _bf16_tol(r)
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=0)
    if masked:
        assert all(torch.all(g[0] == 0) for g in got)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1,n2", [(37, 64), (37, 96), (300, 768),
                                   (37, 1000), (37, 2304)])
def test_layer_norm_backward_kernel_matches_plain(cuda, n1, n2, dtype,
                                                  affine):
    rng = np.random.RandomState(n1 + n2)
    x = _randn(rng, (n1, n2), dtype, cuda) * 2 + 0.3
    dy = _randn(rng, (n1, n2), dtype, cuda)
    w = _randn(rng, (n2,), dtype, cuda) if affine else None
    b = torch.zeros_like(w) if affine else None
    _, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    before = layer_norm_bwd.launches
    got = layer_norm_bwd(dy, x, w, mean, inv)
    again = layer_norm_bwd(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    # dx with partials, then (with a weight) the dw/db sum
    assert layer_norm_bwd.launches == before + 2 * (2 if affine else 1)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    ref = layer_norm_bwd_ref(dy, x, w, mean, inv)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
        for a, r in zip(got[1:], ref[1:]):
            if r is not None:
                torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
    else:
        for a, r in zip(got, ref):
            if r is not None:
                torch.testing.assert_close(a.float(), r.float(),
                                           atol=_bf16_tol(r), rtol=0)
    if not affine:
        assert got[1] is None and got[2] is None


# K3's routes (``ln_bwd_route``): a row a warp (16-byte groups or element
# accesses), a row a block (few rows, wide rows), three passes a row
@pytest.mark.parametrize("n1,n2,dtype,wdtype,route", [
    (16384, 768, torch.bfloat16, torch.bfloat16, "warp_vec"),
    (16384, 1024, torch.float16, torch.float16, "warp_vec"),
    (16384, 768, torch.bfloat16, torch.float32, "warp_vec"),
    (16384, 768, torch.float32, torch.float32, "warp_vec"),
    (300, 1000, torch.bfloat16, torch.bfloat16, "warp_vec"),
    (300, 1001, torch.float16, torch.float32, "warp_scalar"),
    (1, 768, torch.float32, torch.float32, "block_vec"),
    (64, 1000, torch.bfloat16, torch.bfloat16, "block_vec"),
    (37, 4096, torch.float32, torch.float32, "block_vec"),
    (16, 8192, torch.bfloat16, torch.bfloat16, "block_vec"),
    (16, 8192, torch.float32, torch.float32, "block_vec"),
    (300, 1025, torch.bfloat16, torch.bfloat16, "block_scalar"),
    (3, 20000, torch.bfloat16, torch.bfloat16, "loop_scalar"),
])
def test_layer_norm_backward_routes_match_plain(cuda, n1, n2, dtype, wdtype,
                                                route):
    from apex_tpu_torch.ops.cuda import ln_bwd_route
    assert ln_bwd_route(n1, n2, dtype) == route
    rng = np.random.RandomState(n1 + n2)
    x = _randn(rng, (n1, n2), dtype, cuda) * 2 + 0.3
    dy = _randn(rng, (n1, n2), dtype, cuda)
    w = _randn(rng, (n2,), wdtype, cuda)
    _, mean, inv = layer_norm_fwd(x, w, torch.zeros_like(w), 1e-5)
    before = layer_norm_bwd.launches
    got = layer_norm_bwd(dy, x, w, mean, inv)
    again = layer_norm_bwd(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    assert layer_norm_bwd.launches == before + 4
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ref = layer_norm_bwd_ref(dy, x, w, mean, inv)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(got[0].float(), ref[0].float(),
                                   atol=_bf16_tol(ref[0]), rtol=0)
    for a, r in zip(got[1:], ref[1:]):
        assert a.dtype == wdtype
        if wdtype == torch.float32:
            torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
        else:
            torch.testing.assert_close(a.float(), r.float(),
                                       atol=_bf16_tol(r), rtol=0)


@pytest.mark.parametrize("route", ["warp", "block"])
def test_layer_norm_backward_vector_and_scalar_accesses_agree_bitwise(
        cuda, route):
    """A view at an odd element offset takes the element accesses, and its
    dx, dw, db equal the 16-byte groups' on a contiguous copy bit for bit
    (the same sums in the same order)."""
    n1, n2 = (300, 768) if route == "warp" else (16, 4096)
    rng = np.random.RandomState(7)
    buf = _randn(rng, (2 * n1 * n2 + 1,), torch.bfloat16, cuda)
    x = buf[1:1 + n1 * n2].view(n1, n2)
    dy = buf[1 + n1 * n2:1 + 2 * n1 * n2].view(n1, n2)
    w = _randn(rng, (n2,), torch.bfloat16, cuda)
    _, mean, inv = layer_norm_fwd(x.clone(), w, torch.zeros_like(w), 1e-5)
    odd = layer_norm_bwd(dy, x, w, mean, inv)
    aligned = layer_norm_bwd(dy.clone(), x.clone(), w, mean, inv)
    assert all(torch.equal(a, b) for a, b in zip(odd, aligned))


def test_layer_norm_backward_kernel_fp32_weight_on_bf16(cuda):
    rng = np.random.RandomState(4)
    x = _randn(rng, (64, 768), torch.bfloat16, cuda)
    dy = _randn(rng, (64, 768), torch.bfloat16, cuda)
    w = _randn(rng, (768,), torch.float32, cuda)
    _, mean, inv = layer_norm_fwd(x, w, torch.zeros_like(w), 1e-5)
    got = layer_norm_bwd(dy, x, w, mean, inv)
    ref = layer_norm_bwd_ref(dy, x, w, mean, inv)
    assert got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), ref[0].float(),
                               atol=_bf16_tol(ref[0]), rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("eps_mode,weight_decay", [(0, 0.0), (1, 0.01)])
@pytest.mark.parametrize("n", [1, 768, 4099])
def test_adam_kernel_equals_plain(cuda, n, eps_mode, weight_decay, p_dtype,
                                  g_dtype, copy):
    rng = np.random.RandomState(n)
    p = _randn(rng, (n,), p_dtype, cuda)
    m = _randn(rng, (n,), torch.float32, cuda) * 0.1
    v = _randn(rng, (n,), torch.float32, cuda).abs() * 0.01
    g = _randn(rng, (n,), g_dtype, cuda)
    pc = torch.zeros(n, dtype=torch.bfloat16, device=cuda) if copy else None
    twins = [t.clone() for t in (p, m, v)] + [
        None if pc is None else pc.clone()]
    ss = torch.tensor([1e-3], device=cuda)
    sc = torch.tensor([3.0], device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=weight_decay,
              eps_mode=eps_mode)
    before = packed_adam.launches
    packed_adam(p, m, v, g, ss, sc, flag, p_copy=pc, **kw)
    packed_adam_ref(*twins[:3], g, ss, sc, flag, p_copy=twins[3], **kw)
    torch.cuda.synchronize()
    assert packed_adam.launches == before + 1
    for a, b in zip((p, m, v, pc), twins):
        assert a is None or torch.equal(a, b)
    flag.fill_(1)
    kept = [t.clone() for t in (p, m, v)]
    packed_adam(p, m, v, g, ss, sc, flag, p_copy=pc, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((p, m, v), kept))


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("bad", [None, "inf", "nan"])
def test_scale_kernel_equals_plain(cuda, in_dtype, out_dtype, bad):
    """K6 over a one-leaf table (a leaf of 33 x 65: the vector path and an
    element tail), into a kept buffer: bit for bit the plain version,
    flags equal, one launch."""
    rng = np.random.RandomState(1)
    x = _randn(rng, (33, 65), in_dtype, cuda) * 100
    if bad is not None:
        x[7, 9] = float(bad)
    inv = torch.tensor([2.0 ** -10], device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    flag_ref = torch.zeros_like(flag)
    table = ChunkTable.of([x])
    out = torch.empty(x.shape, dtype=out_dtype, device=cuda)
    ref = torch.empty_like(out)
    before = packed_scale.launches
    assert packed_scale(table, [x], inv, flag, [out])[0] is out
    assert packed_scale.launches == before + 1
    packed_scale_ref(table, [x], inv, flag_ref, [ref])
    torch.cuda.synchronize()
    assert int(flag) == int(flag_ref) == int(bad is not None)
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))


@pytest.mark.parametrize("bad", [False, True])
def test_scale_kernel_in_place_equals_plain(cuda, bad):
    """fp32 over itself: out aliases x, at several leaf sizes (vector path
    and element tail), one launch over their table."""
    rng = np.random.RandomState(2)
    xs = [_randn(rng, (n,), torch.float32, cuda) * 1e3
          for n in (1, 7, 4096, 65537)]
    if bad:
        xs[2][5] = float("inf")
    refs = [x.clone() for x in xs]
    inv = torch.tensor([2.0 ** -16], device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    flag_ref = torch.zeros_like(flag)
    table = ChunkTable.of(xs)
    got = packed_scale(table, xs, inv, flag, xs)
    assert all(g is x for g, x in zip(got, xs))
    packed_scale_ref(table, refs, inv, flag_ref, refs)
    torch.cuda.synchronize()
    assert int(flag) == int(flag_ref) == int(bad)
    assert all(torch.equal(x, r) for x, r in zip(xs, refs))
    # the scale was applied (|x| ~ 1e3 before it)
    assert float(xs[3].abs().max()) < 1.0


#: a tree mixing every K6 dtype pair, leaves of odd sizes (one above a
#: chunk, one a view at an odd element offset)
MIXED_LEAVES = [(1, torch.bfloat16, torch.float32),
                (7, torch.float32, torch.float32),
                (CHUNK_SIZE + 3, torch.bfloat16, torch.float32),
                (1001, torch.float16, torch.float32),
                (17, torch.float32, torch.bfloat16),
                (333, torch.float16, torch.float16),
                (4096, torch.bfloat16, torch.bfloat16),
                (65, torch.float32, torch.float16),
                (129, torch.float16, torch.bfloat16)]


@pytest.mark.parametrize("where", ["kept_buffers", "in_place"])
def test_scale_kernel_over_a_mixed_tree_equals_plain(cuda, where):
    """K6 over a tree whose leaves mix fp32 / bf16 / fp16 inputs and
    outputs, an inf in one leaf and a nan in another: one launch, bit for
    bit the plain version (nans where it has them), the flag raised;
    into kept buffers, and in place (each leaf over itself)."""
    rng = np.random.RandomState(3)
    xs = []
    for i, (n, dt, _) in enumerate(MIXED_LEAVES):
        base = _randn(rng, (n + 1,), dt, cuda) * 50
        xs.append(base[1:] if i == 3 else base[:n])   # one misaligned
    xs[2][40000] = float("inf")
    xs[5][100] = float("nan")
    table = ChunkTable.of(xs)
    inv = torch.tensor([2.0 ** -7], device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    flag_ref = torch.zeros_like(flag)
    if where == "in_place":
        ins = [x.clone() for x in xs]
        ins[3] = torch.empty(xs[3].numel() + 1, dtype=xs[3].dtype,
                             device=cuda)[1:].copy_(xs[3])
        outs, refs = ins, [x.clone() for x in xs]
        ins_ref = refs
    else:
        ins = ins_ref = xs
        outs = table.empty_views([x.shape for x in xs],
                                 [o for _, _, o in MIXED_LEAVES])
        refs = [torch.empty_like(o) for o in outs]
    before = packed_scale.launches
    packed_scale(table, ins, inv, flag, outs)
    again = [o.clone() for o in outs] if where == "kept_buffers" else None
    assert packed_scale.launches == before + 1
    packed_scale_ref(table, ins_ref, inv, flag_ref, refs)
    torch.cuda.synchronize()
    assert int(flag) == int(flag_ref) == 1
    for o, r in zip(outs, refs):
        assert o.dtype == r.dtype
        assert torch.equal(o.isnan(), r.isnan())
        assert torch.equal(o.nan_to_num(), r.nan_to_num())
    if again is not None:
        packed_scale(table, ins, inv, flag, outs)
        assert all(torch.equal(a.nan_to_num(), o.nan_to_num())
                   for a, o in zip(again, outs))


def test_scale_kernel_refuses_a_strided_leaf(cuda):
    """A leaf that is not contiguous is refused, not copied: an in-place
    call must write where it reads."""
    x = torch.zeros(8, 8, device=cuda).t()
    table = ChunkTable.of([x])
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        packed_scale(table, [x], torch.ones(1, device=cuda), flag, [x])


def test_unscale_is_one_launch_over_every_gradient(cuda):
    """``LossScaler.unscale`` of a mixed bf16 / fp32 list with a strided
    gradient: one K6 launch a call, into kept buffers and into new
    views, equal to the plain version's bits."""
    from apex_tpu_torch.amp.scaler import LossScaler
    rng = np.random.RandomState(4)
    grads = [_randn(rng, s, d, cuda) * 100 for s, d in (
        ((3, 5), torch.bfloat16), ((70000,), torch.float32),
        ((8, 9), torch.float32), ((31,), torch.bfloat16))]
    grads[2] = grads[2].t()
    scaler = LossScaler()
    state = scaler.init_state(cuda)
    bufs = [torch.empty(g.shape, device=cuda) for g in grads]
    before = packed_scale.launches
    kept, flag = scaler.unscale(grads, state, out=bufs)
    fresh, flag2 = scaler.unscale(grads, state)
    assert packed_scale.launches == before + 2
    torch.cuda.synchronize()
    assert int(flag) == int(flag2) == 0
    assert all(k is b for k, b in zip(kept, bufs))
    for g, k, f in zip(grads, kept, fresh):
        want = (g.float() * 2.0 ** -16)
        assert torch.equal(k, want) and torch.equal(f, want)


def test_sumsq_kernel_over_one_flat_leaf(cuda):
    """K9 over one flat fp32 buffer (FP16Optimizer's one-leaf table):
    within rtol 1e-5 of the plain sum, and repeating bitwise."""
    rng = np.random.RandomState(3)
    flat = _randn(rng, (3 * CHUNK_SIZE + 5,), torch.float32, cuda) * 300
    table = ChunkTable([flat.numel()], cuda)
    s, again = packed_sumsq(table, [flat]), packed_sumsq(table, [flat])
    ref = packed_sumsq_ref(table, [flat])
    torch.cuda.synchronize()
    assert torch.equal(s, again)
    torch.testing.assert_close(s, ref, rtol=1e-5, atol=0)


#: opt level -> (flash_attn_bwd launches a call, loss tolerance card vs
#: CPU): the fp32 backward kernel launches twice (dk/dv, then dq); bf16
#: rounds at other places in cuBLAS and on the CPU
TRAIN_LEVELS = {"O0": (2, 1e-4), "O3": (1, 2e-2)}


@pytest.mark.parametrize("opt_level", sorted(TRAIN_LEVELS))
def test_train_step_launches_every_kernel_and_matches_the_cpu(cuda,
                                                              opt_level):
    """Two steps of a 2-layer 2 x 64-head GPT on the card and on the CPU
    from the same weights, in fp32 (O0) and in bf16 without master
    weights (O3: K5 steps the bf16 parameters with bf16 gradients): the
    card launches each kernel the expected number of times per step, and
    the losses agree."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTConfig, GPTModel, lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    torch.manual_seed(0)
    state = GPTModel(cfg, device="cpu").state_dict()
    ids = torch.as_tensor((np.arange(64)[None] + np.arange(4)[:, None] * 7)
                          % 512)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = GPTModel(cfg, device=dev)
        model.load_state_dict(state)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev),
                           opt_level=opt_level, device=dev)
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
        reset_launch_counts()
        losses[dev] = [float(step(ids.to(dev))["loss"]) for _ in range(2)]
        counts = launch_counts()
    per_call, atol = TRAIN_LEVELS[opt_level]
    # FusedAdam: one K11 launch a step over every leaf, no K5; the
    # unscale: one K6 launch a step over every leaf; attention
    # in bf16 on K2 (after its k^ prologue: the GPT rotates) and K4 (after
    # its q^ / k^ prologue, then the finish pass), in fp32 on the generic
    # kernels (two backward launches a call)
    half = opt_level != "O0"
    assert per_call == (1 if half else 2)
    assert counts == {"layer_norm_fwd": 10, "flash_attn_fwd": 4 * half,
                      "layer_norm_bwd": 20, "flash_attn_bwd": 4 * half,
                      "packed_adam": 0, "packed_scale": 2,
                      "lamb_stage1": 0, "lamb_stage2": 0,
                      "packed_sumsq": 0, "packed_axpby": 0,
                      "packed_adam_tree": 2, "sumsq_per_tensor": 0,
                      "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                      "flash_bwd_prologue": 4 * half,
                      "flash_bwd_finish": 4 * half,
                      "conv1x1_bwd": 0, "packed_nonfinite": 0,
                      "flash_mh_fwd": 0, "flash_mh_bwd": 0,
                      "flash_fwd_prologue": 4 * half,
                      "flash_fwd_simt": 4 * (not half),
                      "flash_bwd_simt": 4 * per_call * (not half)}
    want_dtype = torch.float32 if opt_level == "O0" else torch.bfloat16
    assert all(p.dtype == want_dtype for p in model.parameters())
    assert all(np.isfinite(losses["cuda"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=atol,
                               rtol=0)



#: leaf sizes of the LAMB kernel tests: smaller than a chunk, not a
#: multiple of the chunk (nor of 4), an all-zero leaf (trust ratio falls
#: back to lr), a leaf of no elements, an odd tail
LAMB_SIZES = [1000, 2 * CHUNK_SIZE + 5, 4096, 0, 7]


def _lamb_case(cuda, p_dtype, g_dtype, seed=0):
    rng = np.random.RandomState(seed)
    leaves = lambda dt, s: [_randn(rng, (n,), dt, cuda) * s
                            for n in LAMB_SIZES]
    p, g = leaves(p_dtype, 0.05), leaves(g_dtype, 0.3)
    p[2].zero_()
    m = leaves(torch.float32, 1e-2)
    v = [t.abs() for t in leaves(torch.float32, 1e-4)]
    table = ChunkTable.of(p)
    _, u = table.flat_views([t.shape for t in p])
    bc1 = torch.tensor([0.1, 0.19, 0.271, 0.1, 0.1], device=cuda)
    bc2 = torch.tensor([1e-3, 2e-3, 3e-3, 1e-3, 1e-3], device=cuda)
    return table, p, g, m, v, u, bc1, bc2


LAMB_KW = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
               max_grad_norm=1.0)


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_lamb_kernels_match_plain(cuda, p_dtype, g_dtype):
    table, p, g, m, v, u, bc1, bc2 = _lamb_case(cuda, p_dtype, g_dtype)
    assert table.n_chunks == 1 + 3 + 1 + 0 + 1
    twins = [[t.clone() for t in ts] for ts in (p, m, v, u)]
    copies = [torch.zeros(t.shape, dtype=torch.bfloat16, device=cuda)
              for t in p] if p_dtype == torch.float32 else None
    copies_ref = None if copies is None else [c.clone() for c in copies]
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = (packed_sumsq.launches, lamb_stage1.launches,
              lamb_stage2.launches)
    s = packed_sumsq(table, g)
    s_again = packed_sumsq(table, g)
    s_ref = packed_sumsq_ref(table, g)
    torch.cuda.synchronize()
    assert torch.equal(s, s_again)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=0)
    parts = lamb_stage1(table, p, g, m, v, u, bc1, bc2, s, flag, **LAMB_KW)
    parts_ref = lamb_stage1_ref(table, twins[0], g, *twins[1:], bc1, bc2, s,
                                flag, **LAMB_KW)
    torch.cuda.synchronize()
    for a, b in zip((m, v, u), twins[1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(parts, parts_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-30)
    # stage 2 from the kernel's partials on both sides
    lamb_stage2(table, p, u, *parts, flag, lr=1e-3, p_copy=copies)
    lamb_stage2_ref(table, twins[0], twins[3], *parts, flag, lr=1e-3,
                    p_copy=copies_ref)
    torch.cuda.synchronize()
    assert (packed_sumsq.launches, lamb_stage1.launches,
            lamb_stage2.launches) == (before[0] + 2, before[1] + 1,
                                      before[2] + 1)
    for a, b in zip(p, twins[0]):
        if p_dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert bf16_ulp_distance(a, b) <= 1
    if copies is not None:
        for a, b in zip(copies, copies_ref):
            assert bf16_ulp_distance(a, b) <= 1
        for c, t in zip(copies, p):
            assert torch.equal(c, t.to(torch.bfloat16))
    # the zero leaf stepped by lr * u (trust ratio 1)
    torch.testing.assert_close(p[2].float(), (-1e-3 * u[2]).to(p_dtype)
                               .float(), rtol=0, atol=0)


def test_lamb_kernels_repeat_bitwise_and_skip_under_the_flag(cuda):
    table, p, g, m, v, u, bc1, bc2 = _lamb_case(cuda, torch.float32,
                                                torch.float32, seed=1)
    start = [[t.clone() for t in ts] for ts in (p, m, v)]
    runs = []
    for _ in range(2):
        ps, ms, vs = ([t.clone() for t in ts] for ts in start)
        _, us = table.flat_views([t.shape for t in p])
        s = packed_sumsq(table, g)
        parts = lamb_stage1(table, ps, g, ms, vs, us, bc1, bc2, s, None,
                            **LAMB_KW)
        lamb_stage2(table, ps, us, *parts, None, lr=1e-3)
        runs.append((s, parts, ps, ms, vs, us))
    torch.cuda.synchronize()
    a, b = runs
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    for xs, ys in zip(a[2:], b[2:]):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    # under a set flag neither stage writes anything
    flag = torch.ones(1, dtype=torch.int32, device=cuda)
    copies = [torch.full(t.shape, 7.0, dtype=torch.bfloat16, device=cuda)
              for t in p]
    kept = [[t.clone() for t in ts] for ts in (p, m, v, u)]
    s = packed_sumsq(table, g)
    parts = lamb_stage1(table, p, g, m, v, u, bc1, bc2, s, flag, **LAMB_KW)
    lamb_stage2(table, p, u, *parts, flag, lr=1e-3, p_copy=copies)
    torch.cuda.synchronize()
    for xs, ys in zip((p, m, v, u), kept):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert all(torch.all(c == 7.0) for c in copies)


def test_lamb_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    table, p, g, m, v, u, bc1, bc2 = _lamb_case(cuda, torch.float32,
                                                torch.float32)
    with pytest.raises(ValueError, match="leaf sizes"):
        packed_sumsq(table, g[:-1])
    with pytest.raises(TypeError, match="want one of"):
        lamb_stage1(table, p, [t.half() for t in g], m, v, u, bc1, bc2,
                    None, None, **LAMB_KW)
    with pytest.raises(ValueError, match="bc1"):
        lamb_stage1(table, p, g, m, v, u, bc1[:2], bc2, None, None,
                    **LAMB_KW)


BERT_ATTN = [(4, 512, 16, 64), (4, 512, 8, 128)]


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("shape", BERT_ATTN)
def test_flash_kernels_at_bert_shapes_with_a_ragged_mask(cuda, shape,
                                                         layout):
    """BERT's attention: non-causal, no rope, a key mask padding each
    row's end, q/k/v as strided views of one qkv product (blhd) or
    head-major views (bhld), forward and backward through the autograd
    function against the plain versions."""
    from apex_tpu_torch.attention import attention
    bsz, l, h, d = shape
    rng = np.random.RandomState(l + h)
    keep = l - 61 * np.arange(bsz)
    mask = torch.as_tensor(np.arange(l)[None, :] < keep[:, None],
                           device=cuda)
    if layout == "blhd":
        qkv = _randn(rng, (bsz, l, 3, h, d), torch.bfloat16, cuda)
        q, k, v = qkv.requires_grad_().unbind(2)
    else:
        q, k, v = (_randn(rng, (bsz, h, l, d), torch.bfloat16, cuda)
                   .requires_grad_() for _ in range(3))
    fwd0, bwd0 = flash_attn_fwd.launches, flash_attn_bwd.launches
    o = attention(q, k, v, kv_mask=mask, layout=layout)
    do = torch.randn_like(o)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attn_fwd.launches, flash_attn_bwd.launches) == (fwd0 + 1,
                                                                  bwd0 + 1)
    to_blhd = (lambda t: t.transpose(1, 2)) if layout == "bhld" \
        else (lambda t: t)
    qb, kb, vb, ob, dob = (to_blhd(t.detach()) for t in (q, k, v, o, do))
    o_ref, lse = flash_attn_fwd_ref(qb.float(), kb.float(), vb.float(),
                                    kv_mask=mask)
    torch.testing.assert_close(ob.float(), o_ref, atol=2e-2, rtol=0)
    _, lse_k = flash_attn_fwd(qb, kb, vb, kv_mask=mask, return_lse=True)
    ref = flash_attn_bwd_ref(qb, kb, vb, ob, lse_k, dob, kv_mask=mask)
    for a, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(to_blhd(a).float(), r.float(),
                                   atol=_bf16_tol(r), rtol=0)


def test_bert_train_step_launches_every_kernel_and_matches_the_cpu(cuda):
    """Two steps of a 2-layer 2 x 64-head BERT, amp O0 + FusedLAMB, on the
    card and on the CPU from the same weights: each LAMB kernel launches
    once a step, K6 once a leaf (O0 unscales by its static scale 1), and
    the losses agree within 1e-4 (cuBLAS and the CPU sum in other
    orders)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       pretraining_loss)
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256,
                     max_position_embeddings=64)
    torch.manual_seed(0)
    state = BertForPreTraining(cfg, device="cpu").state_dict()
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, 1024, (4, 64)))
    attn = torch.as_tensor(np.arange(64)[None] < (64 - 9 * np.arange(4))
                           [:, None]).int()
    mlm = torch.as_tensor(rng.rand(4, 64) < 0.15).float()
    nsp = torch.as_tensor(rng.randint(0, 2, (4,)))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = BertForPreTraining(cfg, device=dev)
        model.load_state_dict(state)
        a = amp.initialize(model, FusedLAMB(model.parameters(), device=dev),
                           opt_level="O0", device=dev)

        def loss_fn(m, i, t, msk, lab, w, n):
            x, y = m(i, t, msk)
            return pretraining_loss(x, y, lab, n, w)
        step = amp.make_train_step(a, model, loss_fn)
        batch = [t.to(dev) for t in (ids, torch.zeros_like(ids), attn, ids,
                                     mlm, nsp)]
        reset_launch_counts()
        losses[dev] = [float(step(*batch)["loss"]) for _ in range(2)]
        counts = launch_counts()
    # attention in fp32: the generic kernels (two backward launches)
    assert counts == {"layer_norm_fwd": 2 * 6, "flash_attn_fwd": 0,
                      "flash_fwd_simt": 2 * 2, "flash_bwd_simt": 2 * 2 * 2,
                      "flash_fwd_prologue": 0,
                      "layer_norm_bwd": 2 * 6 * 2, "flash_attn_bwd": 0,
                      "packed_adam": 0, "packed_scale": 2,
                      "lamb_stage1": 2,
                      "lamb_stage2": 2, "packed_sumsq": 2,
                      "packed_axpby": 0, "packed_adam_tree": 0,
                      "sumsq_per_tensor": 0, "flash_attn_bwd_dq": 0,
                      "flash_attn_bwd_dkv": 0,
                      "flash_bwd_prologue": 0, "flash_bwd_finish": 0,
                      "conv1x1_bwd": 0, "packed_nonfinite": 0,
                      "flash_mh_fwd": 0, "flash_mh_bwd": 0}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4,
                               rtol=0)


def test_bert_o2_steps_upload_the_pointer_rows_once(cuda):
    """Under amp O2 the unscale writes into gradient buffers that keep
    their storage, so FusedLAMB's chunk table uploads its pointer rows in
    the first step and reuses them after (no host copy on later steps)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       pretraining_loss)
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256,
                     max_position_embeddings=64)
    torch.manual_seed(0)
    model = BertForPreTraining(cfg, device=cuda)
    opt = FusedLAMB(model.parameters())
    a = amp.initialize(model, opt, opt_level="O2")

    def loss_fn(m, i, t, msk, lab, w, n):
        x, y = m(i, t, msk)
        return pretraining_loss(x, y, lab, n, w)
    step = amp.make_train_step(a, model, loss_fn)
    ids = torch.randint(0, 1024, (4, 64), device=cuda)
    batch = [ids, torch.zeros_like(ids), torch.ones_like(ids), ids,
             (torch.rand(4, 64, device=cuda) < 0.15).float(),
             torch.randint(0, 2, (4,), device=cuda)]
    step(*batch)
    first = (opt.table.lookups, opt.table.uploads)
    losses = [float(step(*batch)["loss"]) for _ in range(3)]
    assert first[1] == 6          # p, g, m, v, u and the bf16 copies
    assert opt.table.lookups == 4 * first[0]
    assert opt.table.uploads == first[1]
    assert np.isfinite(losses).all()


#: leaf sizes of the multi-tensor tests: one element, around a chunk, a
#: leaf of no elements, a ragged multi-chunk leaf, an odd tail
MT_SIZES = [1, CHUNK_SIZE - 1, CHUNK_SIZE + 1, 0, 3 * CHUNK_SIZE + 5, 7]


def _mt_leaves(rng, dtype, dev, scale=1.0, sizes=MT_SIZES):
    return [_randn(rng, (n,), dtype, dev) * scale for n in sizes]


@pytest.mark.parametrize("bad_in", [None, "x", "y"])
@pytest.mark.parametrize("arg_to_check", [-1, 0, 1])
@pytest.mark.parametrize("x_dtype,y_dtype,out_dtype,in_place", [
    # the accumulation: bf16 gradients onto fp32 accumulators, in place
    (torch.bfloat16, torch.float32, torch.float32, None),
    (torch.bfloat16, torch.float32, torch.float32, "y"),
    (torch.float32, torch.float32, torch.float32, None),
    (torch.float32, torch.float32, torch.float32, "x"),
    (torch.float32, torch.bfloat16, torch.bfloat16, None),
    (torch.float32, torch.bfloat16, torch.bfloat16, "y")])
def test_axpby_kernel_equals_plain(cuda, x_dtype, y_dtype, out_dtype,
                                   in_place, arg_to_check, bad_in):
    rng = np.random.RandomState(11)
    x = _mt_leaves(rng, x_dtype, cuda, 100.0)
    y = _mt_leaves(rng, y_dtype, cuda)
    if bad_in == "x":
        x[4][CHUNK_SIZE + 3] = float("inf")
    elif bad_in == "y":
        y[2][5] = float("nan")
    table = ChunkTable.of(x)
    a = torch.tensor([2.0 ** -12], device=cuda)
    b = torch.tensor([0.75], device=cuda)
    runs = []
    for fn in (packed_axpby, packed_axpby, packed_axpby_ref):
        xs, ys = [t.clone() for t in x], [t.clone() for t in y]
        out = {"x": xs, "y": ys}.get(in_place) or [
            torch.empty(t.shape, dtype=out_dtype, device=cuda) for t in x]
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        fn(table, xs, ys, a, b, flag, out, arg_to_check=arg_to_check)
        runs.append((out, flag))
    torch.cuda.synchronize()
    want = {None: 0, "x": int(arg_to_check in (-1, 0)),
            "y": int(arg_to_check in (-1, 1))}[bad_in]
    for out, flag in runs:
        assert int(flag) == want
        for o, r in zip(out, runs[-1][0]):
            assert torch.equal(o.isnan(), r.isnan())
            assert torch.equal(torch.nan_to_num(o), torch.nan_to_num(r))


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("eps_mode,weight_decay", [(0, 0.0), (1, 0.01)])
def test_adam_tree_kernel_equals_plain_and_k5(cuda, eps_mode, weight_decay,
                                              p_dtype, g_dtype, copy):
    """K11 over the chunk table against its plain version and against K5
    launched leaf by leaf: bitwise, twice; nothing written under the noop
    flag."""
    rng = np.random.RandomState(12)
    p = _mt_leaves(rng, p_dtype, cuda)
    m = _mt_leaves(rng, torch.float32, cuda, 0.1)
    v = [t.abs() for t in _mt_leaves(rng, torch.float32, cuda, 0.01)]
    g = _mt_leaves(rng, g_dtype, cuda)
    copies = [torch.zeros(n, dtype=torch.bfloat16, device=cuda)
              for n in MT_SIZES] if copy else None
    table = ChunkTable.of(p)
    sizes = torch.linspace(1e-3, 3e-3, len(MT_SIZES), device=cuda)
    scale = torch.tensor([4.0], device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=weight_decay,
              eps_mode=eps_mode)

    def state():
        return [[t.clone() for t in ls] for ls in (p, m, v)] + [
            None if copies is None else [c.clone() for c in copies]]
    runs = []
    for fn in ("tree", "tree", "ref", "k5"):
        ps, ms, vs, cs = state()
        before = packed_adam_tree.launches
        if fn == "k5":
            for i, n in enumerate(MT_SIZES):
                packed_adam(ps[i], ms[i], vs[i], g[i], sizes[i:i + 1],
                            scale, flag, p_copy=None if cs is None
                            else cs[i], **kw)
        else:
            (packed_adam_tree if fn == "tree" else packed_adam_tree_ref)(
                table, ps, ms, vs, g, sizes, scale, flag, p_copy=cs, **kw)
            assert packed_adam_tree.launches == before + (fn == "tree")
        runs.append([ps, ms, vs] + ([cs] if cs is not None else []))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for xs, ys in zip(runs[0], other):
            assert all(torch.equal(a, b) for a, b in zip(xs, ys))
    flag.fill_(1)
    kept = [[t.clone() for t in ls] for ls in runs[0]]
    packed_adam_tree(table, *runs[0][:3], g, sizes, scale, flag,
                     p_copy=runs[0][3] if copy else None, **kw)
    torch.cuda.synchronize()
    for xs, ys in zip(runs[0], kept):
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sumsq_per_tensor_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(13)
    xs = _mt_leaves(rng, dtype, cuda, 3.0)
    table = ChunkTable.of(xs)
    before = sumsq_per_tensor.launches
    got = sumsq_per_tensor(table, xs)
    again = sumsq_per_tensor(table, xs)
    ref = sumsq_per_tensor_ref(table, xs)
    torch.cuda.synchronize()
    assert sumsq_per_tensor.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    assert float(got[3]) == 0.0
    # the ticket is left at zero: K9 over the same table still works
    torch.testing.assert_close(packed_sumsq(table, xs), ref.sum()
                               .reshape(1), rtol=1e-5, atol=0)


def _small_gpt(dev, state=None):
    from apex_tpu_torch.models import GPTConfig, GPTModel
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    torch.manual_seed(0)
    model = GPTModel(cfg, device=dev)
    if state is not None:
        model.load_state_dict(state)
    return cfg, model


def test_accumulated_train_step_launches_and_matches_the_cpu(cuda):
    """``accum_steps=4`` at O2 over 8 rows: per step K10 4 (one a
    micro-batch, unscaling onto the accumulators), K15 1 (the finite
    check of the accumulated gradients), K6 0, K11 1, K5 0, and 4 x the
    forward and backward kernels of one micro-batch; the losses agree
    with the CPU's within O2's 2e-2."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    state = _small_gpt("cpu")[1].state_dict()
    ids = torch.as_tensor((np.arange(64)[None] + np.arange(8)[:, None] * 7)
                          % 512)
    losses = {}
    for dev in ("cpu", "cuda"):
        _, model = _small_gpt(dev, state)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev),
                           opt_level="O2", device=dev)
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]),
            accum_steps=4)
        reset_launch_counts()
        losses[dev] = [float(step(ids.to(dev))["loss"]) for _ in range(2)]
        counts = launch_counts()
    assert counts == {"layer_norm_fwd": 2 * 4 * 5, "flash_attn_fwd": 2 * 4 * 2,
                      "flash_fwd_prologue": 2 * 4 * 2, "flash_fwd_simt": 0,
                      "flash_bwd_simt": 0, "layer_norm_bwd": 2 * 4 * 10,
                      "flash_attn_bwd": 2 * 4 * 2, "packed_adam": 0,
                      "packed_scale": 0, "lamb_stage1": 0,
                      "lamb_stage2": 0, "packed_sumsq": 0,
                      "packed_axpby": 2 * 4, "packed_adam_tree": 2,
                      "sumsq_per_tensor": 0, "flash_attn_bwd_dq": 0,
                      "flash_attn_bwd_dkv": 0,
                      "flash_bwd_prologue": 2 * 4 * 2,
                      "flash_bwd_finish": 2 * 4 * 2,
                      "conv1x1_bwd": 0, "packed_nonfinite": 2,
                      "flash_mh_fwd": 0, "flash_mh_bwd": 0}
    assert all(np.isfinite(losses["cuda"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=2e-2,
                               rtol=0)


def test_fp16_optimizer_step_is_one_k5_and_one_k9_launch(cuda):
    from apex_tpu_torch.models import lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FP16Optimizer
    state = _small_gpt("cpu")[1].state_dict()
    ids = torch.as_tensor((np.arange(64)[None] + np.arange(4)[:, None] * 7)
                          % 512)
    out = {}
    for dev in ("cpu", "cuda"):
        _, model = _small_gpt(dev, state)
        opt = FP16Optimizer(model, lr=3e-3, dynamic_loss_scale=True,
                            max_grad_norm=1.0, device=dev)
        x = ids.to(dev)
        for i in range(2):
            loss = lm_loss(model(x)[:, :-1], x[:, 1:])
            grads = torch.autograd.grad(opt.scale_loss(loss),
                                        opt.model_params)
            if i == 1:
                reset_launch_counts()
            info = opt.step(grads)
            counts = launch_counts()
        out[dev] = (float(loss.detach()), float(info["grad_norm"]),
                    opt.master.cpu())
    assert counts["packed_adam"] == 1 and counts["packed_sumsq"] == 1
    assert sum(counts.values()) == 2
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2e-2
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=2e-2)


# -- the two-pass flash backward (K13 dq, K14 dk / dv) ----------------------

ENV_BUDGET = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", CASES + [(1, 4096, 2, 64), (2, 300, 3, 40),
                                           (1, 333, 2, 96)])
def test_two_pass_backward_kernels_match_plain(cuda, shape, causal, masked,
                                               rope):
    """K13 and K14 against their plain versions in bf16 over K4's shapes,
    L 4096 and the head widths 40 and 96 that TMA pads to 64 and 128:
    within 2 bf16 ulps of the largest gradient and by the row and norm
    checks of ``_assert_rows_close``, one launch each a call, equal bits
    on a second run; where K4 takes the shape, its dq, dk and dv within
    the same limits of K13's and K14's; rows that see no key get zeros.
    A head width K2 does not take gets its forward from the plain
    version."""
    from apex_tpu_torch.ops.cuda import (attn_delta, flash_attn_bwd_dkv,
                                         flash_attn_bwd_dkv_ref,
                                         flash_attn_bwd_dq,
                                         flash_attn_bwd_dq_ref,
                                         flash_attn_fwd_ref)
    bsz, l, h, d = shape
    dtype = torch.bfloat16
    rng = np.random.RandomState(5 * l + d)
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[:, 0] = True
        mask[0, :] = False            # batch 0: every row sees no key
    kw = dict(causal=causal, kv_mask=mask,
              rope=_tables(bsz, l, d, dtype, cuda) if rope else None)
    k2_width = d in (64, 128)
    o, lse = (flash_attn_fwd(q, k, v, return_lse=True, **kw) if k2_width
              else flash_attn_fwd_ref(q, k, v, **kw))
    delta = attn_delta(o, do, None)
    before = (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches)
    dq = flash_attn_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq2 = flash_attn_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = flash_attn_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    ref = (flash_attn_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
           *flash_attn_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))
    for a, r in zip((dq, dk, dv), ref):
        assert a.dtype == dtype and a.shape == q.shape
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r),
                                   rtol=0)
        _assert_rows_close(a, r)
    if k2_width:
        for a, f in zip((dq, dk, dv), flash_attn_bwd(q, k, v, o, lse, do,
                                                     **kw)):
            torch.testing.assert_close(a.float(), f.float(),
                                       atol=_bf16_tol(f), rtol=0)
            _assert_rows_close(a, f)
    if masked:
        assert all(torch.all(g[0] == 0) for g in (dq, dk, dv))


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [8, 24, 40, 64, 96, 128])
def test_two_pass_prologue_equals_plain_bitwise(cuda, d, rope):
    """The two-pass prologue on the strided views of a fused qkv product:
    q^ and k^ equal their plain version's bits (8- and 16-byte chunks),
    one launch a call; with neither tables nor a scale other than 1, no
    launch (q^ is q, k^ is k)."""
    from apex_tpu_torch.ops.cuda import (flash_bwd_prologue,
                                         flash_bwd_prologue_ref)
    b, l, h = 2, 77, 3
    qkv = _randn(np.random.RandomState(d), (b, l, 3 * h * d),
                 torch.bfloat16, cuda)
    q, k, _ = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    tables = _tables(b, l, d, torch.bfloat16, cuda) if rope else None
    before = flash_bwd_prologue.launches
    got = flash_bwd_prologue(q, k, scale=d ** -0.5, rope=tables)
    want = flash_bwd_prologue_ref(q, k, scale=d ** -0.5, rope=tables)
    torch.cuda.synchronize()
    assert flash_bwd_prologue.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    same = flash_bwd_prologue(q, k, scale=1.0)
    assert flash_bwd_prologue.launches == before + 1
    assert same[0] is q and same[1] is k


def test_two_pass_wrappers_refuse_what_tma_refuses(cuda):
    """A head width off a multiple of 8, or operand rows off 16-byte
    boundaries, raise ``ValueError`` before any launch."""
    from apex_tpu_torch.ops.cuda import (attn_delta, flash_attn_bwd_dkv,
                                         flash_attn_bwd_dq)
    lse = torch.zeros((1, 64, 2), device=cuda)
    q36 = torch.zeros((1, 64, 2, 36), device=cuda, dtype=torch.bfloat16)
    before = (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn_bwd_dq(q36, q36, q36, q36, lse, lse)
    wide = torch.zeros((1, 64, 2, 72), device=cuda, dtype=torch.bfloat16)
    off = wide[..., 4:68]                   # rows 8 bytes off a boundary
    with pytest.raises(ValueError, match="16-byte"):
        flash_attn_bwd_dkv(off, off, off, off, lse, attn_delta(off, off,
                                                               None))
    assert (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches) == before


def test_route_switches_at_the_budget(cuda, monkeypatch):
    """``flash_attn_bwd`` takes K4 while its planes fit the budget and
    K13 + K14 above it: at the planes' exact size fused, one byte less
    two-pass; both routes within 2 bf16 ulps of each other."""
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd_dkv,
                                         flash_attn_bwd_dq,
                                         fused_bwd_partials_bytes)
    shape = (2, 200, 3, 64)
    rng = np.random.RandomState(11)
    q, k, v, do = (_randn(rng, shape, torch.bfloat16, cuda)
                   for _ in range(4))
    o, lse = flash_attn_fwd(q, k, v, causal=True, return_lse=True)
    planes = fused_bwd_partials_bytes(*shape, torch.bfloat16)
    out = {}
    for budget in (planes, planes - 1):
        monkeypatch.setenv(ENV_BUDGET, str(budget))
        counts = (flash_attn_bwd.launches, flash_attn_bwd_dq.launches,
                  flash_attn_bwd_dkv.launches)
        out[budget] = flash_attn_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        delta = [a - b for a, b in zip(
            (flash_attn_bwd.launches, flash_attn_bwd_dq.launches,
             flash_attn_bwd_dkv.launches), counts)]
        assert delta == ([1, 0, 0] if budget == planes else [0, 1, 1])
    for a, b in zip(out[planes], out[planes - 1]):
        torch.testing.assert_close(a.float(), b.float(), atol=_bf16_tol(a),
                                   rtol=0)


def test_remat_train_step_on_the_two_pass_route_matches_the_cpu(
        cuda, monkeypatch):
    """Two O2 steps of a 2-layer 2 x 64-head GPT with ``remat=True`` and
    the budget at 0 (the two-pass route), card against CPU from the same
    weights: per step K2 twice a layer (the recompute), K13 and K14 once
    a layer, K4 none; losses within O2's 2e-2."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTConfig, GPTModel, lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    monkeypatch.setenv(ENV_BUDGET, "0")
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, remat=True)
    torch.manual_seed(0)
    state = GPTModel(cfg, device="cpu").state_dict()
    ids = torch.as_tensor((np.arange(128)[None] + np.arange(4)[:, None] * 7)
                          % 512)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = GPTModel(cfg, device=dev)
        model.load_state_dict(state)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev),
                           opt_level="O2", device=dev)
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
        reset_launch_counts()
        losses[dev] = [float(step(ids.to(dev))["loss"]) for _ in range(2)]
        counts = launch_counts()
    assert counts == {"layer_norm_fwd": 2 * 9, "flash_attn_fwd": 2 * 4,
                      "flash_fwd_prologue": 2 * 4, "flash_fwd_simt": 0,
                      "flash_bwd_simt": 0,
                      "layer_norm_bwd": 2 * 10, "flash_attn_bwd": 0,
                      "packed_adam": 0, "packed_scale": 2,
                      "lamb_stage1": 0, "lamb_stage2": 0,
                      "packed_sumsq": 0, "packed_axpby": 0,
                      "packed_adam_tree": 2, "sumsq_per_tensor": 0,
                      "flash_attn_bwd_dq": 2 * 2, "flash_attn_bwd_dkv": 2 * 2,
                      "flash_bwd_prologue": 2 * 2, "flash_bwd_finish": 0,
                      "conv1x1_bwd": 0, "packed_nonfinite": 0,
                      "flash_mh_fwd": 0, "flash_mh_bwd": 0}
    assert all(np.isfinite(losses["cuda"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=2e-2,
                               rtol=0)


#: ResNet-50's 1x1 stride-1 convs at B 256 x 224^2, (M, cin, cout): the
#: shapes K16 takes on that model's step
RN50_CONV1X1 = [(802816, 64, 64), (802816, 64, 256), (802816, 256, 64),
                (802816, 256, 128), (200704, 512, 128), (200704, 128, 512),
                (200704, 512, 256), (50176, 1024, 256), (50176, 256, 1024),
                (50176, 1024, 512), (12544, 2048, 512), (12544, 512, 2048)]


def _conv1x1_check(cuda, m, cin, cout, dtype, seed):
    """K16 against its plain version: bf16 / fp16 within 2 ulps of the
    largest element of each result (both sum in fp32 and round once, in
    other orders), fp32 within ``1e-5`` of it; two runs equal bit for
    bit; one launch a call."""
    from apex_tpu_torch.ops.cuda import conv1x1_bwd, conv1x1_bwd_ref
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, cin), generator=g, device=cuda).to(dtype)
    dy = torch.randn((m, cout), generator=g, device=cuda).to(dtype)
    w = (torch.randn((cin, cout), generator=g, device=cuda) * 0.05).to(dtype)
    before = conv1x1_bwd.launches
    dx, dw = conv1x1_bwd(x, dy, w)
    dx2, dw2 = conv1x1_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert conv1x1_bwd.launches == before + 2
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    rdx, rdw = conv1x1_bwd_ref(x, dy, w)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for got, ref in ((dx, rdx), (dw, rdw)):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(
            got.float(), ref.float(), rtol=0,
            atol=rel * max(1.0, float(ref.float().abs().max())))


@pytest.mark.parametrize("m,cin,cout", RN50_CONV1X1)
def test_conv1x1_kernel_matches_plain_at_resnet50_shapes(cuda, m, cin, cout):
    _conv1x1_check(cuda, m, cin, cout, torch.bfloat16, cin + cout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,cin,cout", [
    (128, 64, 64), (4096, 256, 128), (12544, 512, 2048),
    (1000, 24, 40), (37, 3, 5), (300, 130, 70), (5000, 129, 257)])
def test_conv1x1_kernel_matches_plain_small_and_ragged(cuda, m, cin, cout,
                                                        dtype):
    _conv1x1_check(cuda, m, cin, cout, dtype, m + cin)


# K16's routes (``conv1x1_route``): fp16 at two ResNet-50 shapes, a
# ragged two_role shape, one 64 x 64 dW tile, a half type off the 8 grid
# and a misaligned view (the CUDA-core route), fp32
@pytest.mark.parametrize("m,cin,cout,dtype,route", [
    (802816, 64, 256, torch.float16, "one_pass"),
    (50176, 1024, 256, torch.float16, "two_role"),
    (12345, 192, 320, torch.bfloat16, "two_role"),
    (1000, 24, 40, torch.float16, "one_pass"),
    (1001, 20, 36, torch.bfloat16, "fma"),
    (50176, 1024, 256, torch.float32, "fma"),
])
def test_conv1x1_kernel_routes_match_plain(cuda, m, cin, cout, dtype, route):
    from apex_tpu_torch.ops.cuda import conv1x1_route
    assert conv1x1_route(m, cin, cout, dtype) == route
    _conv1x1_check(cuda, m, cin, cout, dtype, m + cout)


def test_conv1x1_misaligned_view_takes_the_fma_route(cuda):
    """x at an odd element offset: TMA cannot take it, so the CUDA-core
    route does, within the same 2 ulps of each result's largest element
    as the other routes."""
    from apex_tpu_torch.ops.cuda import (conv1x1_bwd, conv1x1_bwd_ref,
                                         conv1x1_route)
    m, cin, cout = 4096, 64, 64
    g = torch.Generator(device=cuda).manual_seed(9)
    buf = torch.randn((m * cin + 1,), generator=g,
                      device=cuda).to(torch.bfloat16)
    x = buf[1:].view(m, cin)
    dy = torch.randn((m, cout), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((cin, cout), generator=g, device=cuda)
         * 0.05).to(torch.bfloat16)
    assert conv1x1_route(m, cin, cout, torch.bfloat16, aligned=False) == "fma"
    dx, dw = conv1x1_bwd(x, dy, w)
    rdx, rdw = conv1x1_bwd_ref(x, dy, w)
    for got, ref in ((dx, rdx), (dw, rdw)):
        torch.testing.assert_close(
            got.float(), ref.float(), rtol=0,
            atol=2.0 ** -7 * max(1.0, float(ref.float().abs().max())))


def test_conv1x1_route_launches_k16_on_the_card(cuda, monkeypatch):
    """The autograd route on the card: a 1x1 conv with the switch on
    launches K16 once a backward, and its gradients equal the plain
    version's on the same tensors."""
    from apex_tpu_torch.amp import ops as amp_ops
    from apex_tpu_torch.ops.cuda import conv1x1_bwd, conv1x1_bwd_ref
    monkeypatch.setenv("APEX_TPU_FUSED_CONV1X1", "1")
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4, 14, 14, 96), generator=g,
                    device=cuda).requires_grad_(True)
    w = torch.randn((1, 1, 96, 160), generator=g,
                    device=cuda).requires_grad_(True)
    dy = torch.randn((4, 14, 14, 160), generator=g, device=cuda)
    before = conv1x1_bwd.launches
    y = amp_ops.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y.backward(dy)
    torch.cuda.synchronize()
    assert conv1x1_bwd.launches == before + 1
    m = 4 * 14 * 14
    rdx, rdw = conv1x1_bwd_ref(x.detach().reshape(m, 96), dy.reshape(m, 160),
                               w.detach().reshape(96, 160))
    torch.testing.assert_close(x.grad.reshape(m, 96), rdx, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(w.grad.reshape(96, 160), rdw, rtol=1e-5,
                               atol=1e-5 * float(rdw.abs().max()))


# -- K15, the packed non-finite flag ----------------------------------------

@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("val", [float("inf"), float("nan")])
def test_packed_nonfinite_matches_plain_on_every_placement(cuda, where, val):
    """K15 over mixed fp32 / bf16 / fp16 leaves (ragged sizes, one of
    several chunks, integer leaves skipped by ``all_finite_packed``):
    the flag equals the plain version's bit for bit, for one inf or nan
    at the first, a middle or the last element of the ragged leaf, and
    it repeats; one launch a call."""
    from apex_tpu_torch.ops.cuda import (all_finite_packed,
                                         packed_nonfinite,
                                         packed_nonfinite_ref)
    from apex_tpu_torch.ops.multi_tensor import table_for
    rng = np.random.RandomState(11)
    sizes = [(37,), (70001,), (4099,), (3, 5), (131072,)]
    dts = [torch.float32, torch.bfloat16, torch.float16, torch.bfloat16,
           torch.float32]
    xs = [_randn(rng, s, d, cuda) for s, d in zip(sizes, dts)]
    table = table_for(xs)
    clean = packed_nonfinite(table, xs)
    assert torch.equal(clean, packed_nonfinite_ref(table, xs))
    assert int(clean) == 0
    for leaf in (1, 2):
        flat = xs[leaf].view(-1)
        at = {"first": 0, "middle": flat.numel() // 2, "last": -1}[where]
        keep = flat[at].clone()
        flat[at] = val
        before = packed_nonfinite.launches
        got = packed_nonfinite(table, xs)
        again = packed_nonfinite(table, xs)
        torch.cuda.synchronize()
        assert packed_nonfinite.launches == before + 2
        assert torch.equal(got, packed_nonfinite_ref(table, xs))
        assert torch.equal(got, again) and int(got) == 1
        assert not bool(all_finite_packed(xs + [torch.arange(3,
                                                             device=cuda)]))
        flat[at] = keep


def test_amp_accumulation_checks_once_with_k15(cuda):
    """The accumulation path's finite check is one K15 launch: the
    scaler's ``all_finite`` on the card."""
    from apex_tpu_torch.amp.scaler import all_finite
    from apex_tpu_torch.ops.cuda import packed_nonfinite
    xs = [torch.ones(1000, device=cuda), torch.ones(3, 3, device=cuda)]
    before = packed_nonfinite.launches
    assert bool(all_finite(xs))
    xs[1][2, 2] = float("-inf")
    assert not bool(all_finite(xs))
    assert packed_nonfinite.launches == before + 2


# -- K17 / K18, the multi-head flash forward and fused backward ----------

MH_CASES = [(2, 256, 4, 64), (1, 200, 3, 64), (2, 130, 2, 128),
            (1, 96, 5, 40), (2, 64, 9, 8), (1, 77, 3, 24), (1, 128, 2, 112)]


def _mh_inputs(shape, cuda, masked, seed):
    bsz, l, h, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (_randn(rng, shape, torch.bfloat16, cuda)
                   for _ in range(4))
    dlse = _randn(rng, (bsz, l, h), torch.float32, cuda)
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[:, 0] = True
    return q, k, v, do, dlse, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", MH_CASES)
def test_flash_mh_kernels_match_plain(cuda, shape, causal, masked,
                                      monkeypatch):
    """K17 and K18 in bf16 at head widths 8 to 128 (40, 24, 112: the
    zero-padded ones), ragged L, a key mask: o within the forward's
    2e-2 and lse within 1e-3 of the plain version on the same inputs;
    dq, dk, dv (with a cotangent on the lse) within 2 bf16 ulps of the
    largest gradient and by ``_assert_rows_close``; one launch each a
    call, equal bits on a second run."""
    from apex_tpu_torch.ops.cuda import (flash_mh_bwd, flash_mh_bwd_ref,
                                         flash_mh_fwd, flash_mh_fwd_ref)
    monkeypatch.delenv(ENV_BUDGET, raising=False)
    q, k, v, do, dlse, mask = _mh_inputs(shape, cuda, masked, sum(shape))
    kw = dict(causal=causal, kv_mask=mask)
    before = (flash_mh_fwd.launches, flash_mh_bwd.launches)
    o, lse = flash_mh_fwd(q, k, v, **kw)
    o2, lse2 = flash_mh_fwd(q, k, v, **kw)
    ro, rlse = flash_mh_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    grads = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
    again = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
    torch.cuda.synchronize()
    assert (flash_mh_fwd.launches, flash_mh_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    ref = flash_mh_bwd_ref(q, k, v, o, lse, do, dlse=dlse, **kw)
    for a, b, r in zip(grads, again, ref):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r),
                                   rtol=0)
        _assert_rows_close(a, r)


def test_flash_mh_two_pass_route_and_its_limits(cuda, monkeypatch):
    """Above the budget the backward is K13 + K14 on the pre-scaled q (no
    prologue launch: no rope, scale 1), within 2 bf16 ulps of K18's; at a
    head width of 40 (padded by TMA) too, within 2 bf16 ulps of the plain
    version; fp32 takes the generic kernel, within 2e-5 of the plain
    version."""
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd_dkv,
                                         flash_attn_bwd_dq,
                                         flash_bwd_prologue, flash_mh_bwd,
                                         flash_mh_bwd_ref, flash_mh_fwd,
                                         flash_mh_fwd_ref)
    q, k, v, do, dlse, _ = _mh_inputs((2, 256, 4, 64), cuda, False, 3)
    o, lse = flash_mh_fwd(q, k, v, causal=True)
    monkeypatch.delenv(ENV_BUDGET, raising=False)
    fused = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, causal=True)
    monkeypatch.setenv(ENV_BUDGET, "0")
    before = (flash_mh_bwd.launches, flash_attn_bwd_dq.launches,
              flash_attn_bwd_dkv.launches, flash_bwd_prologue.launches)
    two = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, causal=True)
    assert (flash_mh_bwd.launches, flash_attn_bwd_dq.launches,
            flash_attn_bwd_dkv.launches,
            flash_bwd_prologue.launches) == (before[0], before[1] + 1,
                                             before[2] + 1, before[3])
    for a, b in zip(two, fused):
        torch.testing.assert_close(a.float(), b.float(), atol=_bf16_tol(b),
                                   rtol=0)
    q40 = _randn(np.random.RandomState(1), (1, 64, 2, 40), torch.bfloat16,
                 cuda)
    o40, lse40 = flash_mh_fwd(q40, q40, q40)
    before = flash_attn_bwd_dq.launches
    got = flash_mh_bwd(q40, q40, q40, o40, lse40, q40)
    assert flash_attn_bwd_dq.launches == before + 1
    for a, r in zip(got, flash_mh_bwd_ref(q40, q40, q40, o40, lse40, q40)):
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r),
                                   rtol=0)
    before = flash_fwd_simt.launches
    o32, lse32 = flash_mh_fwd(q.float(), k.float(), v.float())
    assert flash_fwd_simt.launches == before + 1
    ro, rlse = flash_mh_fwd_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(o32, ro, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse32, rlse, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_mh_above_the_budget_at_head_width_40(
        cuda, monkeypatch, causal):
    """``flash_attention_mh`` with autograd above the budget at D 40 (the
    two-pass route, K13 + K14, TMA padding the head width to 64): the
    gradients within 2 bf16 ulps of the plain version's and by
    ``_assert_rows_close``."""
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd_dkv,
                                         flash_attn_bwd_dq, flash_mh_bwd,
                                         flash_mh_bwd_ref)
    from apex_tpu_torch.ops.experimental import flash_attention_mh
    monkeypatch.setenv(ENV_BUDGET, "0")
    q, k, v, do, dlse, mask = _mh_inputs((2, 150, 3, 40), cuda, True, 40)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_mh_bwd.launches, flash_attn_bwd_dq.launches,
              flash_attn_bwd_dkv.launches)
    o, lse = flash_attention_mh(*leaves, causal=causal, kv_mask=mask,
                                return_lse=True)
    torch.autograd.backward((o, lse), (do, dlse))
    assert (flash_mh_bwd.launches, flash_attn_bwd_dq.launches,
            flash_attn_bwd_dkv.launches) == (before[0], before[1] + 1,
                                             before[2] + 1)
    ref = flash_mh_bwd_ref(q, k, v, o.detach(), lse.detach(), do, dlse=dlse,
                           causal=causal, kv_mask=mask)
    for t, r in zip(leaves, ref):
        torch.testing.assert_close(t.grad.float(), r.float(),
                                   atol=_bf16_tol(r), rtol=0)
        _assert_rows_close(t.grad, r)


def test_flash_attention_mh_entry_point_on_the_card(cuda):
    """``flash_attention_mh`` through autograd on the card: one K17 and
    one K18 launch, gradients equal to the wrappers' called directly."""
    from apex_tpu_torch.ops.cuda import flash_mh_bwd, flash_mh_fwd
    from apex_tpu_torch.ops.experimental import flash_attention_mh
    q, k, v, do, dlse, mask = _mh_inputs((2, 128, 4, 64), cuda, True, 9)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_mh_fwd.launches, flash_mh_bwd.launches)
    o, lse = flash_attention_mh(*leaves, kv_mask=mask, return_lse=True)
    torch.autograd.backward((o, lse), (do, dlse))
    assert (flash_mh_fwd.launches, flash_mh_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_mh_bwd(q, k, v, o.detach(), lse.detach(), do, dlse=dlse,
                        kv_mask=mask)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_o1_train_step_on_the_card_matches_the_cpu(cuda):
    """A 2-layer GPT at O1 (fp32 parameters, bf16 products): the card's
    losses within 2e-2 of the CPU's, the layer norms on K1 / K3 in fp32,
    the unscale one K6 launch a step in fp32, one K11, no copies."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    state = _small_gpt("cpu")[1].state_dict()
    ids = torch.as_tensor((np.arange(64)[None] + np.arange(4)[:, None] * 7)
                          % 512)
    losses = {}
    for dev in ("cpu", "cuda"):
        _, model = _small_gpt(dev, state)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev), device=dev)
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
        reset_launch_counts()
        losses[dev] = [float(step(ids.to(dev))["loss"]) for _ in range(3)]
        counts = launch_counts()
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert counts["layer_norm_fwd"] == 3 * 5
    assert counts["layer_norm_bwd"] == 3 * 10
    assert counts["flash_attn_fwd"] == 3 * 2
    assert counts["packed_scale"] == 3
    assert counts["packed_adam_tree"] == 3
    assert all(np.isfinite(losses["cuda"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=2e-2,
                               rtol=0)


# -- the Hopper forward (K2 / K17) and the repaired routes -----------------

#: fp32 scores one plain-version call may hold at once (the long shapes
#: run their plain version over slices of heads, every head compared)
PLAIN_SCORES = 1 << 28


def _by_heads(fn, args, kw):
    b, l, h = args[0].shape[:3]
    step = max(1, min(h, PLAIN_SCORES // (b * l * l)))
    parts = [fn(*(t[:, :, h0:h0 + step] for t in args), **kw)
             for h0 in range(0, h, step)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=2) for p in zip(*parts))
    return torch.cat(parts, dim=2)


def _check_forward(cuda, shape, dtype, causal, rope, masked, seed,
                   mh=False):
    """One forward kernel call (K2, or K17 with ``mh``) against its plain
    version on the same inputs: o within 2e-2 and by
    ``_assert_rows_close``, lse within 2e-2 (1e-3 for K17, no rope),
    equal bits on a second run, one launch (and one k^ prologue launch
    with rope)."""
    from apex_tpu_torch.ops.cuda import (flash_fwd_prologue, flash_mh_fwd,
                                         flash_mh_fwd_ref)
    bsz, l, h, d = shape
    rng = np.random.RandomState(seed)
    q, k, v = (_randn(rng, shape, dtype, cuda) for _ in range(3))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[:, 0] = True
        mask[0, :] = False            # batch 0: every row sees no key
    kw = dict(causal=causal, kv_mask=mask)
    if mh:
        fn, ref_fn, counter = flash_mh_fwd, flash_mh_fwd_ref, flash_mh_fwd
    else:
        kw["rope"] = _tables(bsz, l, d, dtype, cuda) if rope else None
        fn = lambda *a, **k_: flash_attn_fwd(*a, return_lse=True, **k_)
        ref_fn, counter = flash_attn_fwd_ref, flash_attn_fwd
    before = (counter.launches, flash_fwd_prologue.launches)
    o, lse = fn(q, k, v, **kw)
    o2, lse2 = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (counter.launches, flash_fwd_prologue.launches) == (
        before[0] + 2, before[1] + 2 * bool(rope and not mh))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = _by_heads(ref_fn, (q, k, v), kw)
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3 if mh else 2e-2,
                               rtol=0)
    _assert_rows_close(o, ro)
    if masked:
        assert torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)


#: the forward's shapes in ``chip_smoke.py`` (GPT train with rope, long
#: context, BERT's masked non-causal, serving's prefill) and the cases of
#: the new design: a ragged L, a fully masked row, D 40 and 96, fp16
K2_CASES = {
    "gpt_train": ((8, 2048, 12, 64), torch.bfloat16, True, True, False),
    "long_16384": ((1, 16384, 12, 64), torch.bfloat16, True, True, False),
    "long_32768": ((1, 32768, 12, 64), torch.bfloat16, True, True, False),
    "bert_masked": ((32, 512, 16, 64), torch.bfloat16, False, False, True),
    "prefill": ((1, 512, 12, 64), torch.bfloat16, True, True, False),
    "prefill_ragged": ((2, 1000, 6, 128), torch.bfloat16, True, False,
                       False),
    "ragged_rope": ((2, 1000, 4, 64), torch.bfloat16, True, True, False),
    "ragged_masked": ((2, 1000, 4, 64), torch.bfloat16, False, False, True),
    "d40_rope": ((2, 300, 3, 40), torch.bfloat16, True, True, False),
    "d96_masked": ((2, 300, 3, 96), torch.bfloat16, True, False, True),
    "fp16_rope": ((2, 1000, 4, 64), torch.float16, True, True, False),
    "fp16_d40_masked": ((1, 257, 2, 40), torch.float16, False, False, True),
    "fp16_d96_rope": ((1, 333, 2, 96), torch.float16, True, True, False),
    "one_row": ((1, 1, 2, 64), torch.bfloat16, True, True, False),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_hopper_forward_matches_plain(cuda, case):
    shape, dtype, causal, rope, masked = K2_CASES[case]
    _check_forward(cuda, shape, dtype, causal, rope, masked, len(case))


K17_CASES = {
    "gpt": ((8, 2048, 12, 64), torch.bfloat16, True, False),
    "bert_masked": ((32, 512, 16, 64), torch.bfloat16, False, True),
    "d128": ((1, 4096, 6, 128), torch.bfloat16, True, False),
    "ragged": ((2, 1000, 4, 64), torch.bfloat16, False, False),
    "d40_masked": ((2, 300, 3, 40), torch.float16, False, True),
    "d96": ((1, 333, 2, 96), torch.float16, True, False),
    "d8": ((2, 64, 9, 8), torch.bfloat16, True, True),
}


@pytest.mark.parametrize("case", sorted(K17_CASES))
def test_hopper_multi_head_forward_matches_plain(cuda, case):
    shape, dtype, causal, masked = K17_CASES[case]
    _check_forward(cuda, shape, dtype, causal, False, masked, len(case),
                   mh=True)


REPAIRED = {  # (shape, dtype, causal, masked): what the card refused before
    "fp16_d64": ((2, 200, 3, 64), torch.float16, True, False),
    "fp16_d40": ((1, 150, 2, 40), torch.float16, False, True),
    "fp16_d96": ((1, 150, 2, 96), torch.float16, True, False),
    "bf16_d40": ((2, 200, 3, 40), torch.bfloat16, True, True),
    "bf16_d96": ((1, 150, 2, 96), torch.bfloat16, False, False),
    "fp32_d64": ((2, 100, 3, 64), torch.float32, True, True),
    "fp32_d40": ((1, 100, 2, 40), torch.float32, False, False),
    "fp32_d96": ((1, 100, 2, 96), torch.float32, True, False),
    "bf16_d192": ((1, 100, 2, 192), torch.bfloat16, True, True),
    "fp16_d256": ((1, 100, 2, 256), torch.float16, False, False),
    "fp32_d256": ((1, 64, 2, 256), torch.float32, True, False),
}


def _close(got, ref, dtype):
    tol = 1e-5 if dtype == torch.float32 else _bf16_tol(ref)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("case", sorted(REPAIRED))
def test_repaired_entry_points_match_plain(cuda, case, route, monkeypatch):
    """``flash_attention_mh`` and ``attention`` on the card in fp16 and
    fp32 and at D 40, 96, 192 and 256, forward and gradients (a cotangent
    on the lse for the multi-head one), against their plain versions on
    the same inputs: fp32 within 1e-5, half types within 2 ulps (bf16's)
    of the largest element; both sides of the partials budget."""
    from apex_tpu_torch.attention import attention
    from apex_tpu_torch.ops.cuda import flash_mh_bwd_ref, flash_mh_fwd_ref
    from apex_tpu_torch.ops.experimental import flash_attention_mh
    shape, dtype, causal, masked = REPAIRED[case]
    monkeypatch.setenv(ENV_BUDGET, str(1 << 40) if route == "fused" else "0")
    bsz, l, h, d = shape
    rng = np.random.RandomState(len(case))
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    dlse = _randn(rng, (bsz, l, h), torch.float32, cuda) * 0.1
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[:, 0] = True
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention_mh(*leaves, causal=causal, kv_mask=mask,
                                return_lse=True)
    torch.autograd.backward((o, lse), (do, dlse))
    ro, rlse = flash_mh_fwd_ref(q, k, v, causal=causal, kv_mask=mask)
    _close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, atol=2e-5 if dtype ==
                               torch.float32 else 1e-3, rtol=0)
    # the backward's reference from the kernel's own o and lse, as the
    # kernel's backward reads them
    ref = flash_mh_bwd_ref(q, k, v, o.detach(), lse.detach(), do, dlse=dlse,
                           causal=causal, kv_mask=mask)
    for t, r in zip(leaves, ref):
        assert t.grad.dtype == dtype
        _close(t.grad, r, dtype)
    tables = _tables(bsz, l, d, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = attention(*leaves, causal=causal, kv_mask=mask, rope=tables,
                       return_lse=True)
    o.backward(do)
    ro, rlse = flash_attn_fwd_ref(q, k, v, causal=causal, kv_mask=mask,
                                  rope=tables)
    _close(o, ro, dtype)
    ref = flash_attn_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                             causal=causal, kv_mask=mask, rope=tables)
    for t, r in zip(leaves, ref):
        _close(t.grad, r, dtype)


def test_fp16_kernels_match_plain(cuda):
    """The kernels an fp16 O2 step reaches, in fp16: the layer norms (fp16
    and fp32 weights) within 1 fp16 ulp-scale of the plain version, the
    unscale and both Adam kernels (fp16 half copies) bit for bit."""
    rng = np.random.RandomState(16)
    x = _randn(rng, (64, 768), torch.float16, cuda) * 3 + 1
    dy = _randn(rng, (64, 768), torch.float16, cuda)
    for wdt in (torch.float16, torch.float32):
        w, b = (_randn(rng, (768,), wdt, cuda) for _ in range(2))
        y, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
        yr, mr, ir = layer_norm_fwd_ref(x, w, b, 1e-5)
        torch.testing.assert_close(y.float(), yr.float(), atol=2e-3,
                                   rtol=2e-3)
        got = layer_norm_bwd(dy, x, w, mean, inv)
        want = layer_norm_bwd_ref(dy, x, w, mean, inv)
        for a, r in zip(got, want):
            assert a.dtype == r.dtype
            torch.testing.assert_close(a.float(), r.float(), atol=2e-3,
                                       rtol=2e-3)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    scale = torch.full((1,), 2.0 ** -16, device=cuda)
    g = _randn(rng, (1000,), torch.float16, cuda) * 1000
    g[7] = float("inf")
    flag_ref = flag.clone()
    table = ChunkTable.of([g])
    got, want = (torch.empty(g.shape, device=cuda) for _ in range(2))
    packed_scale(table, [g], scale, flag, [got])
    packed_scale_ref(table, [g], scale, flag_ref, [want])
    assert torch.equal(got, want)
    assert int(flag) == int(flag_ref) == 1
    n = 1001
    p = _randn(rng, (n,), torch.float32, cuda)
    m = torch.zeros(n, device=cuda)
    v2 = torch.zeros(n, device=cuda)
    gr = _randn(rng, (n,), torch.float32, cuda)
    pc = torch.zeros(n, dtype=torch.float16, device=cuda)
    ss = torch.full((1,), 1e-3, device=cuda)
    one = torch.ones(1, device=cuda)
    refs = [t.clone() for t in (p, m, v2, pc)]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    packed_adam(p, m, v2, gr, ss, one, None, p_copy=pc, **kw)
    packed_adam_ref(*refs[:3], gr, ss, one, None, p_copy=refs[3], **kw)
    assert all(torch.equal(a, r) for a, r in zip((p, m, v2, pc), refs))
    leaves = [_randn(rng, (s,), torch.float32, cuda) for s in (1000, 7, 4096)]
    table = ChunkTable.of(leaves)
    grads = [torch.randn_like(t) for t in leaves]
    copies = [torch.zeros(t.shape, dtype=torch.float16, device=cuda)
              for t in leaves]
    state = [[torch.zeros_like(t) for t in leaves] for _ in range(2)]
    ref_state = [[t.clone() for t in ls] for ls in
                 (leaves, *state, copies)]
    steps = torch.full((3,), 1e-3, device=cuda)
    packed_adam_tree(table, leaves, *state, grads, steps, one, None,
                     p_copy=copies, **kw)
    packed_adam_tree_ref(table, ref_state[0], ref_state[1], ref_state[2],
                         grads, steps, one, None, p_copy=ref_state[3], **kw)
    for got, want in zip((leaves, *state, copies), ref_state):
        assert all(torch.equal(a, r) for a, r in zip(got, want))


def test_fp16_o2_train_step_on_the_card_matches_the_cpu(cuda):
    """A 2-layer GPT at O2 with ``half_dtype=torch.float16`` (NVIDIA
    Apex's classic O2): fp16 parameters, the layer norms, K2 (after its
    k^ prologue) and K4 (after its q^ / k^ prologue, then the finish
    pass) in fp16, the unscale one K6 launch a step fp16 to fp32, one
    K11 writing the fp16 copies; the card's losses within 2e-2 of the
    CPU's, loss scale and overflow equal."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    state = _small_gpt("cpu")[1].state_dict()
    ids = torch.as_tensor((np.arange(64)[None] + np.arange(4)[:, None] * 7)
                          % 512)
    runs = {}
    for dev in ("cpu", "cuda"):
        _, model = _small_gpt(dev, state)
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device=dev),
                           opt_level="O2", half_dtype=torch.float16,
                           device=dev)
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
        reset_launch_counts()
        runs[dev] = [{k: float(v) for k, v in step(ids.to(dev)).items()
                      if k in ("loss", "loss_scale", "overflow")}
                     for _ in range(3)]
        counts = launch_counts()
        assert all(p.dtype == torch.float16 for p in model.parameters())
    assert {k: c for k, c in counts.items() if c} == {
        "layer_norm_fwd": 3 * 5, "layer_norm_bwd": 3 * 10,
        "flash_attn_fwd": 3 * 2, "flash_fwd_prologue": 3 * 2,
        "flash_attn_bwd": 3 * 2, "flash_bwd_prologue": 3 * 2,
        "flash_bwd_finish": 3 * 2, "packed_scale": 3,
        "packed_adam_tree": 3}
    for c, g in zip(runs["cuda"], runs["cpu"]):
        assert abs(c["loss"] - g["loss"]) <= 2e-2, runs
        assert c["loss_scale"] == g["loss_scale"]
        assert c["overflow"] == g["overflow"]


# -- the Hopper fused backward (K4 / K18) and the wide heads ----------------

#: (shape, dtype, causal, masked, rope): BERT's masked shape with a batch
#: row of empty rows, the GPT train shape, the head widths 40 / 96 / 128,
#: fp16, a ragged L
FUSED = {
    "bert_masked": ((32, 512, 16, 64), torch.bfloat16, False, True, False),
    "gpt_train": ((8, 2048, 12, 64), torch.bfloat16, True, False, True),
    "d40": ((2, 300, 3, 40), torch.bfloat16, True, False, True),
    "d96": ((2, 300, 3, 96), torch.bfloat16, False, True, True),
    "d128": ((1, 1000, 4, 128), torch.bfloat16, True, False, True),
    "fp16": ((2, 256, 4, 64), torch.float16, True, False, True),
    "fp16_d96_masked": ((2, 333, 2, 96), torch.float16, False, True, False),
    "ragged": ((1, 1000, 4, 64), torch.bfloat16, True, True, True),
}


def _fused_inputs(case, cuda):
    shape, dtype, causal, masked, rope = FUSED[case]
    bsz, l, h, d = shape
    rng = np.random.RandomState(len(case) + l)
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    dlse = _randn(rng, (bsz, l, h), torch.float32, cuda) * 0.1
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=cuda)
        mask[:, 0] = True
        mask[0] = False                        # a batch row of empty rows
    tables = _tables(bsz, l, d, dtype, cuda) if rope else None
    return q, k, v, do, dlse, mask, tables, causal


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_backward_matches_plain(cuda, case, monkeypatch):
    """K4 (through :func:`flash_attn_bwd`, the budget raised) against its
    plain version: dq, dk, dv within 2 ulps (bf16's) of the largest
    element and by ``_assert_rows_close``; the q^ / k^ prologue, one K4
    and one finish-pass launch a call; equal bits on a second run; empty
    rows give zero gradients."""
    from apex_tpu_torch.ops.cuda import launch_counts
    q, k, v, do, _, mask, tables, causal = _fused_inputs(case, cuda)
    monkeypatch.setenv(ENV_BUDGET, str(1 << 40))
    kw = dict(causal=causal, kv_mask=mask, rope=tables)
    o, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    before = launch_counts()
    got = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    after = launch_counts()
    again = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"flash_attn_bwd": 1,
                                          "flash_bwd_finish": 1,
                                          "flash_bwd_prologue": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = _by_heads(flash_attn_bwd_ref, (q, k, v, o, lse, do), kw)
    for a, r in zip(got, ref):
        assert a.dtype == q.dtype
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r),
                                   rtol=0)
        _assert_rows_close(a, r)
    if mask is not None:
        assert all(torch.all(a[0] == 0) for a in got)


@pytest.mark.parametrize("case", ["bert_masked", "gpt_train", "d40",
                                  "fp16", "ragged"])
def test_fused_multi_head_backward_matches_plain(cuda, case, monkeypatch):
    """K18 (through :func:`flash_mh_bwd`, with a cotangent on the lse, the
    budget raised) against its plain version by the same limits; one
    K18 and one finish-pass launch a call; equal bits on a second run."""
    from apex_tpu_torch.ops.cuda import (flash_mh_bwd, flash_mh_bwd_ref,
                                         flash_mh_fwd, launch_counts)
    q, k, v, do, dlse, mask, _, causal = _fused_inputs(case, cuda)
    monkeypatch.setenv(ENV_BUDGET, str(1 << 40))
    kw = dict(causal=causal, kv_mask=mask)
    o, lse = flash_mh_fwd(q, k, v, **kw)
    before = launch_counts()
    got = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
    after = launch_counts()
    again = flash_mh_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
    torch.cuda.synchronize()
    assert (after["flash_mh_bwd"] - before["flash_mh_bwd"],
            after["flash_bwd_finish"] - before["flash_bwd_finish"]) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = _by_heads(lambda *a: flash_mh_bwd_ref(*a[:6], dlse=a[6], **kw),
                    (q, k, v, o, lse, do, dlse), {})
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), atol=_bf16_tol(r),
                                   rtol=0)
        _assert_rows_close(a, r)


@pytest.mark.parametrize("causal,rope,dtype", [
    (True, True, torch.bfloat16), (False, False, torch.float16),
    (True, False, torch.float16), (False, True, torch.bfloat16)])
def test_finish_pass_equals_plain_bitwise(cuda, causal, rope, dtype):
    """The finish pass against its plain version bit for bit: the planes
    added in ascending order (under causality only those that reach a
    row: the others hold NaN here and are never read), the inverse
    rotation, the rounding and the scale in the storage type."""
    from apex_tpu_torch.ops.cuda import flash_bwd_finish, flash_bwd_finish_ref
    from apex_tpu_torch.ops.cuda.flash_attention import BWD_KEY_TILE
    n, b, l, h, d = 5, 2, 300, 3, 72
    gen = torch.Generator(device=cuda).manual_seed(5)
    planes = torch.randn((n, b, l, h, d), generator=gen, device=cuda)
    if causal:
        for j in range(n):
            planes[j, :, :BWD_KEY_TILE * j] = float("nan")
    tables = _tables(b, l, d, dtype, cuda) if rope else None
    got = flash_bwd_finish(planes, causal=causal, rope=tables, scale=0.125,
                           dtype=dtype)
    ref = flash_bwd_finish_ref(planes, causal=causal, rope=tables,
                               scale=0.125, dtype=dtype)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("d,dtype", [(520, torch.float32),
                                     (520, torch.bfloat16),
                                     (1024, torch.float16),
                                     (1024, torch.float32)])
def test_entry_points_at_heads_above_512(cuda, d, dtype):
    """``attention`` (with rope) and ``flash_attention_mh`` at D 520 and
    1024, which raised before: the generic kernels hold each row in
    shared memory there; forward and gradients against the plain
    versions (fp32 within 1e-5, half types within 2 ulps of the largest
    element)."""
    from apex_tpu_torch.attention import attention
    from apex_tpu_torch.ops.cuda import flash_mh_bwd_ref, flash_mh_fwd_ref
    from apex_tpu_torch.ops.experimental import flash_attention_mh
    shape = (1, 130, 2, d)
    rng = np.random.RandomState(d)
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    mask = torch.as_tensor(rng.rand(1, 130) > 0.3, device=cuda)
    mask[:, 0] = True
    tables = _tables(1, 130, d, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = attention(*leaves, causal=True, rope=tables, return_lse=True)
    o.backward(do)
    ro, _ = flash_attn_fwd_ref(q, k, v, causal=True, rope=tables)
    _close(o, ro, dtype)
    ref = flash_attn_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                             causal=True, rope=tables)
    for t, r in zip(leaves, ref):
        _close(t.grad, r, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention_mh(*leaves, kv_mask=mask, return_lse=True)
    o.backward(do)
    ro, _ = flash_mh_fwd_ref(q, k, v, kv_mask=mask)
    _close(o, ro, dtype)
    ref = flash_mh_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                           kv_mask=mask)
    for t, r in zip(leaves, ref):
        _close(t.grad, r, dtype)


#: the tiled generic kernels' widths: fp32 at every tile configuration
#: (D 8 .. 256), bf16 / fp16 above the tensor-core kernels' 128
SIMT_TILED = ([(torch.float32, d) for d in (8, 40, 64, 128, 192, 256)]
              + [(dt, d) for dt in (torch.bfloat16, torch.float16)
                 for d in (136, 192, 256)])


def _simt_mask(bsz, l, rng, dev):
    """Batch 0 masks every key (its rows see none); batch 1 keeps key 0."""
    mask = torch.as_tensor(rng.rand(bsz, l) > 0.3, device=dev)
    mask[0] = False
    mask[1:, 0] = True
    return mask


def _simt_check(q, k, v, do, kw, dtype):
    """The generic kernels on (q, k, v, do): one forward and two backward
    launches a call, two calls equal bit for bit, and the results against
    the plain versions (o and lse within 2e-5 in fp32, the gradients
    within 1e-5; half types within 2 bf16 ulps of the largest element,
    for lse of the largest live row's: without rope the kernels pre-scale
    q in the half type, where the plain forward scales the fp32 scores;
    a row that sees no key has lse NEG_INF exactly); returns (o, lse, dq,
    dk, dv)."""
    before = (flash_fwd_simt.launches, flash_bwd_simt.launches)
    o, lse = flash_fwd_simt(q, k, v, return_lse=True, **kw)
    o2, lse2 = flash_fwd_simt(q, k, v, return_lse=True, **kw)
    got = flash_bwd_simt(q, k, v, o, lse, do, **kw)
    got2 = flash_bwd_simt(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd_simt.launches, flash_bwd_simt.launches) == (
        before[0] + 2, before[1] + 4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    ro, rlse = flash_attn_fwd_ref(q, k, v, **kw)
    fp32 = dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(),
                               atol=2e-5 if fp32 else _bf16_tol(ro), rtol=0)
    blank = rlse <= -1e30 / 2
    assert torch.all(lse[blank] == -1e30)
    live = rlse[~blank]
    torch.testing.assert_close(lse[~blank], live, atol=2e-5 if fp32
                               else _bf16_tol(live), rtol=1e-5 if fp32 else 0)
    for a, r in zip(got, flash_attn_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert a.dtype == dtype and a.shape == q.shape
        _close(a, r, dtype)
    return (o, lse, *got)


@pytest.mark.parametrize("causal,masked,rope", [(True, True, True),
                                                (False, True, False),
                                                (True, False, False),
                                                (False, False, True)])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("dtype,d", SIMT_TILED)
def test_tiled_generic_kernels_match_plain(cuda, dtype, d, l, causal,
                                           masked, rope):
    """The tiled layout (``simt_layout``: every D up to 256) at the tiles'
    edges (L 1, 63, 64, 65 around the 64- and 32-row tiles, and 1000),
    causal or not, with a key mask whose batch 0 sees no key (zeros, lse
    NEG_INF, zero gradients), with rope."""
    from apex_tpu_torch.ops.cuda import simt_layout
    assert simt_layout(dtype, d) == "tiled"
    shape = (2, l, 2, d)
    rng = np.random.RandomState(l + d)
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    kw = dict(causal=causal,
              kv_mask=_simt_mask(2, l, rng, cuda) if masked else None,
              rope=_tables(2, l, d, dtype, cuda) if rope else None)
    o, lse, *grads = _simt_check(q, k, v, do, kw, dtype)
    if masked:
        assert torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)
        assert all(torch.all(g[0] == 0) for g in grads)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tiled_generic_kernels_read_views(cuda, d, rope):
    """Non-contiguous fp32 views (q, k, v split out of one fused
    projection; a head-major layout transposed) take the 4-element vector
    loads, a view one element off a 16-byte boundary the element loads:
    each against the plain version, and every result equal bit for bit
    to the same call on contiguous copies (both loads widen the same
    values)."""
    bsz, l, h = 2, 97, 3
    rng = np.random.RandomState(d)
    qkv = _randn(rng, (bsz, l, 3, h, d), torch.float32, cuda)
    q, k = qkv[:, :, 0], qkv[:, :, 1]
    v = _randn(rng, (bsz, h, l, d), torch.float32, cuda).transpose(1, 2)
    flat = _randn(rng, (bsz * l * h * d + 1,), torch.float32, cuda)
    do = flat[1:].view(bsz, l, h, d)          # 4 bytes off 16
    assert not (q.is_contiguous() or v.is_contiguous())
    assert do.data_ptr() % 16 == 4
    kw = dict(causal=True, kv_mask=_simt_mask(bsz, l, rng, cuda),
              rope=_tables(bsz, l, d, torch.float32, cuda) if rope else None)
    got = _simt_check(q, k, v, do, kw, torch.float32)
    want = _simt_check(*(t.contiguous() for t in (q, k, v, do)), kw,
                       torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    odd = flat[1:].view(bsz, l, h, d)
    o_odd = flash_fwd_simt(odd, k, v, **kw)
    assert torch.equal(o_odd, flash_fwd_simt(odd.contiguous(), k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_heads_keep_the_rows_kernels(cuda, dtype):
    """Above D 256 the generic kernels keep a warp a row (``simt_layout``
    "rows"): D 520 against the plain versions, with the same launches."""
    from apex_tpu_torch.ops.cuda import simt_layout
    assert simt_layout(dtype, 520) == "rows"
    shape = (1, 130, 2, 520)
    rng = np.random.RandomState(520)
    q, k, v, do = (_randn(rng, shape, dtype, cuda) for _ in range(4))
    kw = dict(causal=True, rope=_tables(1, 130, 520, dtype, cuda))
    _simt_check(q, k, v, do, kw, dtype)


@pytest.fixture
def nccl_world_one(cuda):
    """A one-rank NCCL group on the card for the test, destroyed after."""
    import socket
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already formed")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("engine", ["ring", "ulysses"])
def test_sequence_parallel_engines_at_world_one_match_the_local_call(
        cuda, nccl_world_one, engine, causal, masked):
    """``ring_attention`` / ``ulysses_attention`` (the flash engine) over a
    one-rank NCCL group against the local kernel call on the same bf16
    inputs, forward and gradients, within the flash rows' bf16 tolerance;
    with a key mask whose batch 1 is all masked (a block with no visible
    key: zeros, no NaN from the merge).  K2 launches once a call, no hop
    or all-to-all is sent."""
    from apex_tpu_torch.attention import (local_attention, ring_attention,
                                          ulysses_attention)
    from apex_tpu_torch.parallel import (collective_counts,
                                         reset_collective_counts)
    fn = ring_attention if engine == "ring" else ulysses_attention
    shape = (2, 1024, 4, 64)
    rng = np.random.RandomState(3)
    q, k, v, do = (_randn(rng, shape, torch.bfloat16, cuda)
                   for _ in range(4))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.rand(2, 1024) > 0.3, device=cuda)
        mask[1] = False
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_collective_counts()
    before = flash_attn_fwd.launches
    o = fn(*leaves, "data", causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_attn_fwd.launches == before + 1
    o.backward(do)
    assert collective_counts() == {}
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ro = local_attention(*ref, causal=causal, kv_mask=mask)
    ro.backward(do)
    _close(o.detach(), ro.detach(), torch.bfloat16)
    for t, r in zip(leaves, ref):
        assert torch.isfinite(t.grad.float()).all()
        _close(t.grad, r.grad, torch.bfloat16)
    if masked:
        assert not o[1].float().abs().max()


def test_data_prefetcher_runs_on_a_side_stream(cuda):
    """``DataPrefetcher`` on the card (its default): uint8 batches copied
    from pinned memory on a side stream and normalized there, each equal
    bit for bit to ``normalize_uint8`` on the CPU; the consumer's stream
    stays the default one."""
    from apex_tpu_torch.data import (DataPrefetcher, host_synthetic_loader,
                                     normalize_uint8)
    main = torch.cuda.current_stream()
    pf = DataPrefetcher(host_synthetic_loader(6, 4, 32, seed=2),
                        transform=normalize_uint8)
    want = list(host_synthetic_loader(6, 4, 32, seed=2))
    got = []
    batch = pf.next()
    while batch is not None:
        assert torch.cuda.current_stream() == main
        x, y = batch
        assert x.is_cuda and x.dtype == torch.float32 and y.is_cuda
        got.append((x.cpu(), y.cpu()))
        batch = pf.next()
    assert len(got) == len(want) == 6
    for (x, y), (wx, wy) in zip(got, want):
        cx, cy = normalize_uint8((torch.from_numpy(wx), torch.from_numpy(wy)))
        assert torch.equal(x, cx) and torch.equal(y, cy)


def _tiny_o2(dev, seed=0):
    """gpt_tiny at amp O2 + FusedAdam on ``dev`` from seeded weights, its
    step, and a batch."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTModel, gpt_tiny, lm_loss
    from apex_tpu_torch.optimizers import FusedAdam
    torch.manual_seed(seed)
    model = GPTModel(gpt_tiny(), device="cpu").to(dev)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device=dev),
                       opt_level="O2", device=dev)
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    ids = (torch.arange(64).reshape(2, 32) * 7 % 512).to(dev)
    return a, step, ids


def _host_leaves(a):
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.resilience.durable import tree_leaves_with_path
    return dict(tree_leaves_with_path(checkpoint.state_dict(a)))


def _equal_states(got, want):
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_durable_round_trip_card_cpu_card_is_bitwise(cuda, tmp_path):
    """An amp O2 state saved on the card restores bit for bit into a CPU
    template, and the CPU's snapshot back into a fresh card state; the
    compute params follow the masters on both."""
    from apex_tpu_torch.resilience import DurableCheckpointManager
    a, step, ids = _tiny_o2(cuda)
    for _ in range(3):
        step(ids)
    want = _host_leaves(a)
    mgr = DurableCheckpointManager(str(tmp_path / "card"), fsync=False)
    mgr.save(2, a)
    mgr.close()
    cpu_a, _, _ = _tiny_o2("cpu", seed=1)
    DurableCheckpointManager(str(tmp_path / "card")).restore(cpu_a)
    _equal_states(_host_leaves(cpu_a), want)
    mgr = DurableCheckpointManager(str(tmp_path / "cpu"), fsync=False)
    mgr.save(2, cpu_a)
    mgr.close()
    back, _, _ = _tiny_o2(cuda, seed=2)
    DurableCheckpointManager(str(tmp_path / "cpu")).restore(back)
    _equal_states(_host_leaves(back), want)
    for b in (cpu_a, back):
        for p, m in zip(b.params, b.masters.values()):
            assert torch.equal(p, m.to(torch.bfloat16))


def test_first_step_after_a_restore_equals_the_uninterrupted_step(
        cuda, tmp_path):
    """A restore into the Amp that ran on copies into its own tensors:
    K11 reads the restored per-leaf counts and moments (no stale views or
    chunk-table rows), so the first step after the restore equals the
    uninterrupted step bit for bit, with one K6 and one K11 launch."""
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.resilience import DurableCheckpointManager
    a, step, ids = _tiny_o2(cuda)
    for _ in range(2):
        step(ids)
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False,
                                   async_save=False)
    mgr.save(1, a)
    want_loss = step(ids)["loss"].clone()
    want = _host_leaves(a)
    for _ in range(2):
        step(ids)
    mgr.restore(a)
    reset_launch_counts()
    loss = step(ids)["loss"]
    counts = launch_counts()
    assert counts["packed_scale"] == 1 and counts["packed_adam_tree"] == 1
    assert torch.equal(loss, want_loss)
    _equal_states(_host_leaves(a), want)


# -- fp8 / int8 (quant) on the card ----------------------------------------

def _quant_inputs(seed=0, n=1 << 16):
    """fp32 values over many magnitudes with the fp8 and int8 edges:
    zeros, the fp8 maxima and past them, halfway points, subnormals,
    infinities and a NaN."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * rng.choice(
        np.float32([1e-7, 1e-3, 1, 30, 500, 3e4, 1e5]), n)
    x[:16] = [0.0, -0.0, 448.0, -448.0, 464.0, 57344.0, -61440.0, 1.0625,
              1.1875, 2.0 ** -10, 1e-40, np.inf, -np.inf, np.nan, 3e38,
              0.5]
    return torch.from_numpy(x)


def _same_bits(got, want):
    """Bit for bit, NaN payloads aside."""
    g, w = got.cpu(), want.cpu()
    assert g.dtype == w.dtype and g.shape == w.shape
    gn, wn = torch.isnan(g.float()), torch.isnan(w.float())
    assert torch.equal(gn, wn)
    size = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[g.element_size()]
    assert torch.equal(g.contiguous().view(size)[~wn],
                       w.contiguous().view(size)[~wn])


@pytest.mark.parametrize("scale", [1.0, 0.37, 1536.0])
def test_quant_functions_on_the_card_equal_the_cpu_bitwise(cuda, scale):
    """``quantize``, ``dequantize``, ``qdq`` (e4m3 and e5m2, fp32 and bf16
    inputs), ``quantize_int8`` (per tensor and per channel),
    ``quantize_kv`` (a zero vector among the rows) and ``record_amax`` on
    the card equal the same calls on the CPU bit for bit: IEEE
    elementwise ops."""
    from apex_tpu_torch.quant import fp8, int8
    x = _quant_inputs()
    s = torch.tensor(scale, dtype=torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        for fmt in (fp8.FP8_E4M3, fp8.FP8_E5M2):
            q = fp8.quantize(xc, s, fmt)
            qd = fp8.quantize(xc.to(cuda), s.to(cuda), fmt)
            _same_bits(qd, q)
            _same_bits(fp8.dequantize(qd, s.to(cuda)), fp8.dequantize(q, s))
            _same_bits(fp8.qdq(xc.to(cuda), s.to(cuda), fmt),
                       fp8.qdq(xc, s, fmt))
    w = x[16:16 + 64 * 96].reshape(64, 96) * scale
    for axis in (None, 0, 1):
        q, sc = int8.quantize_int8(w, axis)
        qd, scd = int8.quantize_int8(w.to(cuda), axis)
        _same_bits(qd, q)
        _same_bits(scd, sc)
    kv = x[16:16 + 4 * 16 * 12 * 8].reshape(4, 16, 12, 8).bfloat16()
    kv[1, 3] = 0
    q, sc = int8.quantize_kv(kv)
    qd, scd = int8.quantize_kv(kv.to(cuda))
    _same_bits(qd, q)
    _same_bits(scd, sc)
    st = fp8.init_delayed_scaling(4, device="cpu")
    sd = fp8.init_delayed_scaling(4, device=cuda)
    for a in (2.0, float("inf"), 8.0 * scale, float("nan"), 1e-40):
        st = fp8.record_amax(st, torch.tensor(a), fp8.FP8_E4M3, 1)
        sd = fp8.record_amax(sd, torch.tensor(a, device=cuda),
                             fp8.FP8_E4M3, 1)
        _same_bits(sd.amax_history, st.amax_history)
        _same_bits(sd.scale, st.scale)


@pytest.mark.parametrize("m,k,n", [(4096, 768, 3072), (100, 72, 40),
                                   (1, 24, 8)])
def test_scaled_matmul_runs_scaled_mm_and_matches_plain(cuda, m, k, n):
    """``scaled_matmul`` on the card (``torch._scaled_mm`` on the fp8
    operands, padded to 16 where a dim is not a multiple of it) against
    its plain version (the fp32 product of the upcast operands): within
    ``2**-10`` of the largest output.  The fp8 tensor cores keep fewer
    bits than fp32 in their partial sums (measured 2.6e-4 of the largest
    output at K 768 on an NVIDIA H100 80GB HBM3 at 700.00 W), and the
    scales ride the epilogue as reciprocals."""
    from apex_tpu_torch.quant import fp8
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).bfloat16()
    w = torch.randn(k, n, generator=gen).bfloat16()
    sx, sw = torch.tensor(96.0), torch.tensor(160.0)
    want = fp8.scaled_matmul(x, w, sx, sw, out_dtype=torch.float32)
    got = fp8.scaled_matmul(x.to(cuda), w.to(cuda), sx.to(cuda),
                            sw.to(cuda), out_dtype=torch.float32)
    tol = 2.0 ** -10 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= tol
    out = fp8.scaled_matmul(x.to(cuda), w.to(cuda), sx.to(cuda),
                            sw.to(cuda))
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)


def test_tree_amax_propagates_nan_on_the_card(cuda):
    """The grad class's amax over a tree: the largest magnitude, NaN when
    a leaf holds one (which records as 0, as JAX's ``max`` gives)."""
    from apex_tpu_torch.quant import fp8
    leaves = [torch.randn(1000, device=cuda).bfloat16() for _ in range(3)]
    leaves.append(torch.randn(77, device=cuda))
    want = max(float(t.float().abs().max()) for t in leaves)
    assert float(fp8.tree_amax(leaves)) == want
    leaves[1][5] = float("nan")
    assert torch.isnan(fp8.tree_amax(leaves))
    leaves[1][5] = float("inf")
    assert float(fp8.tree_amax(leaves)) == float("inf")


def test_o4_step_on_the_card_quantizes_and_rolls_on_device(cuda):
    """A 2-layer GPT's O4 step on the card: the fp8 state lives on the
    card, the step launches the port's kernels (K1, K3, K2, the
    backward, K6, K11) and no state leaves the card; the scales move off
    1 after the first step."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTConfig, GPTModel, lm_loss
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    torch.manual_seed(0)
    model = GPTModel(cfg, device=cuda)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-3),
                       opt_level="O4")
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    ids = torch.arange(4 * 128, device=cuda).reshape(4, 128) % 512
    reset_launch_counts()
    out = step(ids)
    counts = launch_counts()
    for k in ("layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
              "packed_scale", "packed_adam_tree"):
        assert counts[k] > 0, k
    assert all(t.is_cuda for c in a.fp8_state for t in c)
    assert out["fp8_rescales"].is_cuda and out["fp8_amax_saturation"].is_cuda
    assert float(a.fp8_state.weight.scale) != 1.0


# -- the lagged metrics read (instrument_step, run_resilient) ---------------

#: host work a lag-test step does before it queues its device work
LAG_HOST_S = 0.020
#: the device work a lag-test step queues (a device-side sleep)
LAG_DEVICE_MS = 50.0


def _sleep_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that take ``ms`` on this card
    (measured by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return int(20_000_000 * ms / start.elapsed_time(end))


def _lag_step(cuda):
    """A step that spends ``LAG_HOST_S`` of host time, then queues
    ``LAG_DEVICE_MS`` of device time, and returns a loss made after it."""
    import time
    cycles = _sleep_cycles(LAG_DEVICE_MS)
    x = torch.zeros((), device=cuda)

    def step(*_):
        time.sleep(LAG_HOST_S)
        torch.cuda._sleep(cycles)
        return {"loss": x + 1.0, "overflow": torch.zeros((), dtype=torch.bool,
                                                         device=cuda)}
    return step


def _steady_ms(stamps):
    return float(np.median(np.diff(np.asarray(stamps)[2:]))) * 1e3


def test_instrument_step_overlaps_host_time_with_the_previous_step(cuda):
    """Each resolve waits only for the step before the one just queued,
    so a step's 20 ms of host time overlaps the previous step's 50 ms on
    the card: the steady step stays near 50 ms, not 70 (what a read
    queued behind the newer step, or a ``.cpu()`` at resolve time,
    gives)."""
    import time
    from apex_tpu_torch.obs.metrics import Registry, instrument_step
    reg = Registry(lag=1, resolve_every=1)
    step = _lag_step(cuda)
    wrapped = instrument_step(step, registry=reg)
    stamps = []
    torch.cuda.synchronize()
    for _ in range(10):
        stamps.append(time.perf_counter())
        wrapped()
    torch.cuda.synchronize()
    ms = _steady_ms(stamps)
    assert ms < LAG_DEVICE_MS + 8.0, ms
    assert reg.pending_groups == 1
    reg.flush()
    assert reg.gauge("train_loss").value == 1.0
    assert reg.counter("train_steps_total").value == 10.0


def test_run_resilient_overlaps_host_time_with_the_previous_step(cuda):
    import time
    from apex_tpu_torch.obs.metrics import Registry
    from apex_tpu_torch.resilience import ResilienceConfig, run_resilient
    step = _lag_step(cuda)
    stamps = []

    def timed(*batch):
        stamps.append(time.perf_counter())
        return step(*batch)

    torch.cuda.synchronize()
    result = run_resilient(timed, {"x": torch.zeros(1, device=cuda)},
                           lambda i: (), 10,
                           config=ResilienceConfig(checkpoint_every=0),
                           registry=Registry())
    torch.cuda.synchronize()
    ms = _steady_ms(stamps)
    assert ms < LAG_DEVICE_MS + 8.0, ms
    assert [v for _, v in result.losses] == [1.0] * 10


def test_native_host_runtime_builds_on_the_cards_host(cuda):
    """The native library builds on the card's machine (its host
    compiler) and equals its plain versions there."""
    from apex_tpu_torch import _native
    _native.library()
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in [(1024, 1024), (3, 5), (), (777,)]]
    flat = _native.flatten(arrays)
    np.testing.assert_array_equal(flat, _native.flatten_plain(arrays))
    for got, a in zip(_native.unflatten(flat, [a.shape for a in arrays]),
                      arrays):
        np.testing.assert_array_equal(got, a)
    numels = rng.integers(1, 5_000_000, size=161).tolist()
    np.testing.assert_array_equal(
        _native.plan_buckets(numels, 10_000_000),
        _native.plan_buckets_plain(numels, 10_000_000))
    assert _native.fingerprint64(arrays[1]) == \
        _native.fingerprint64_plain(arrays[1])
