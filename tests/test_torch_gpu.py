"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a card each test skips (decided in the
``cuda`` fixture, never at import).  Run on the card with
``python -m pytest -m gpu tests/test_torch_*.py``.

Tolerances: layer norm, fp32 ``atol = rtol = 1e-5`` and bf16 at most 1
ulp (the kernel sums in another order, then rounds the fp32 result) or
``2**-16`` absolute where the affine sum cancels toward zero;
flash attention, fp32 ``atol = 2e-5`` and bf16 ``atol = 2e-2`` against
the plain version run in fp32 on the same bf16 inputs (the kernel
rounds the pre-scaled q and the probabilities to bf16 for the tensor
cores, as the TPU kernel does).  The backward kernels: fp32 ``atol =
1e-5`` (dw, db: also ``rtol = 1e-5``, row sums), bf16 within 2 bf16 ulps
of the largest element against the plain version in bf16 (both compute
in fp32 and round at the same places, but sum in other orders); both run
twice for equal bits.  Adam and the unscale equal their plain versions
bit for bit (every product and sum rounded on its own).  LAMB: stage 1's
m, v and u equal the plain version's bit for bit, its norm partials and
the total sum of squares are within ``rtol = 1e-5`` (sums in another
order); stage 2's p within ``rtol = 1e-6, atol = 1e-7`` in fp32 and 1
bf16 ulp in bf16 (its per-leaf norm sums differ in order, so the trust
ratio may differ in its last bit); stages 1, 2 and the sum of squares
repeat bitwise.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops.cuda import (
    flash_attn_bwd,
    flash_attn_bwd_ref,
    flash_attn_fwd,
    flash_attn_fwd_ref,
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
    packed_scale,
    packed_scale_ref,
    packed_sumsq,
    packed_sumsq_ref,
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
    before = flash_attn_fwd.launches
    o, lse = flash_attn_fwd(q, k, v, causal=causal, kv_mask=mask,
                            return_lse=True)
    torch.cuda.synchronize()
    assert flash_attn_fwd.launches == before + 1
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
    q = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
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
    and solo generate() launches flash attention once per layer."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    # 2 layers, 2 heads of 64 (the kernel takes D in (64, 128))
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
        assert launch_counts()["flash_attn_fwd"] == cfg.num_layers
        assert out[f"r{i}"].shape == (6,)
        assert solo.shape == (1, len(p) + 6)


def _bf16_tol(ref):
    return 2 * 2.0 ** -8 * max(1.0, float(ref.float().abs().max()))


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
    before = flash_attn_bwd.launches
    got = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    # one launch a call in bf16, two (dk/dv, then dq) in fp32
    assert flash_attn_bwd.launches == before + 2 * (
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
    rng = np.random.RandomState(1)
    x = _randn(rng, (33, 65), in_dtype, cuda) * 100
    if bad is not None:
        x[7, 9] = float(bad)
    inv = torch.tensor([2.0 ** -10], device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    flag_ref = torch.zeros_like(flag)
    out = packed_scale(x, inv, out_dtype, flag)
    ref = packed_scale_ref(x, inv, out_dtype, flag_ref)
    torch.cuda.synchronize()
    assert int(flag) == int(flag_ref) == int(bad is not None)
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))


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
    n = len(list(model.parameters()))
    per_call, atol = TRAIN_LEVELS[opt_level]
    assert counts == {"layer_norm_fwd": 10, "flash_attn_fwd": 4,
                      "layer_norm_bwd": 20, "flash_attn_bwd": 4 * per_call,
                      "packed_adam": 2 * n, "packed_scale": 2 * n,
                      "lamb_stage1": 0, "lamb_stage2": 0,
                      "packed_sumsq": 0}
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
    assert counts == {"layer_norm_fwd": 2 * 6, "flash_attn_fwd": 2 * 2,
                      "layer_norm_bwd": 2 * 6 * 2, "flash_attn_bwd": 2 * 2 * 2,
                      "packed_adam": 0,
                      "packed_scale": 2 * len(list(model.parameters())),
                      "lamb_stage1": 2,
                      "lamb_stage2": 2, "packed_sumsq": 2}
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
