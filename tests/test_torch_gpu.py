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
cores, as the TPU kernel does).
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops.cuda import (
    flash_attn_fwd,
    flash_attn_fwd_ref,
    layer_norm_fwd,
    layer_norm_fwd_ref,
)
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
    x = torch.zeros((4, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        layer_norm_fwd(x, None, None, 1e-5)


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
