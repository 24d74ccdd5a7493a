"""The generic flash kernels' layouts and their plain versions, on the CPU.

The card runs the generic kernels (``csrc/flash_simt.cu``: fp32 at every
head width, bf16 / fp16 above D 128) in one of two layouts, which
``simt_layout`` picks in Python and passes to the C entry points as a
mode word: ``"tiled"`` (query and key tiles in shared memory, register
micro-tiles) up to D 256, ``"rows"`` (a warp a row) above.  Here:

- ``simt_layout`` is pinned for every dtype and every head width the
  kernels take (multiples of 8 up to 9664), and ``fwd_route`` /
  ``bwd_route`` keep their table;
- the plain versions the kernels are held to on the card
  (``flash_attn_fwd_ref``, ``flash_attn_bwd_ref``) against the JAX
  package's ``_jnp_attention`` and ``jax.vjp`` of it at the tiles' edge
  shapes (L 63, 65 and 1000 around the 64-row tiles; D 8 and 256, the
  narrowest and widest tiled widths), causal with a key mask that blanks
  whole rows, and rope (JAX's ``apply_rope`` on q and k first): fp32,
  o and lse within ``2e-5`` (``rtol = 1e-5`` on lse), the gradients
  within ``1e-4``, the bounds of ``tests/test_torch_flash_attention.py``;
- amp O0 (fp32) training at head width 128 (gpt_small_tpu's 6 x 128
  geometry, 2 layers, L 32; the widest head of the tiled kernels' 64-row
  tiles): the first step's gradients against ``jax.grad`` and 7 steps
  against JAX's ``make_train_step``, with the bounds each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.flash_attention import _jnp_attention
from apex_tpu.ops.rope import apply_rope as jax_apply_rope
from apex_tpu_torch.ops.cuda import (
    bwd_route,
    flash_attn_bwd_ref,
    flash_attn_fwd_ref,
    flash_bwd_simt,
    flash_fwd_simt,
    fwd_route,
    simt_layout,
)
from apex_tpu_torch.ops.cuda.flash_attention import (
    MAX_HEAD_DIM,
    MAX_TC_HEAD_DIM,
    TILED_MAX_HEAD_DIM,
)
from test_torch_flash_attention import _inputs, _np, _rope_tables
from test_torch_train import _jax_run, _leaves, _stream, _torch_run

NEG_INF = -1e30
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
WIDTHS = range(8, MAX_HEAD_DIM + 1, 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_simt_layout_is_tiled_up_to_256_and_rows_above(dtype):
    assert TILED_MAX_HEAD_DIM == 256 and MAX_HEAD_DIM == 9664
    for d in WIDTHS:
        want = "tiled" if d <= 256 else "rows"
        assert simt_layout(dtype, d) == want, (dtype, d)


@pytest.mark.parametrize("d", [0, 4, 36, 260, 9672, 10000])
def test_simt_layout_refuses_what_no_kernel_takes(d):
    with pytest.raises(ValueError, match="head dim"):
        simt_layout(torch.float32, d)


def test_simt_layout_refuses_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        simt_layout(torch.float64, 64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_routes_keep_their_table(dtype):
    """The routes ``simt_layout`` sits beside: the tensor-core kernels for
    bf16 / fp16 up to D 128 (the backward fused within the budget, two-pass
    above it), the generic kernels for fp32 and wider half heads."""
    half = dtype != torch.float32
    for d in WIDTHS:
        tc = half and d <= MAX_TC_HEAD_DIM
        assert fwd_route(dtype, d) == ("sm90" if tc else "simt")
        assert bwd_route(dtype, d, 10, 10) == ("fused" if tc else "simt")
        assert bwd_route(dtype, d, 11, 10) == ("two_pass" if tc
                                                else "simt")


EDGE_CASES = [  # (shape, causal, masked, rope)
    ((2, 63, 2, 8), True, True, True),
    ((2, 65, 2, 8), False, True, False),
    ((2, 63, 2, 256), True, True, True),
    ((2, 65, 2, 256), False, False, True),
    ((1, 1000, 1, 8), True, True, True),
    ((1, 1000, 1, 256), True, True, False),
]


def _edge_mask(b, l, seed):
    """A key mask whose batch 0 blanks every key (every row sees none) and
    whose batch 1 (if any) hides key 0 (causal row 0 sees none)."""
    mask = np.random.RandomState(seed).rand(b, l) > 0.3
    mask[0] = False
    if b > 1:
        mask[1, 0] = False
    else:
        mask[0, l // 3:] = True       # one batch row: rows past l / 3 see keys
    return mask


@pytest.mark.parametrize("shape,causal,masked,rope", EDGE_CASES)
def test_plain_versions_match_jax_at_the_tiles_edges(shape, causal, masked,
                                                     rope):
    b, l, h, d = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "float32", l + d)
    do = np.random.RandomState(d).standard_normal(shape).astype(np.float32)
    mask = _edge_mask(b, l, l) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    (jcos, jsin), tables = _rope_tables(b, l, d)
    scale = 1 / d ** 0.5

    def f(q, k, v):
        if rope:
            q, k = (jax_apply_rope(t, jcos, jsin) for t in (q, k))
        return _jnp_attention(q, k, v, causal=causal, kv_mask=jmask,
                              scale=scale, return_lse=True)

    (jo, jlse), vjp = jax.vjp(f, jq, jk, jv)
    want = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))
    kw = dict(causal=causal, kv_mask=tmask, rope=tables if rope else None)
    o, lse = flash_attn_fwd_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.numpy(), _np(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _np(jlse), atol=2e-5, rtol=1e-5)
    got = flash_attn_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do), **kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    blank = []                    # (batch, rows) that see no key
    if masked and b > 1:
        blank = [(0, slice(None))] + ([(1, 0)] if causal else [])
    elif masked and causal:
        blank = [(0, slice(0, l // 3))]
    for at in blank:
        assert torch.all(o[at] == 0) and torch.all(lse[at] == NEG_INF)
        assert torch.all(got[0][at] == 0)
    assert blank or not (masked and causal)


@pytest.mark.parametrize("shape,causal,masked,rope", EDGE_CASES[:2])
def test_generic_wrappers_take_the_plain_versions_on_the_cpu(shape, causal,
                                                             masked, rope):
    """``flash_fwd_simt`` / ``flash_bwd_simt`` on CPU tensors are their
    plain versions, bit for bit, and count no launch."""
    b, l, h, d = shape
    _, (tq, tk, tv) = _inputs(shape, "float32", l)
    do = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    mask = torch.from_numpy(_edge_mask(b, l, 1)) if masked else None
    kw = dict(causal=causal, kv_mask=mask,
              rope=_rope_tables(b, l, d)[1] if rope else None)
    before = (flash_fwd_simt.launches, flash_bwd_simt.launches)
    o, lse = flash_fwd_simt(tq, tk, tv, return_lse=True, **kw)
    ro, rlse = flash_attn_fwd_ref(tq, tk, tv, **kw)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    got = flash_bwd_simt(tq, tk, tv, o, lse, do, **kw)
    want = flash_attn_bwd_ref(tq, tk, tv, o, lse, do, **kw)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert (flash_fwd_simt.launches, flash_bwd_simt.launches) == before


#: gpt_small_tpu's 6 heads of 128 (hidden 768), 2 layers, a narrow FFN
D128 = dict(vocab_size=512, hidden_size=768, num_layers=2, num_heads=6,
            intermediate_size=1536)


def test_o0_first_step_gradients_at_head_width_128_match_jax():
    """Every gradient of the first O0 step (the attention backward's
    plain version at D 128 inside it) within ``5e-7`` of ``jax.grad``,
    the bound of ``tests/test_torch_train.py``."""
    from apex_tpu.models import GPTModel as JaxGPT
    from apex_tpu.models.gpt import GPTConfig as JaxConfig
    from apex_tpu.models.gpt import lm_loss as jax_lm_loss
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import GPTConfig, lm_loss
    ids = _stream(D128["vocab_size"])
    jmodel = JaxGPT(JaxConfig(**D128))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(ids[:, :16]))["params"]
    x = jnp.asarray(ids)
    want = jax.grad(lambda p: jax_lm_loss(
        jmodel.apply({"params": p}, x)[:, :-1], x[:, 1:]))(params)
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            GPTConfig(**D128), device="cpu", trainable=True)
    t = torch.from_numpy(ids).long()
    lm_loss(model(t)[:, :-1], t[:, 1:]).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[tuple(name.split("."))],
                                   atol=5e-7, rtol=0, err_msg=name)


def test_o0_fp32_steps_at_head_width_128_match_jax():
    """7 O0 steps: every loss within ``1e-5`` of JAX's, and all but 0.01%
    of the final fp32 masters within ``1e-5`` (the fraction bound of
    ``tests/test_torch_train.py``).  That file's every-element bound of
    ``1e-4`` is not applied: at this width (1.2 M elements in a leaf) an
    element whose gradient is near zero takes an Adam step ``m /
    sqrt(v)`` of about the learning rate (3e-3) whose sign rounding
    decides, and one of them drifted by 1.75e-4 (measured), while the
    losses agreed within 1e-5."""
    from apex_tpu_torch.convert import params_to_numpy
    ids = _stream(D128["vocab_size"])
    tree, jm, jmaster = _jax_run(D128, "O0", ids)
    _, a, tm = _torch_run(D128, "O0", tree, ids)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 1e-5, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"] == 1.0
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    got = dict(_leaves(params_to_numpy(a.masters)))
    want = dict(_leaves(jmaster))
    assert set(got) == set(want)
    beyond, total = 0, 0
    for path, w in want.items():
        assert np.all(np.isfinite(got[path])), path
        beyond += int((np.abs(got[path] - w) > 1e-5).sum())
        total += w.size
    assert beyond <= 1e-4 * total, (beyond, total)
