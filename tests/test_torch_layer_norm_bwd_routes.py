"""K3's routes on the CPU.

``ln_bwd_route``'s table is pinned at its boundaries; the plain backward
(through ``fused_layer_norm_affine``) is held against ``jax.grad`` of the
JAX package's ``fused_layer_norm_affine`` (its jnp path) at each route's
edges: widths at and off the 16-byte groups, few rows, n2 just above
1024; and a Python model of the kernels' fixed-order dw / db sums (stage
1's partial rows: a warp's rows in a fixed stride, the block's eight
warps added in order, or a block's rows in a fixed stride; stage 2's 32
chains and their tree) is held against the plain version.

Tolerances: against JAX as ``tests/test_torch_layer_norm.py`` (fp32 dx
``1e-5``, dγ / dβ ``1e-4``; bf16 within 2 bf16 ulps of each result's
largest value); the models' dw / db within ``rtol = 1e-5, atol = 1e-4``
of the plain version (the card tests' tolerance for these row sums) and
equal bit for bit on a second run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization.fused_layer_norm import (
    fused_layer_norm_affine as jax_layer_norm,
)
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.cuda import layer_norm_bwd_ref, layer_norm_fwd_ref
from apex_tpu_torch.ops.cuda.layer_norm import (BWD_BLOCK_ELEMS_MAX,
                                                BWD_BLOCK_ROWS_MAX,
                                                BWD_WARP_ELEMS_MAX,
                                                LN_BWD_ROUTES, _bwd_mode,
                                                ln_bwd_route)

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("n1,n2,dtype,aligned,want", [
    (16384, 768, BF16, True, "warp_vec"),       # gpt_small
    (16384, 1024, BF16, True, "warp_vec"),      # bert_large
    (16384, 768, FP32, True, "warp_vec"),       # O1 / O0
    (16384, 772, FP32, True, "block_vec"),      # over 24 fp32 a lane
    (16384, 1000, BF16, True, "warp_vec"),      # 125 groups of 8
    (16384, 1001, BF16, True, "warp_scalar"),   # off the groups
    (16384, 766, FP32, True, "warp_scalar"),
    (16384, 770, FP32, True, "block_scalar"),
    (16384, 768, FP16, False, "warp_scalar"),   # a misaligned view
    (65, 768, BF16, True, "warp_vec"),          # just over the few rows
    (64, 768, BF16, True, "block_vec"),         # few rows: a row a block
    (1, 768, BF16, True, "block_vec"),
    (16384, 1025, BF16, True, "block_scalar"),  # just over a warp's row
    (16384, 1032, BF16, True, "block_vec"),
    (37, 2304, FP32, True, "block_vec"),
    (16, 8192, BF16, True, "block_vec"),        # a block's whole row
    (16, 8200, BF16, True, "loop_scalar"),
    (16, 8192, FP32, True, "block_vec"),
    (16, 8196, FP32, True, "loop_scalar"),
])
def test_ln_bwd_route_pins_the_choice(n1, n2, dtype, aligned, want):
    assert ln_bwd_route(n1, n2, dtype, aligned) == want


@pytest.mark.parametrize("dtype", [BF16, FP16, FP32])
def test_ln_bwd_route_boundaries_follow_the_limits(dtype):
    per = 16 // dtype.itemsize
    rows = BWD_BLOCK_ROWS_MAX
    widest = BWD_WARP_ELEMS_MAX[dtype.itemsize]
    assert ln_bwd_route(rows + 1, widest, dtype) == "warp_vec"
    assert ln_bwd_route(rows, widest, dtype) == "block_vec"
    assert ln_bwd_route(rows + 1, widest + per, dtype) == "block_vec"
    assert ln_bwd_route(rows + 1, BWD_BLOCK_ELEMS_MAX, dtype) == "block_vec"
    assert ln_bwd_route(rows + 1, BWD_BLOCK_ELEMS_MAX + per, dtype) \
        == "loop_scalar"


@pytest.mark.parametrize("route", ["warp_vec", "block_scalar",
                                   "loop_scalar"])
def test_the_mode_word_carries_the_route(route):
    n1, n2 = {"warp_vec": (300, 768), "block_scalar": (300, 1025),
              "loop_scalar": (3, 20000)}[route]
    mode = _bwd_mode(n1, n2, BF16, 1, True)
    kind, _, access = route.partition("_")
    assert mode & 3 == 1 and (mode >> 2) & 3 == 1
    assert (mode >> 4) & 3 == LN_BWD_ROUTES[kind]
    assert (mode >> 6) & 1 == (access == "vec")


# Each route's edges: widths at and off the 16-byte groups (8 bf16, 4
# fp32), few rows, a row just above a warp's 1024 elements
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n1,n2", [(1, 768), (2, 776), (65, 770),
                                   (70, 1000), (3, 1001), (66, 1025),
                                   (4, 1032), (2, 4096)])
def test_plain_backward_matches_jax_at_the_route_edges(n1, n2, dtype):
    rng = np.random.RandomState(n1 * 7 + n2)
    x = (rng.standard_normal((n1, n2)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((n1, n2)).astype(np.float32)
    w = rng.standard_normal(n2).astype(np.float32)
    b = rng.standard_normal(n2).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jdy, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, dy, w, b))

    def f(xx, ww, bb):
        return jnp.sum(jax_layer_norm(xx, ww, bb, n2, 1e-5)
                       .astype(jnp.float32) * jdy.astype(jnp.float32))
    want = [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in jax.grad(f, argnums=(0, 1, 2))(jx, jw, jb)]
    tdt = getattr(torch, dtype)
    tx, tw, tb = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, w, b))
    fused_layer_norm_affine(tx, tw, tb, n2, 1e-5).backward(
        torch.from_numpy(dy).to(tdt))
    got = [tx.grad, tw.grad, tb.grad]
    if dtype == "float32":
        tols = [1e-5, 1e-4, 1e-4]
    else:
        tols = [2 * 2.0 ** -8 * float(w_.abs().max()) for w_ in want]
    for g, w_, tol in zip(got, want, tols):
        torch.testing.assert_close(g.float(), w_, atol=tol, rtol=0)


def _stage2(part_w, part_b):
    """K3's stage 2 over fp32 partial rows (parts, n2): chain c of 32 adds
    rows c, c + 32, ... in order; a warp's 8 chains meet in a shuffle tree
    ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)); the 4 warps add in order."""
    out = []
    for part in (part_w, part_b):
        chains = []
        for c in range(32):
            acc = np.zeros(part.shape[1], np.float32)
            for r in range(c, part.shape[0], 32):
                acc = acc + part[r]
            chains.append(acc)
        total = np.zeros(part.shape[1], np.float32)
        for w in range(4):
            v = chains[8 * w:8 * w + 8]
            for step in (1, 2, 4):   # lane bits 2, 3, 4: chain bits 0, 1, 2
                v = [v[i] + v[i ^ step] for i in range(8)]
            total = total + v[0]
        out.append(total)
    return out


def _row_terms(dy, x, mean, inv):
    xhat = ((x - mean[:, None]) * inv[:, None]).astype(np.float32)
    return (dy * xhat).astype(np.float32), dy


def _warp_route_model(dy, x, mean, inv, blocks, warps=8):
    """Stage 1 of the warp route: warp (block, k) adds rows block * warps
    + k, + blocks * warps, ... in order; the block adds its warps' sums in
    warp order; one partial row a block."""
    t_w, t_b = _row_terms(dy, x, mean, inv)
    n1, n2 = dy.shape
    parts = []
    for terms in (t_w, t_b):
        rows = []
        for blk in range(blocks):
            acc = []
            for k in range(warps):
                a = np.zeros(n2, np.float32)
                for r in range(blk * warps + k, n1, blocks * warps):
                    a = a + terms[r]
                acc.append(a)
            total = np.zeros(n2, np.float32)
            for a in acc:
                total = total + a
            rows.append(total)
        parts.append(np.stack(rows))
    return _stage2(*parts)


def _block_route_model(dy, x, mean, inv, blocks):
    """Stage 1 of the block route: block b adds rows b, b + blocks, ... in
    order, each thread its own columns; one partial row a block."""
    t_w, t_b = _row_terms(dy, x, mean, inv)
    parts = []
    for terms in (t_w, t_b):
        rows = []
        for blk in range(blocks):
            a = np.zeros(dy.shape[1], np.float32)
            for r in range(blk, dy.shape[0], blocks):
                a = a + terms[r]
            rows.append(a)
        parts.append(np.stack(rows))
    return _stage2(*parts)


def _ln_inputs(n1, n2, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.standard_normal((n1, n2)) * 2 + 0.3)
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((n1, n2)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(n2).astype(np.float32))
    _, mean, inv = layer_norm_fwd_ref(x, w, torch.zeros(n2), 1e-5)
    return dy, x, w, mean, inv


@pytest.mark.parametrize("n1,n2,blocks,model", [
    (300, 96, 3, "warp"),      # 24 warps, uneven rows a warp
    (1000, 40, 2, "warp"),
    (37, 100, 37, "block"),    # few rows: a row a block
    (90, 136, 7, "block"),
    (5, 64, 1, "warp"),        # fewer rows than warps
    (2000, 24, 5, "warp"),
])
def test_partial_row_sums_equal_the_plain_version(n1, n2, blocks, model):
    dy, x, w, mean, inv = _ln_inputs(n1, n2, n1 + n2)
    fn = _warp_route_model if model == "warp" else _block_route_model
    args = (dy.numpy(), x.numpy(), mean.numpy(), inv.numpy(), blocks)
    dw, db = fn(*args)
    again = fn(*args)
    assert np.array_equal(dw, again[0]) and np.array_equal(db, again[1])
    _, rdw, rdb = layer_norm_bwd_ref(dy, x, w, mean, inv)
    torch.testing.assert_close(torch.from_numpy(dw), rdw, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(torch.from_numpy(db), rdb, rtol=1e-5,
                               atol=1e-4)
