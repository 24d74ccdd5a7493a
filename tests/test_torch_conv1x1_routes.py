"""K16's routes on the CPU.

``conv1x1_route``'s table is pinned at its boundaries; the plain backward
is held against JAX's ``conv1x1`` under ``jax.grad`` (its Pallas backward
in interpret mode where a tile divides M, the lax transpose where none
does) at each route's edges; and a Python model of the kernels' dW sums
(the one_pass route's static split of 64-row M tiles by the grid, the
two_role route's chunks of M, each summed into an fp32 plane, the planes
added in index order) is held against the plain version.

Tolerances: against JAX as ``tests/test_torch_conv1x1.py`` (dx ``rtol =
atol = 1e-5``, dW ``rtol = 1e-4, atol = 1e-3``: fp32 sums over M rows in
other orders); the models' dW within ``2e-6`` of the largest |dW| (fp32
sums of the same products in another order, over at most ~3000 rows) and
equal bit for bit on a second run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.experimental import conv1x1 as c1
from apex_tpu_torch.ops.cuda import conv1x1_bwd, conv1x1_bwd_ref
from apex_tpu_torch.ops.cuda.conv1x1 import (ONE_PASS_TILES_MAX, ROUTES,
                                             conv1x1_route)

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("m,cin,cout,dtype,aligned,want", [
    # ResNet-50's stage-1 shapes: dW fits on chip
    (802816, 64, 64, BF16, True, "one_pass"),
    (802816, 64, 256, BF16, True, "one_pass"),
    (802816, 256, 64, BF16, True, "one_pass"),
    (802816, 256, 128, BF16, True, "one_pass"),
    # the mid and late stages: cin or cout >= 512
    (200704, 512, 128, BF16, True, "two_role"),
    (200704, 128, 512, BF16, True, "two_role"),
    (50176, 1024, 256, BF16, True, "two_role"),
    (12544, 2048, 512, FP16, True, "two_role"),
    # the boundary: 8 tiles of 64 x 64 and one more
    (1000, 512, 64, BF16, True, "one_pass"),
    (1000, 520, 64, BF16, True, "two_role"),
    (1000, 128, 256, FP16, True, "one_pass"),
    (1000, 128, 264, FP16, True, "two_role"),
    (1000, 256, 136, BF16, True, "two_role"),
    # channel counts off the 8 grid, misaligned pointers, fp32: CUDA cores
    (1000, 24, 40, BF16, True, "one_pass"),
    (1000, 20, 40, BF16, True, "fma"),
    (1000, 24, 36, FP16, True, "fma"),
    (802816, 64, 64, BF16, False, "fma"),
    (50176, 1024, 256, FP32, True, "fma"),
    (1001, 24, 40, FP32, True, "fma"),
    (2 ** 31, 64, 64, BF16, True, "fma"),     # past TMA's coordinates
])
def test_conv1x1_route_pins_the_choice(m, cin, cout, dtype, aligned, want):
    assert conv1x1_route(m, cin, cout, dtype, aligned) == want
    assert want in ROUTES


@pytest.mark.parametrize("cin,cout", [(64, 64), (256, 128), (512, 64),
                                      (520, 64), (1024, 256), (24, 40)])
def test_conv1x1_route_does_not_depend_on_m(cin, cout):
    routes = {conv1x1_route(m, cin, cout, BF16) for m in (1, 63, 64, 65,
                                                          802816)}
    assert len(routes) == 1
    tiles = -(-cin // 64) * -(-cout // 64)
    assert routes == {"one_pass" if tiles <= ONE_PASS_TILES_MAX
                      else "two_role"}


def _jax_grads(x, w, dy):
    def loss(x, w):
        return jnp.sum(c1.conv1x1(x, w).astype(jnp.float32)
                       * dy.astype(jnp.float32))
    return jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))


# Each route's edges: M not a multiple of the 64-row tile (nor of JAX's
# tiles: the lax transpose), channel counts off the 8 and 64 grids, and
# the one_pass / two_role crossing on both sides
@pytest.mark.parametrize("b,h,wd,cin,cout,route", [
    (1, 5, 13, 64, 64, "one_pass"),      # M 65
    (1, 3, 43, 24, 40, "one_pass"),      # M 129, one 64 x 64 dW tile
    (2, 4, 8, 72, 40, "one_pass"),       # cin off the 64 grid
    (2, 4, 4, 20, 36, "fma"),            # off the 8 grid
    (1, 8, 8, 512, 64, "one_pass"),      # 8 dW tiles
    (1, 8, 8, 520, 64, "two_role"),      # 9
    (1, 8, 8, 128, 256, "one_pass"),
    (1, 8, 8, 128, 264, "two_role"),
    (1, 7, 19, 136, 256, "two_role"),    # M 133
])
def test_plain_backward_matches_jax_at_the_route_edges(b, h, wd, cin, cout,
                                                       route):
    m = b * h * wd
    assert conv1x1_route(m, cin, cout, BF16) == route
    rng = np.random.RandomState(m + cin + cout)
    x = rng.standard_normal((b, h, wd, cin)).astype(np.float32)
    w = (rng.standard_normal((1, 1, cin, cout)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((b, h, wd, cout)).astype(np.float32)
    jdx, jdw = _jax_grads(x, w, dy)
    dx, dw = conv1x1_bwd(torch.from_numpy(x).reshape(m, cin),
                         torch.from_numpy(dy).reshape(m, cout),
                         torch.from_numpy(w).reshape(cin, cout))
    np.testing.assert_allclose(dx.reshape(x.shape).numpy(), np.asarray(jdx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.reshape(w.shape).numpy(), np.asarray(jdw),
                               rtol=1e-4, atol=1e-3)


def _one_pass_ranges(m, grid):
    """The one_pass route's static split: block b walks 64-row tiles
    [b n / grid, (b + 1) n / grid) of n = ceil(m / 64)."""
    n = -(-m // 64)
    return [(b * n // grid, (b + 1) * n // grid) for b in range(grid)]


def _one_pass_model(x, dy, grid):
    """dW as the one_pass route sums it: each block's tiles into its fp32
    plane (with a single 64 x 64 dW tile, each warpgroup's every other
    tile into its own plane), the planes added in index order."""
    cin, cout = x.shape[1], dy.shape[1]
    ksplit = -(-cin // 64) * -(-cout // 64) == 1
    planes = []
    for t0, t1 in _one_pass_ranges(x.shape[0], grid):
        own = [torch.zeros(cin, cout) for _ in range(2 if ksplit else 1)]
        for it, t in enumerate(range(t0, t1)):
            rows = slice(64 * t, 64 * t + 64)
            own[it % 2 if ksplit else 0] += x[rows].t() @ dy[rows]
        planes += own
    dw = torch.zeros(cin, cout)
    for p in planes:
        dw = dw + p
    return dw, len(planes)


def _two_role_model(x, dy, split):
    """dW as the two_role route sums it: M in chunks of a whole number of
    64-row steps, one fp32 plane a chunk, added in index order."""
    m = x.shape[0]
    chunk = -(-(-(-m // split)) // 64) * 64
    planes = [x[s:s + chunk].t() @ dy[s:s + chunk]
              for s in range(0, m, chunk)]
    dw = torch.zeros(x.shape[1], dy.shape[1])
    for p in planes:
        dw = dw + p
    return dw, len(planes)


@pytest.mark.parametrize("m", [1, 64, 65, 1000, 3000])
@pytest.mark.parametrize("grid", [1, 7, 132])
def test_one_pass_split_covers_every_tile_once(m, grid):
    ranges = _one_pass_ranges(m, min(grid, -(-m // 64)))
    tiles = [t for t0, t1 in ranges for t in range(t0, t1)]
    assert tiles == list(range(-(-m // 64)))
    assert all(t1 > t0 for t0, t1 in ranges)


def _inputs(m, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((m, cin)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((m, cout)).astype(np.float32))
    return x, dy


@pytest.mark.parametrize("m,cin,cout,grid", [
    (3000, 64, 64, 7),      # one tile: the warpgroups' own planes
    (3000, 256, 128, 13),
    (1000, 24, 40, 16),
    (130, 72, 40, 132),     # more blocks than tiles: the grid is capped
])
def test_one_pass_plane_sums_equal_the_plain_version(m, cin, cout, grid):
    x, dy = _inputs(m, cin, cout, m + cin)
    grid = min(grid, -(-m // 64))
    dw, planes = _one_pass_model(x, dy, grid)
    again, _ = _one_pass_model(x, dy, grid)
    assert torch.equal(dw, again)
    assert planes == grid * (2 if cin <= 64 and cout <= 64 else 1)
    _, ref = conv1x1_bwd_ref(x, dy, torch.zeros(cin, cout))
    torch.testing.assert_close(dw, ref, rtol=0,
                               atol=2e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("m,cin,cout,split", [
    (3000, 512, 128, 1), (3000, 512, 128, 8), (2500, 136, 264, 3),
    (133, 520, 64, 32)])
def test_two_role_plane_sums_equal_the_plain_version(m, cin, cout, split):
    x, dy = _inputs(m, cin, cout, m + cout)
    dw, planes = _two_role_model(x, dy, split)
    again, _ = _two_role_model(x, dy, split)
    assert torch.equal(dw, again)
    assert planes <= split
    _, ref = conv1x1_bwd_ref(x, dy, torch.zeros(cin, cout))
    torch.testing.assert_close(dw, ref, rtol=0,
                               atol=2e-6 * float(ref.abs().max()))
