"""The port's multi-tensor surface (``multi_tensor_applier`` with
``multi_tensor_scale`` / ``multi_tensor_axpby`` / ``multi_tensor_l2norm``,
on the CPU through the kernels' plain versions) against the JAX
package's ``apex_tpu.ops.multi_tensor`` (its jnp path), on the same
inputs made with numpy from a seed.

Tolerances: scale and axpby bitwise, with equal flags (both compute each
product and the sum in fp32, rounded on its own, then cast once).  The
norms within ``1e-6`` relative: both sum squares in fp32, in other
orders (the port by 64 Ki-element chunk partials, K12's order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import MultiTensorApply as JaxApply
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch.multi_tensor_apply import (
    MultiTensorApply,
    multi_tensor_applier,
)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.cuda import (
    packed_axpby,
    sumsq_per_tensor,
    sumsq_per_tensor_ref,
)

#: leaf sizes around a chunk's 65536 elements, and a ragged multi-chunk one
SIZES = [1, 65535, 65536, 65537, 3 * 65536 + 5]
CHUNKS = [mt.CHUNK_SIZE, 1024]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _arrays(seed, sizes=SIZES, scale=100.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(n) * scale).astype(np.float32)
            for n in sizes]


def _pair(arrays, kinds):
    """The same values as torch and jax leaves, leaf i of dtype
    ``kinds[i % len(kinds)]``."""
    ts, js = [], []
    for i, a in enumerate(arrays):
        tdt, jdt = DTYPES[kinds[i % len(kinds)]]
        ts.append(torch.from_numpy(a.copy()).to(tdt))
        js.append(jnp.asarray(a).astype(jdt))
    return ts, js


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _poison(arrays, leaf, value):
    arrays[leaf][arrays[leaf].size // 2] = value
    return arrays


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("bad", [None, np.inf, np.nan])
@pytest.mark.parametrize("kinds,template", [
    (["f32"], None), (["bf16"], "f32"), (["f32", "bf16"], None),
    (["bf16", "f32"], "bf16")])
def test_scale_matches_jax_bitwise(chunk, bad, kinds, template):
    arrays = _arrays(0)
    if bad is not None:
        _poison(arrays, 3, bad)
    ts, js = _pair(arrays, kinds)
    tl, jl = [ts], [js]
    if template is not None:
        tl.append([torch.zeros(1, dtype=DTYPES[template][0])])
        jl.append([jnp.zeros(1, DTYPES[template][1])])
    t_out, t_flag = MultiTensorApply(chunk)(mt.multi_tensor_scale, tl,
                                            2.0 ** -7)
    j_out, j_flag = JaxApply(chunk)(jmt.multi_tensor_scale, jl, 2.0 ** -7)
    assert int(t_flag) == int(j_flag) == int(bad is not None)
    for t, j in zip(t_out, j_out):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("arg_to_check", [-1, 0, 1])
@pytest.mark.parametrize("bad_in", [None, "x", "y"])
def test_axpby_matches_jax_bitwise(chunk, arg_to_check, bad_in):
    """Mixed-dtype xs (bf16 and fp32 leaves), fp32 ys, outputs in x's
    dtype; an inf placed in x or in y raises the flag only where
    ``arg_to_check`` looks."""
    xa, ya = _arrays(1), _arrays(2, scale=1.0)
    if bad_in == "x":
        _poison(xa, 2, np.inf)
    elif bad_in == "y":
        _poison(ya, 4, -np.inf)
    tx, jx = _pair(xa, ["bf16", "f32"])
    ty, jy = _pair(ya, ["f32"])
    a, b = 2.0 ** -10, -1.25
    t_out, t_flag = multi_tensor_applier.__class__(chunk)(
        mt.multi_tensor_axpby, [tx, ty], a, b, arg_to_check)
    j_out, j_flag = JaxApply(chunk)(jmt.multi_tensor_axpby, [jx, jy], a, b,
                                    arg_to_check)
    want = {None: 0, "x": int(arg_to_check in (-1, 0)),
            "y": int(arg_to_check in (-1, 1))}[bad_in]
    assert int(t_flag) == int(j_flag) == want
    for t, j in zip(t_out, j_out):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("template", ["f32", "bf16"])
def test_axpby_out_templates_and_in_place_match_jax(template):
    """``[xs, ys, out_templates]`` sets the output dtype; the port's
    ``out=`` writes into the ys themselves (the accumulation's in-place
    form) with the values JAX returns."""
    xa, ya = _arrays(3, SIZES[:3]), _arrays(4, SIZES[:3], scale=1.0)
    tx, jx = _pair(xa, ["bf16"])
    ty, jy = _pair(ya, ["f32"])
    tdt, jdt = DTYPES[template]
    t_out, _ = multi_tensor_applier(
        mt.multi_tensor_axpby, [tx, ty, [torch.zeros(1, dtype=tdt)]], 1.0,
        1.0)
    j_out, _ = JaxApply()(jmt.multi_tensor_axpby,
                          [jx, jy, [jnp.zeros(1, jdt)]], 1.0, 1.0)
    for t, j in zip(t_out, j_out):
        assert t.dtype == tdt
        np.testing.assert_array_equal(_np(t), _np(j))
    want, _ = JaxApply()(jmt.multi_tensor_axpby, [jx, jy], 1.0, 1.0,
                         out_dtype=jnp.float32)
    kept = list(ty)
    outs, flag = multi_tensor_applier(mt.multi_tensor_axpby, [tx, ty], 1.0,
                                      1.0, out=ty)
    assert all(o is k for o, k in zip(outs, kept)) and int(flag) == 0
    for t, j in zip(ty, want):
        np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("per_tensor", [False, True])
def test_l2norm_matches_jax(chunk, per_tensor):
    arrays = _arrays(5) + [np.zeros(0, np.float32), np.zeros(9, np.float32)]
    ts, js = _pair(arrays, ["f32", "bf16"])
    t_tot, t_per = MultiTensorApply(chunk)(mt.multi_tensor_l2norm, [ts],
                                           per_tensor)
    j_tot, j_per = JaxApply(chunk)(jmt.multi_tensor_l2norm, [js],
                                   per_tensor)
    np.testing.assert_allclose(_np(t_tot), _np(j_tot), rtol=1e-6, atol=0)
    assert t_tot.shape == ()
    if per_tensor:
        assert t_per.shape == (len(arrays),)
        np.testing.assert_allclose(_np(t_per), _np(j_per), rtol=1e-6,
                                   atol=0)
    else:
        assert t_per is None and j_per is None


def test_per_tensor_sumsq_is_k12_plain_version_on_the_cpu():
    ts, _ = _pair(_arrays(6, [5, 70000, 0, 3]), ["f32"])
    table = mt.table_for(ts, 1024)
    assert mt.table_for(ts, 1024) is table
    before = sumsq_per_tensor.launches
    got = sumsq_per_tensor(table, ts)
    assert sumsq_per_tensor.launches == before
    assert torch.equal(got, sumsq_per_tensor_ref(table, ts))
    assert torch.equal(got, mt.per_tensor_sumsq(1024, [ts]))
    np.testing.assert_allclose(got.numpy(), [float((t.double() ** 2).sum())
                                             for t in ts], rtol=1e-6)
    assert got[2] == 0.0


def test_empty_lists_and_refusals():
    assert multi_tensor_applier.available and \
        multi_tensor_applier.chunk_size == mt.CHUNK_SIZE
    outs, flag = multi_tensor_applier(mt.multi_tensor_scale, [[]], 2.0)
    assert outs == [] and int(flag) == 0
    outs, flag = multi_tensor_applier(mt.multi_tensor_axpby, [[], []], 1.0,
                                      1.0)
    assert outs == [] and int(flag) == 0
    tot, per = multi_tensor_applier(mt.multi_tensor_l2norm, [[]], True)
    assert float(tot) == 0.0 and per.shape == (0,)
    x = [torch.ones(3)]
    with pytest.raises(ValueError, match="xs for"):
        multi_tensor_applier(mt.multi_tensor_axpby, [x, x + x], 1.0, 1.0)
    with pytest.raises(ValueError, match="arg_to_check"):
        multi_tensor_applier(mt.multi_tensor_axpby, [x, x], 1.0, 1.0, 2)
    table = mt.ChunkTable([3], "cpu")
    with pytest.raises(ValueError, match="leaf sizes"):
        packed_axpby(table, x, [torch.ones(4)], torch.ones(1),
                     torch.ones(1), torch.zeros(1, dtype=torch.int32), x)


#: a tree that mixes bf16 and fp32 leaves of odd sizes (none a multiple
#: of 8), one of them above a chunk
MIXED_SIZES = [1, 7, 65537, 1001, 3, 333]
MIXED_KINDS = ["bf16", "f32", "bf16", "f32", "f32", "bf16"]


@pytest.mark.parametrize("where", ["kept_buffers", "in_place"])
@pytest.mark.parametrize("out_kind", ["f32", "own"])
def test_table_scale_matches_jax_bitwise(where, out_kind):
    """K6's plain version over the chunk table (what ``LossScaler.
    unscale`` and ``multi_tensor_scale`` launch once a call) against
    JAX's ``multi_tensor_scale`` on a mixed bf16 / fp32 tree with an inf
    in one leaf and a nan in another: the outputs bit for bit, the flags
    equal; into kept buffers (fp32, or each leaf's own dtype) and in
    place."""
    from apex_tpu_torch.ops.cuda import packed_scale, packed_scale_ref
    arrays = _arrays(7, MIXED_SIZES)
    arrays[2][40000] = np.inf
    arrays[5][100] = np.nan
    ts, js = _pair(arrays, MIXED_KINDS)
    scale = 2.0 ** -9
    odt = torch.float32 if out_kind == "f32" else None
    if where == "in_place":
        odt = None
        outs = ts
    else:
        table_dt = [odt or t.dtype for t in ts]
        outs = mt.ChunkTable.of(ts).empty_views([t.shape for t in ts],
                                                table_dt)
    table = mt.table_for(ts)
    flag = torch.zeros(1, dtype=torch.int32)
    s = torch.full((1,), scale)
    before = packed_scale.launches
    got = packed_scale(table, ts, s, flag, outs)
    assert packed_scale.launches == before      # the CPU runs no kernel
    j_out, j_flag = jmt.multi_tensor_scale(
        mt.CHUNK_SIZE, [js], scale,
        jnp.float32 if odt == torch.float32 else None)
    assert int(flag) == int(j_flag) == 1
    for t, j, o in zip(got, j_out, outs):
        assert t is o
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t), _np(j))
    # and the plain version is the wrapper's CPU path
    fresh, _ = _pair(arrays, MIXED_KINDS)
    again = [torch.empty_like(o) for o in outs]
    flag2 = torch.zeros(1, dtype=torch.int32)
    packed_scale_ref(table, fresh, s, flag2, again)
    assert int(flag2) == 1
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip(again, got))


def test_table_scale_refuses_what_it_cannot_take():
    from apex_tpu_torch.ops.cuda import packed_scale_ref
    ts = [torch.ones(5), torch.ones(3)]
    table = mt.ChunkTable.of(ts)
    flag = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="leaf sizes"):
        packed_scale_ref(table, ts[:1], torch.ones(1), flag, ts[:1])


def test_empty_views_align_each_leaf_in_one_buffer_a_dtype():
    sizes = [3, 65, 1, 128]
    dts = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16]
    table = mt.ChunkTable(sizes, "cpu")
    views = table.empty_views([(n,) for n in sizes], dts)
    assert [v.numel() for v in views] == sizes
    assert [v.dtype for v in views] == dts
    for v in views:
        assert v.is_contiguous()
        assert v.storage_offset() % mt.VIEW_ALIGN == 0
    # one storage per dtype
    assert views[0].untyped_storage().data_ptr() \
        == views[2].untyped_storage().data_ptr()
    assert views[1].untyped_storage().data_ptr() \
        == views[3].untyped_storage().data_ptr()
    # flat_views keeps its zero fill
    buf, zs = table.flat_views([(n,) for n in sizes])
    assert float(buf.abs().sum()) == 0.0 and zs[1].numel() == 65


def test_multi_tensor_scale_is_one_call_over_a_mixed_list(monkeypatch):
    """``multi_tensor_scale`` makes one K6 call over the whole list,
    whatever dtypes it mixes (on the card: one launch)."""
    calls = []
    orig = mt.packed_scale

    def spy(table, x, scale, flag, out):
        calls.append((table.n_leaves, [o.dtype for o in out]))
        return orig(table, x, scale, flag, out)
    monkeypatch.setattr(mt, "packed_scale", spy)
    ts, _ = _pair(_arrays(3, MIXED_SIZES), MIXED_KINDS)
    outs, flag = mt.multi_tensor_scale(mt.CHUNK_SIZE, [ts], 0.5)
    assert len(calls) == 1 and calls[0][0] == len(ts)
    assert calls[0][1] == [t.dtype for t in ts]
    assert int(flag) == 0
    assert all(torch.equal(o, (t.float() * 0.5).to(t.dtype))
               for o, t in zip(outs, ts))
