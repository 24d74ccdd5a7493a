"""The port's flat-buffer packing (``apex_tpu_torch.ops.packing``) against
the JAX package's ``apex_tpu.ops.packing`` on ragged leaf lists: the
buffers, the metadata and the unpacked tensors equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import packing as jp
from apex_tpu_torch.ops import multi_tensor
from apex_tpu_torch.ops import packing as tp

RAGGED = [(3, 5), (7,), (), (2, 2, 3), (40,), (1,), (6, 4)]
DTYPES = ["float32", "bfloat16", "float16"]


def _arrays(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(np.array(a, np.float32).reshape(a.shape))
             .to(getattr(torch, dtype)) for a in arrays])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _same_meta(got, want):
    assert got.shapes == tuple(tuple(s) for s in want.shapes)
    for f in got._fields:
        if f not in ("shapes", "dtype"):
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_and_unpack_match_jax(dtype, chunk):
    js, ts = _both(_arrays(RAGGED), dtype)
    want, wmeta = jp.pack(js, chunk)
    got, gmeta = tp.pack(ts, chunk)
    _same_meta(gmeta, wmeta)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))
    for g, w in zip(tp.unpack(got, gmeta), jp.unpack(want, wmeta)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_aligned_matches_jax(dtype, chunk):
    js, ts = _both(_arrays(RAGGED), dtype)
    want, wmeta = jp.pack_aligned(js, chunk)
    got, gmeta = tp.pack_aligned(ts, chunk)
    _same_meta(gmeta, wmeta)
    np.testing.assert_array_equal(_np(got), _np(want))
    js2, ts2 = _both(_arrays(RAGGED, seed=1), dtype)
    np.testing.assert_array_equal(_np(tp.pack_into(ts2, gmeta)),
                                  _np(jp.pack_into(js2, wmeta)))
    for g, w in zip(tp.unpack_aligned(got, gmeta),
                    jp.unpack_aligned(want, wmeta)):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert tp.aligned_chunk_count(tp.leaf_sizes(ts), chunk) \
        == jp.aligned_chunk_count(jp.leaf_sizes(js), chunk) \
        == len(gmeta.chunk_ids)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_host_pack_matches_jax(dtype):
    arrays = [a.astype(dtype) for a in _arrays(RAGGED)]
    want, wmeta = jp.host_pack(arrays)
    got, gmeta = tp.host_pack(arrays)
    _same_meta(gmeta, wmeta)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for g, w in zip(tp.host_unpack(got, gmeta), jp.host_unpack(want, wmeta)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="single dtype"):
        tp.host_pack([arrays[0], arrays[1].astype(np.float64)])


def test_geometry_and_reexports():
    for n in (0, 1, 8191, 8192, 8193, 100000):
        assert tp.streaming_pad(n) == jp.streaming_pad(n)
        assert tp.round_up(n, 7) == jp.round_up(n, 7)
    assert (tp.STREAM_LANES, tp.STREAM_TILE_ROWS) == (jp.STREAM_LANES,
                                                      jp.STREAM_TILE_ROWS)
    assert tp.group_by_dtype is multi_tensor.group_by_dtype
    js, ts = _both(_arrays(RAGGED[:3]), "float32")
    mixed = ts + [t.to(torch.bfloat16) for t in ts]
    jmixed = js + [j.astype(jnp.bfloat16) for j in js]
    assert list(tp.group_by_dtype(mixed).values()) \
        == list(jp.group_by_dtype(jmixed).values())
