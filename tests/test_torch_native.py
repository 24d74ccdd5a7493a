"""The port's native host runtime (``apex_tpu_torch/_native.py`` over
``apex_tpu_torch/csrc/host_runtime.cpp``) against the JAX package's
``apex_tpu._native`` and against its own plain (numpy) versions, on
arrays made from a numpy seed: flatten, unflatten, bucket planning and
the FNV-1a digest, bit for bit; and the two call sites that use it
(``parallel.distributed.plan_buckets``, ``ops.packing.host_pack`` /
``host_unpack``)."""

import threading

import numpy as np
import pytest

from apex_tpu import _native as jax_native
from apex_tpu_torch import _native
from apex_tpu_torch.ops import packing
from apex_tpu_torch.parallel import distributed


def _arrays(seed, dtype, big=False):
    rng = np.random.default_rng(seed)
    shapes = [(3, 5), (7,), (), (2, 1, 4)] + ([(512, 1024)] if big else [])
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64])
@pytest.mark.parametrize("big", [False, True])   # 2 MiB: the threaded copy
def test_flatten_and_unflatten_equal_jax_and_plain(dtype, big):
    arrays = _arrays(3, dtype, big)
    flat = _native.flatten(arrays)
    assert flat.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(flat, _native.flatten_plain(arrays))
    np.testing.assert_array_equal(flat, jax_native.flatten(arrays))
    shapes = [a.shape for a in arrays]
    for got, plain, jax_, a in zip(_native.unflatten(flat, shapes),
                                   _native.unflatten_plain(flat, shapes),
                                   jax_native.unflatten(flat, shapes),
                                   arrays):
        assert got.shape == a.shape
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(plain, a)
        np.testing.assert_array_equal(jax_, a)


def test_flatten_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="single dtype"):
        _native.flatten([np.zeros(2, np.float32), np.zeros(2, np.float64)])
    with pytest.raises(ValueError, match="at least one"):
        _native.flatten([])
    with pytest.raises(ValueError, match="shapes"):
        _native.unflatten(np.zeros(5, np.float32), [(2, 2)])


@pytest.mark.parametrize("message", [1, 7, 100, 10_000_000])
def test_plan_buckets_equals_jax_and_plain(message):
    rng = np.random.default_rng(message)
    numels = rng.integers(1, 60, size=41).tolist()
    triggers = (rng.random(41) < 0.1).tolist()
    for trig in (None, triggers):
        got = _native.plan_buckets(numels, message, trig)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(
            got, _native.plan_buckets_plain(numels, message, trig))
        np.testing.assert_array_equal(
            got, jax_native.plan_buckets(numels, message, trig))
        np.testing.assert_array_equal(
            got, distributed.plan_buckets(numels, message, trig))
    with pytest.raises(ValueError, match="triggers"):
        _native.plan_buckets([1, 2], 3, [True])


def test_fingerprint64_equals_jax_and_plain():
    rng = np.random.default_rng(11)
    for data in (b"", b"abc", rng.standard_normal(97).astype(np.float32),
                 rng.integers(0, 255, size=(5, 3), dtype=np.uint8)):
        for seed in (0, 12345):
            got = _native.fingerprint64(data, seed)
            assert got == _native.fingerprint64_plain(data, seed)
            assert got == jax_native.fingerprint64(data, seed)


def test_host_pack_goes_through_the_native_runtime(monkeypatch):
    arrays = _arrays(5, np.float32)
    calls = []
    real = _native.flatten
    monkeypatch.setattr(_native, "flatten",
                        lambda a: calls.append(len(a)) or real(a))
    flat, meta = packing.host_pack(arrays)
    assert calls == [len(arrays)]
    for got, a in zip(packing.host_unpack(flat, meta), arrays):
        np.testing.assert_array_equal(got, a)


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Builders racing on one name (test workers, a fleet's ranks): each
    compiles to a temporary name and renames it into place, so the path
    always holds a whole library."""
    import ctypes
    path = tmp_path / "libhost_runtime-race.so"
    errors = []

    def build():
        try:
            _native._build(path)
            assert ctypes.CDLL(str(path)).apex_native_abi_version() == 1
        except BaseException as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert _native.library_path().parent == _native.BUILD_DIR
