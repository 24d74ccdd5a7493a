"""The port's input pipeline (``apex_tpu_torch.data``) against the JAX
package's ``apex_tpu.data``: the synthetic loader's batches (equal),
``normalize_uint8`` (bit for bit against JAX's eager call: a
subtraction and an IEEE division in fp32; within one ulp of its jitted
call, whose division XLA turns into a product with the reciprocal), and
the order, lookahead and exhaustion of ``prefetch_to_device`` /
``DataPrefetcher`` (on the CPU, which the caller asks for; the card's
side stream runs in ``test_torch_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import data as jdata
from apex_tpu_torch import data as tdata


def test_constants_and_synthetic_loader_match_jax():
    assert tdata.IMAGENET_MEAN == jdata.IMAGENET_MEAN
    assert tdata.IMAGENET_STD == jdata.IMAGENET_STD
    got = list(tdata.host_synthetic_loader(6, 3, 8, seed=5))
    want = list(jdata.host_synthetic_loader(6, 3, 8, seed=5))
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.uint8
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_normalize_uint8_matches_jax_bitwise():
    x, y = next(tdata.host_synthetic_loader(1, 4, 16, seed=0))
    x = x.copy()
    x[0, 0, 0] = [0, 128, 255]
    got, gy = tdata.normalize_uint8((torch.from_numpy(x),
                                     torch.from_numpy(y)))
    want, wy = jdata.normalize_uint8((jnp.asarray(x), jnp.asarray(y)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def _stream(n):
    for i in range(n):
        yield (np.full((2, 3), i, np.int64), {"i": np.int32(i) + np.zeros(
            1, np.int32)})


@pytest.mark.parametrize("lookahead", [1, 2, 5])
@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_prefetch_order_and_exhaustion_match_jax(n, lookahead):
    got = list(tdata.prefetch_to_device(_stream(n), lookahead=lookahead,
                                        device="cpu"))
    want = list(jdata.prefetch_to_device(_stream(n), lookahead=lookahead))
    assert len(got) == len(want) == n
    for (gx, gd), (wx, wd) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gd["i"].numpy(), np.asarray(wd["i"]))


def test_lookahead_pulls_ahead():
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield np.asarray([i])

    gen = tdata.prefetch_to_device(source(), lookahead=2, device="cpu")
    first = next(gen)
    assert int(first[0]) == 0 and pulled == [0, 1, 2]
    assert [int(b[0]) for b in gen] == [1, 2, 3, 4]


def test_data_prefetcher_with_transform_matches_jax():
    loader = lambda: tdata.host_synthetic_loader(5, 2, 8, seed=3)
    pf = tdata.DataPrefetcher(loader(), transform=tdata.normalize_uint8,
                              device="cpu")
    jpf = jdata.DataPrefetcher(
        jdata.host_synthetic_loader(5, 2, 8, seed=3),
        transform=jdata.normalize_uint8)
    want_x = [x for x, _ in loader()]
    count = 0
    batch, want = pf.next(), jpf.next()
    while batch is not None:
        assert want is not None
        # JAX jits the transform, and XLA divides by multiplying with the
        # reciprocal: within one fp32 ulp of the IEEE quotient
        np.testing.assert_allclose(batch[0].numpy(), np.asarray(want[0]),
                                   rtol=2.0 ** -22, atol=0)
        np.testing.assert_array_equal(
            batch[0].numpy(), tdata.normalize_uint8(
                (torch.from_numpy(np.asarray(want_x.pop(0))), None))[0])
        np.testing.assert_array_equal(batch[1].numpy(), np.asarray(want[1]))
        count += 1
        batch, want = pf.next(), jpf.next()
    assert want is None and count == 5
    assert pf.next() is None


def test_bad_arguments_and_the_default_device():
    with pytest.raises(ValueError, match="lookahead"):
        tdata.prefetch_to_device(_stream(1), lookahead=0, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.prefetch_to_device(_stream(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DataPrefetcher(_stream(1))
