"""The port's legacy loss scalers (``apex_tpu_torch.fp16_utils.
loss_scaler``) against the JAX package's ``apex_tpu.fp16_utils.
loss_scaler``: the scale sequences under a planted overflow pattern
(equal), the overflow scan (K15's plain version here) on mixed leaves,
and the scaled gradients (fp32, within 2e-5 of the largest element:
XLA's and PyTorch's ``tanh`` and products differ by a few ulps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.fp16_utils import DynamicLossScaler as JaxDynamic
from apex_tpu.fp16_utils import LossScaler as JaxStatic
from apex_tpu_torch.fp16_utils import DynamicLossScaler, LossScaler

PATTERN = [False, False, True, False, False, False, False, True, True,
           False, False, False, False, False, False, True, False]


@pytest.mark.parametrize("kw", [{}, dict(init_scale=8.0, scale_window=3),
                                dict(init_scale=2.0, scale_factor=4.0,
                                     scale_window=2)],
                         ids=["defaults", "window3", "factor4"])
def test_dynamic_scale_sequence_matches_jax(kw):
    ours, ref = DynamicLossScaler(**kw), JaxDynamic(**kw)
    got, want = [], []
    for overflow in PATTERN:
        ours.update_scale(overflow)
        ref.update_scale(overflow)
        got.append((ours.loss_scale, ours.cur_iter, ours.last_overflow_iter))
        want.append((ref.loss_scale, ref.cur_iter, ref.last_overflow_iter))
    assert got == want
    assert DynamicLossScaler().loss_scale == 2.0 ** 32


def test_the_scale_never_falls_below_one():
    ours, ref = DynamicLossScaler(init_scale=4.0), JaxDynamic(init_scale=4.0)
    for _ in range(5):
        ours.update_scale(True)
        ref.update_scale(True)
        assert ours.loss_scale == ref.loss_scale
    assert ours.loss_scale == 1.0


def test_static_scaler_never_moves():
    ours, ref = LossScaler(128.0), JaxStatic(128.0)
    for overflow in PATTERN:
        ours.update_scale(overflow)
        ref.update_scale(overflow)
        assert ours.loss_scale == ref.loss_scale == 128.0
    assert ours.has_overflow([torch.tensor([float("inf")])]) is False


def _leaves(poison=None):
    rng = np.random.RandomState(0)
    out = [rng.standard_normal((3, 5)).astype(np.float32),
           rng.standard_normal((7,)).astype(np.float32),
           rng.standard_normal((2, 4)).astype(np.float32)]
    if poison is not None:
        i, j, v = poison
        out[i].reshape(-1)[j] = v
    return out


@pytest.mark.parametrize("poison", [None, (0, 0, np.inf), (1, 6, np.nan),
                                    (2, 3, -np.inf)],
                         ids=["finite", "inf_first", "nan_last", "ninf_mid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_has_overflow_matches_jax(poison, dtype):
    arrays = _leaves(poison)
    jdt = getattr(jnp, dtype)
    want = JaxDynamic().has_overflow([jnp.asarray(a, jdt) for a in arrays])
    tdt = getattr(torch, dtype)
    got = DynamicLossScaler().has_overflow(
        [torch.from_numpy(a).to(tdt) for a in arrays] + [None])
    assert got is bool(want) is (poison is not None)


def test_has_overflow_skips_integer_leaves_and_empty_lists():
    s = DynamicLossScaler()
    assert s.has_overflow([]) is False
    assert s.has_overflow([torch.arange(4), torch.ones(3)]) is False


def test_scaled_gradients_match_jax():
    w = _leaves()[0]
    x = np.random.RandomState(1).standard_normal((4, 3)).astype(np.float32)
    ref = JaxDynamic(init_scale=1024.0)
    want = ref.backward(lambda p, xb: jnp.sum(jnp.tanh(xb @ p) ** 2),
                        jnp.asarray(w), jnp.asarray(x))
    ours = DynamicLossScaler(init_scale=1024.0)
    p = torch.from_numpy(w.copy()).requires_grad_(True)
    ours.backward((torch.tanh(torch.from_numpy(x) @ p) ** 2).sum())
    want = np.asarray(want)
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    scaled = ours.scale_gradient([p.grad])
    want2 = ref.scale_gradient([jnp.asarray(p.grad.numpy())])
    np.testing.assert_array_equal(scaled[0].numpy(), np.asarray(want2[0]))
