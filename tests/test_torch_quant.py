"""The port's fp8 / int8 functions (``apex_tpu_torch.quant``) and amp O4
(policy, the fp8 tables, the op layer's fp8 path, the train step)
against the JAX package's (``apex_tpu.quant``, ``apex_tpu.amp``), on the
CPU.

Tolerances:

- every fp8 / int8 function of ``quant``, the delayed-scaling
  transitions and the gradients of ``qdq_ste`` / ``bwd_qdq``: bit for bit
  (IEEE elementwise ops in the same order), on inputs holding halfway
  points, subnormals, the saturating edges, zero vectors and non-finite
  values; ``scaled_matmul`` within 1e-6 relative (a product: the two
  frameworks sum in other orders; JAX's own test holds it so);
- the MLP of ``tests/l0/test_quant.py`` at O4, 6 steps: losses within
  2e-3 (measured 1.1e-3), the three scales and amax histories within
  2**-8 relative (measured equal), the masters within 1e-4 (measured
  3.3e-5 at lr 1e-3);
- gpt_tiny at O4 from seeded weights, 3 steps, plain and with
  ``accum_steps=2``: losses within 2e-2 (the bf16 O2 bound of
  ``tests/test_torch_train.py``; measured 9.1e-3, at the first step,
  which both quantize at unit scales), ``fp8_rescales`` equal, the
  weight class's scale and history within 2**-7 relative (measured
  equal: the bf16 weights are the same), the input class's within 2**-5
  (measured 1.2e-2) and the grad class's within 2**-3 (measured equal
  here, 5.2e-2 from JAX's initialisation of the same model), the masters
  within Adam's drift bound (measured 1.74e-2 of 1.80e-2: tiny
  gradients of opposite signs).  The port rotates q / k with bf16 tables
  where JAX's CPU path rotates in fp32 (``tests/test_torch_train.py``);
  a one-ulp bf16 difference of an operand becomes a one-ulp e4m3
  difference (2**-3 relative) where it flips a rounding, so losses and
  maxima drift further apart than at O2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp import lists as jax_lists
from apex_tpu.amp import ops as jax_ops
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_cross_entropy
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.quant import fp8 as jfp8
from apex_tpu.quant import int8 as jint8
from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp import ops as ops
from apex_tpu_torch.convert import (mlp_params_from_jax, params_from_jax,
                                    params_to_numpy)
from apex_tpu_torch.models import GPTConfig, GPTModel, gpt_tiny, lm_loss
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.quant import fp8, int8

FORMATS = [(fp8.FP8_E4M3, jfp8.FP8_E4M3), (fp8.FP8_E5M2, jfp8.FP8_E5M2)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    """An array's bytes, for bitwise comparison (fp8 and bf16 included)."""
    a = a.detach() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.view(torch.int16 if a.element_size() == 2
                        else torch.int32).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


def _same(got, want):
    """Bit for bit, NaN payloads aside (a NaN equals a NaN)."""
    g, w = _bits(got), _bits(want)
    gn = np.isnan(got.detach().float().numpy())
    wn = np.isnan(np.asarray(want).astype(np.float32))
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(g[~wn], w[~wn])


def _edges(n=4096, seed=0):
    """fp32 values over many magnitudes, with the edges: zeros of both
    signs, the fp8 maxima and just past them, halfway points of the e4m3
    grid near 1, fp32 subnormals, infinities and a NaN."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * rng.choice(
        np.float32([1e-7, 1e-4, 1e-2, 1, 30, 500, 3e4, 1e5]), n)
    x[:20] = [0.0, -0.0, 448.0, -448.0, 464.0, 57344.0, -61440.0,
              1.0625, 1.1875, -1.3125, 2.0 ** -9, 2.0 ** -10, 2.0 ** -17,
              1e-40, -1e-45, np.inf, -np.inf, np.nan, 3e38, -3e38]
    return x


@pytest.mark.parametrize("scale", [1.0, 0.37, 2.0 ** -7, 1536.0])
@pytest.mark.parametrize("fmt", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_quantize_dequantize_qdq_are_jaxs_bitwise(dtype, fmt, scale):
    tdt, jdt = FORMATS[fmt]
    x32 = _edges(seed=fmt)
    jx = jnp.asarray(x32).astype(dtype)
    tx = _t(x32).to(getattr(torch, dtype))
    js, ts = jnp.float32(scale), torch.tensor(scale, dtype=torch.float32)
    jq, tq = jfp8.quantize(jx, js, jdt), fp8.quantize(tx, ts, tdt)
    assert tq.dtype == tdt
    _same(tq, jq)
    _same(fp8.dequantize(tq, ts), jfp8.dequantize(jq, js))
    _same(fp8.dequantize(tq, ts, torch.bfloat16),
          jfp8.dequantize(jq, js, jnp.bfloat16))
    tqdq = fp8.qdq(tx, ts, tdt)
    assert tqdq.dtype == tx.dtype
    _same(tqdq, jfp8.qdq(jx, js, jdt))
    np.testing.assert_array_equal(_bits(fp8.tensor_amax(tx[20:])),
                                  _bits(jfp8.tensor_amax(jx[20:])))
    assert fp8.fp8_max(tdt) == jfp8.fp8_max(jdt)


def test_fp8_max_refuses_other_dtypes():
    with pytest.raises(ValueError, match="not an fp8 dtype"):
        fp8.fp8_max(torch.bfloat16)


@pytest.mark.parametrize("margin", [0, 2])
def test_delayed_scaling_transitions_are_jaxs_bitwise(margin):
    """Rolls of amaxes that are finite, zero, infinite, NaN, subnormal
    and huge through a 4-deep window; the derived scales, the train
    state's update, its saturation and its rescale count."""
    js = jfp8.init_delayed_scaling(4)
    ts = fp8.init_delayed_scaling(4, device="cpu")
    for a in (2.0, np.inf, 8.0, np.nan, 1e-40, 3e38, 5.0, 0.0, 0.25):
        js = jfp8.record_amax(js, jnp.float32(a), jfp8.FP8_E5M2, margin)
        ts = fp8.record_amax(ts, torch.tensor(a, dtype=torch.float32),
                             fp8.FP8_E5M2, margin)
        np.testing.assert_array_equal(_bits(ts.amax_history),
                                      _bits(js.amax_history))
        np.testing.assert_array_equal(_bits(ts.scale), _bits(js.scale))
        np.testing.assert_array_equal(
            _bits(fp8.delayed_scale(ts, fp8.FP8_E4M3, margin)),
            _bits(jfp8.delayed_scale(js, jfp8.FP8_E4M3, margin)))
    jt = jfp8.init_train_state(3)
    tt = fp8.init_train_state(3, device="cpu")
    for amaxes in ((1.0, 0.5, 0.01), (64.0, 0.5, np.inf), (3.0, 0.7, 0.02),
                   (np.nan, 0.7, 1e-3)):
        ja = [jnp.float32(a) for a in amaxes]
        ta = [torch.tensor(a, dtype=torch.float32) for a in amaxes]
        np.testing.assert_array_equal(
            _bits(fp8.step_saturation(tt, *ta, margin=margin)),
            _bits(jfp8.step_saturation(jt, *ja, margin=margin)))
        jn = jfp8.update_train_state(jt, *ja, margin=margin)
        tn = fp8.update_train_state(tt, *ta, margin=margin)
        assert int(fp8.rescale_events(tt, tn)) == \
            int(jfp8.rescale_events(jt, jn))
        assert fp8.rescale_events(tt, tn).dtype == torch.int32
        jt, tt = jn, tn
        for j, t in zip(jt, tt):
            np.testing.assert_array_equal(_bits(t.amax_history),
                                          _bits(j.amax_history))
            np.testing.assert_array_equal(_bits(t.scale), _bits(j.scale))
    assert fp8.Fp8TrainState._fields == jfp8.Fp8TrainState._fields
    assert fp8.DelayedScalingState._fields == \
        jfp8.DelayedScalingState._fields
    with pytest.raises(ValueError, match="history_len"):
        fp8.init_delayed_scaling(0, device="cpu")


def test_tree_amax_is_jaxs():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    b = (rng.standard_normal(9) * 40).astype(np.float32)
    ints = np.arange(6, dtype=np.int32) * 1000
    jt = {"a": jnp.asarray(a), "b": [jnp.asarray(b).astype(jnp.bfloat16),
                                     jnp.asarray(ints)]}
    tt = {"a": _t(a), "b": [_t(b).bfloat16(), _t(ints)]}
    np.testing.assert_array_equal(_bits(fp8.tree_amax(tt)),
                                  _bits(jfp8.tree_amax(jt)))
    a[2, 3] = np.nan
    assert np.isnan(float(fp8.tree_amax({"a": _t(a), "b": _t(b)})))
    assert np.isnan(float(jfp8.tree_amax({"a": jnp.asarray(a)})))
    assert float(fp8.tree_amax({"i": _t(ints)}, device="cpu")) == 0.0


@pytest.mark.parametrize("shape", [(16, 32, 8), (3, 5, 40, 24)])
def test_scaled_matmul_matches_jax(shape):
    *lead, k, n = shape
    rng = np.random.default_rng(4)
    x = rng.standard_normal(tuple(lead) + (k,)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    sx, sw = 64.0, 128.0
    want = np.asarray(jfp8.scaled_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.float32(sx), jnp.float32(sw),
        out_dtype=jnp.float32))
    got = fp8.scaled_matmul(_t(x), _t(w), torch.tensor(sx),
                            torch.tensor(sw), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert fp8.scaled_matmul(_t(x).bfloat16(), _t(w), torch.tensor(sx),
                             torch.tensor(sw)).dtype == torch.bfloat16


def test_qdq_ste_and_bwd_qdq_gradients_are_jaxs():
    """``qdq_ste``: the cotangent passes unrounded, the scale gets zero;
    ``bwd_qdq``: identity forward, the cotangent rounded onto e5m2."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(64).astype(np.float32)
    cot = (rng.standard_normal(64) * 3).astype(np.float32)
    cot[:4] = [1e-9, 65536.0, -1e6, 0.0]
    for s in (8.0, 2.0 ** -5):
        jgx, jgs = jax.grad(lambda v, sc: jnp.sum(
            jfp8.qdq_ste(v, sc) * jnp.asarray(cot)), argnums=(0, 1))(
                jnp.asarray(x), jnp.float32(s))
        tx = _t(x).requires_grad_()
        ts = torch.tensor(s, requires_grad=True)
        y = fp8.qdq_ste(tx, ts)
        np.testing.assert_array_equal(_bits(y),
                                      _bits(jfp8.qdq(jnp.asarray(x),
                                                     jnp.float32(s))))
        (y * _t(cot)).sum().backward()
        np.testing.assert_array_equal(_bits(tx.grad), _bits(jgx))
        assert float(ts.grad) == float(jgs) == 0.0

        _, vjp = jax.vjp(lambda v: jfp8.bwd_qdq(v, jnp.float32(s)),
                         jnp.asarray(x))
        (jg,) = vjp(jnp.asarray(cot))
        tx = _t(x).requires_grad_()
        y = fp8.bwd_qdq(tx, torch.tensor(s))
        assert torch.equal(y, _t(x))
        y.backward(_t(cot))
        np.testing.assert_array_equal(_bits(tx.grad), _bits(jg))
        assert not np.array_equal(tx.grad.numpy(), cot)


def test_resolve_o4_is_jaxs_and_the_fp8_lists_are_jaxs():
    want, got = jax_amp.resolve("O4"), amp.resolve("O4")
    assert got.fp8 and got.opt_level == "O4" and got.cast_ops
    assert got.use_master_weights and got.is_dynamic_loss_scale
    assert got.fp8_dtype_fwd == torch.float8_e4m3fn
    assert got.fp8_dtype_bwd == torch.float8_e5m2
    assert (got.fp8_amax_history_len, got.fp8_margin) == \
        (want.fp8_amax_history_len, want.fp8_margin)
    assert amp.O4() == got and amp.opt_levels["O4"] is amp.O4
    with pytest.raises(ValueError, match="fp8_amax_history_len"):
        amp.resolve("O4", fp8_amax_history_len=0)
    with pytest.raises(ValueError, match="O4"):
        amp.resolve("O5")
    assert lists.FP8_OPS == jax_lists.FP8_OPS
    assert lists.FP8_DENY_OPS == jax_lists.FP8_DENY_OPS
    assert not set(lists.FP8_OPS) & set(lists.FP8_DENY_OPS)


def test_prelu_is_denied_and_a_contraction_quantizes():
    """Under a live O4 trace ``prelu`` (a half op in FP8_DENY_OPS) keeps
    the plain bf16 cast and records no amax; ``matmul`` and ``linear``
    (the bias half-cast, not quantized) record one input and one weight
    amax each and give JAX's bits."""
    p4, jp4 = amp.resolve("O4"), jax_amp.resolve("O4")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    st, jst = fp8.init_train_state(4, device="cpu"), jfp8.init_train_state(4)
    st = st._replace(input=st.input._replace(scale=torch.tensor(64.0)))
    jst = jst._replace(input=jst.input._replace(scale=jnp.float32(64.0)))
    with ops.cast_context(p4), ops.fp8_trace(st) as tr:
        got = ops.prelu(_t(x), torch.tensor(0.25))
        assert not tr.amaxes["input"] and not tr.amaxes["weight"]
        lin = ops.linear(_t(x), _t(w), _t(b))
        mm = ops.matmul(_t(x), _t(w))
        assert len(tr.amaxes["input"]) == len(tr.amaxes["weight"]) == 2
        amaxes = ops.collected_fp8_amaxes(tr)
    with jax_ops.cast_context(jp4), jax_ops.fp8_trace(jst) as jtr:
        want = jax_ops.prelu(jnp.asarray(x), jnp.float32(0.25))
        jlin = jax_ops.linear(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b))
        jmm = jax_ops.matmul(jnp.asarray(x), jnp.asarray(w))
        jamaxes = jax_ops.collected_fp8_amaxes(jtr)
    assert got.dtype == lin.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_allclose(lin.float().numpy(),
                               np.asarray(jlin, np.float32),
                               rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(mm.float().numpy(),
                               np.asarray(jmm, np.float32),
                               rtol=2.0 ** -7, atol=0)
    for a, ja in zip(amaxes, jamaxes):
        np.testing.assert_array_equal(_bits(a), _bits(ja))


def test_o4_bare_run_degrades_to_half_cast():
    """``Amp.run`` under O4 with no open trace: the contractions take
    the plain bf16 cast, as in O2 with the op layer on."""
    model = _mlp_model()
    a = amp.initialize(model, FusedAdam(model.parameters(), device="cpu"),
                       opt_level="O4", device="cpu")
    x, y = _mlp_batch()
    out = a.run(lambda m, xb, yb: cross_entropy_loss(m(xb), yb), model,
                _t(x), _t(y).long())
    assert out.dtype == torch.float32 and np.isfinite(float(out))
    assert a.fp8_state is not None and a.fp8_state.input.scale.device == \
        torch.device("cpu")


# -- O4 train steps against JAX's ------------------------------------------

def _mlp_batch():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 28, 28, 1),
                                     jnp.float32))
    return x, np.asarray([0, 1, 2, 3], np.int32)


@functools.lru_cache(maxsize=None)
def _mlp_params():
    x, _ = _mlp_batch()
    return JaxMLP(features=(32,)).init(jax.random.PRNGKey(0),
                                       jnp.asarray(x))["params"]


def _mlp_model(params=None):
    params = _mlp_params() if params is None else params
    return mlp_params_from_jax(jax.tree.map(np.asarray, params),
                               features=(32,), device="cpu", trainable=True)


def _fp8_record(state):
    """``[(amax_history, scale)]`` of each class, as numpy / float."""
    return [(np.array(h, np.float32), float(np.asarray(s)))
            for h, s in state]


def _jax_o4(params, loss_fn, batch, steps, accum_steps=None, lr=1e-3):
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=lr), opt_level="O4",
                           verbosity=0)
    state = a.init(params)
    step = jax.jit(jax_amp.make_train_step(a, loss_fn,
                                           accum_steps=accum_steps))
    out = []
    for _ in range(steps):
        state, m = step(state, *batch)
        out.append(dict(loss=float(m["loss"]),
                        rescales=int(m["fp8_rescales"]),
                        fp8=_fp8_record(state.fp8_state)))
    return out, jax.tree.map(np.asarray, state.master_params)


def _torch_o4(model, loss_fn, batch, steps, accum_steps=None, lr=1e-3):
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=lr,
                                        device="cpu"),
                       opt_level="O4", device="cpu")
    step = amp.make_train_step(a, model, loss_fn, accum_steps=accum_steps)
    out = []
    for _ in range(steps):
        m = step(*batch)
        assert m["fp8_rescales"].dtype == torch.int32
        assert m["fp8_amax_saturation"].dtype == torch.float32
        out.append(dict(loss=float(m["loss"]),
                        rescales=int(m["fp8_rescales"]),
                        fp8=_fp8_record(a.fp8_state)))
    return out, params_to_numpy(a.masters)


def _compare_fp8(got, want, rtols):
    for (gh, gs), (wh, ws), rtol in zip(got, want, rtols):
        np.testing.assert_allclose(gh, wh, rtol=rtol, atol=0)
        assert abs(gs - ws) <= rtol * abs(ws), (gs, ws)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_o4_mlp_steps_match_jax():
    params = _mlp_params()
    jm = JaxMLP(features=(32,))
    x, y = _mlp_batch()
    want, jmasters = _jax_o4(
        params, lambda p, xb, yb: jax_cross_entropy(
            jm.apply({"params": p}, xb), yb),
        (jnp.asarray(x), jnp.asarray(y)), 6)
    got, masters = _torch_o4(
        _mlp_model(params), lambda m, xb, yb: cross_entropy_loss(m(xb), yb),
        (_t(x), _t(y).long()), 6)
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 2e-3, (got, want)
        assert g["rescales"] == w["rescales"]
        _compare_fp8(g["fp8"], w["fp8"], (2.0 ** -8,) * 3)
    assert got[-1]["loss"] < got[0]["loss"]
    assert got[-1]["fp8"][0][1] != 1.0          # the scales moved off 1
    for path, w in _leaves(jmasters):
        np.testing.assert_allclose(dict(_leaves(masters))[path], w,
                                   atol=1e-4, rtol=0, err_msg=str(path))


def _adam_drift_bound(steps, lr, betas=(0.9, 0.999)):
    """Twice the sum over steps of Adam's largest update (the bound of
    ``tests/test_torch_checkpoint.py``)."""
    b1, b2 = betas
    total = 0.0
    for t in range(1, steps + 1):
        w1 = [(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)]
        w2 = [(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)]
        total += (sum(a * a / b for a, b in zip(w1, w2)) * sum(w2)) ** 0.5 \
            / sum(w1)
    return 2.0 * lr * total


GPT_STEPS, GPT_LR = 3, 3e-3


@pytest.fixture(scope="module")
def gpt_case():
    """gpt_tiny's seeded port weights as a JAX tree, a (4, 32) stream."""
    cfg = gpt_tiny()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tree = params_to_numpy(GPTModel(cfg, device="cpu"))
    rng = np.random.RandomState(0)
    ids = ((rng.randint(0, cfg.vocab_size, (4, 1)) + np.arange(32)[None])
           % cfg.vocab_size).astype(np.int32)
    return cfg, tree, ids


@pytest.mark.parametrize("accum_steps", [None, 2])
def test_o4_gpt_tiny_steps_match_jax(gpt_case, accum_steps):
    cfg, tree, ids = gpt_case
    jm = JaxGPT(JaxConfig(vocab_size=cfg.vocab_size,
                          hidden_size=cfg.hidden_size,
                          num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                          intermediate_size=cfg.intermediate_size))
    want, jmasters = _jax_o4(
        tree, lambda p, x: jax_lm_loss(jm.apply({"params": p}, x)[:, :-1],
                                       x[:, 1:]),
        (jnp.asarray(ids),), GPT_STEPS, accum_steps, GPT_LR)
    got, masters = _torch_o4(
        params_from_jax(tree, cfg, device="cpu", trainable=True),
        lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]),
        (torch.from_numpy(ids).long(),), GPT_STEPS, accum_steps, GPT_LR)
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 2e-2, (got, want)
        assert g["rescales"] == w["rescales"]
        _compare_fp8(g["fp8"], w["fp8"], (2.0 ** -5, 2.0 ** -7, 2.0 ** -3))
    assert got[-1]["loss"] < got[0]["loss"]
    drift = _adam_drift_bound(GPT_STEPS, GPT_LR)
    got_m = dict(_leaves(masters))
    for path, w in _leaves(jmasters):
        np.testing.assert_allclose(got_m[path], w, atol=drift, rtol=0,
                                   err_msg=str(path))


# -- the port's O4 step on its own -----------------------------------------

def _poisoned_mlp_loss(m, xb, yb, poison):
    return cross_entropy_loss(m(xb), yb) * (1.0 + poison.sum())


def test_an_overflowed_o4_step_is_skipped_and_still_rolls_the_history():
    """An inf in the loss: the masters and moments stay and the scale
    halves, while all three histories roll; the grad class records 0 and
    the forward classes their finite amaxes."""
    model = _mlp_model()
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-3,
                                        device="cpu"),
                       opt_level="O4", device="cpu")
    step = amp.make_train_step(a, model, _poisoned_mlp_loss)
    x, y = _t(_mlp_batch()[0]), _t(_mlp_batch()[1]).long()
    clean = torch.zeros(4)
    step(x, y, clean)
    before = {n: t.clone() for n, t in a.masters.items()}
    hist = [c.amax_history.clone() for c in a.fp8_state]
    scale = float(a.scaler_state.loss_scale)
    m = step(x, y, torch.tensor([0.0, float("inf"), 0.0, 0.0]))
    assert bool(m["overflow"])
    assert float(m["loss_scale"]) == scale / 2
    assert all(torch.equal(before[n], t) for n, t in a.masters.items())
    for h, c in zip(hist, a.fp8_state):
        assert torch.equal(c.amax_history[1:], h[:-1])
    assert float(a.fp8_state.grad.amax_history[0]) == 0.0
    assert float(a.fp8_state.input.amax_history[0]) > 0.0
    assert float(a.fp8_state.weight.amax_history[0]) > 0.0
    assert np.isfinite(float(m["fp8_amax_saturation"]))


def test_o4_remat_recomputes_on_the_same_fp8_grids():
    """``remat`` under O4: the recompute in the backward quantizes at the
    forward's scales (the trace's scales ride into it), so the step equals
    the step without remat bit for bit, and records each call's amaxes
    once."""
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, intermediate_size=64)
    ids = torch.arange(2 * 16).reshape(2, 16) % 64
    runs = []
    for remat in (False, True):
        c = GPTConfig(**{**cfg.__dict__, "remat": remat})
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            model = GPTModel(c, device="cpu")
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-3,
                                            device="cpu"),
                           opt_level="O4", device="cpu")
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
        losses = [float(step(ids)["loss"]) for _ in range(2)]
        runs.append((losses, [t.clone() for t in a.masters.values()],
                     [c.amax_history.clone() for c in a.fp8_state]))
    (l0, m0, h0), (l1, m1, h1) = runs
    assert l0 == l1
    assert all(torch.equal(x, y) for x, y in zip(m0, m1))
    assert all(torch.equal(x, y) for x, y in zip(h0, h1))
