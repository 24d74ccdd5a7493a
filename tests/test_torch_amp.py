"""The port's amp (policy, loss scaler, ``Amp.apply_gradients``) against
the JAX package's ``apex_tpu.amp``.  Everything compared here is exact:
policies are data, the scaler moves by powers of two, and the unscale
multiplies by ``1 / scale`` in fp32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp import policy as jax_policy
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch.amp import LossScaler, all_finite, resolve
from apex_tpu_torch.optimizers import FusedAdam

FIELDS = ("enabled", "opt_level", "cast_model_dtype", "cast_ops",
          "keep_batchnorm_fp32", "master_weights", "loss_scale",
          "half_dtype", "cast_model_outputs")


def _dtype_name(d):
    if d is None:
        return None
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("overrides", [
    {}, {"loss_scale": 128.0}, {"keep_batchnorm_fp32": "False"},
    {"cast_model_dtype": False}, {"master_weights": True}])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_resolve_matches_jax_properties(level, overrides):
    want = jax_policy.resolve(level, **overrides)
    got = resolve(level, **overrides)
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if f.endswith("dtype") or f == "cast_model_outputs":
            w, g = _dtype_name(w), _dtype_name(g)
        assert w == g, f
    assert not want.fp8
    assert got.use_master_weights == want.use_master_weights
    assert got.is_dynamic_loss_scale == want.is_dynamic_loss_scale


def test_o4_and_unknown_levels_are_refused():
    with pytest.raises(NotImplementedError, match="O4"):
        resolve("O4")
    with pytest.raises(ValueError, match="optimization level"):
        resolve("O9")


@pytest.mark.parametrize("static", [False, True])
def test_scaler_trajectory_matches_jax(static):
    """A scripted overflow pattern through ``update``, with a window of 3
    so the scale also grows, and a floor the shrinking reaches."""
    kw = dict(scale_window=3, init_scale=8.0, min_loss_scale=2.0,
              max_loss_scale=32.0)
    if static:
        kw["loss_scale"] = 64.0
    js, ts = JaxLossScaler(**kw), LossScaler(**kw)
    jstate, tstate = js.init_state(), ts.init_state()
    pattern = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0]
    for ov in pattern:
        jstate, jov = js.update(jstate, jnp.asarray(not ov))
        tstate, tov = ts.update(tstate, torch.tensor(not ov))
        assert float(jstate.loss_scale) == float(tstate.loss_scale)
        assert int(jstate.unskipped) == int(tstate.unskipped)
        assert bool(jov) == bool(tov) == bool(ov)
        assert bool(js.pinned_at_floor(jstate)) == \
            bool(ts.pinned_at_floor(tstate))


def test_unscale_with_an_inf_leaf_matches_jax():
    rng = np.random.RandomState(0)
    leaves = [rng.standard_normal(s).astype(np.float32) * 1000
              for s in ((4, 3), (5,), (2, 2))]
    leaves[1][2] = np.inf
    jscaler, tscaler = JaxLossScaler(), LossScaler()
    jout, jfinite = jscaler.unscale(
        [jnp.asarray(a).astype(jnp.bfloat16) for a in leaves],
        jscaler.init_state())
    tout, flag = tscaler.unscale(
        [torch.from_numpy(a).to(torch.bfloat16) for a in leaves],
        tscaler.init_state())
    assert not bool(jfinite) and int(flag[0]) == 1
    assert not bool(all_finite([torch.from_numpy(a) for a in leaves]))
    for j, t in zip(jout, tout):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _, flag = tscaler.unscale([torch.ones(3, dtype=torch.bfloat16)],
                              tscaler.init_state())
    assert int(flag[0]) == 0


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.standard_normal((4, 3)).astype(
                np.float32),
                      "bias": rng.standard_normal(3).astype(np.float32)},
            "layernorm": {"scale": np.ones(3, np.float32)}}


class _Tiny(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.dense = torch.nn.Module()
        self.dense.kernel = torch.nn.Parameter(torch.from_numpy(
            p["dense"]["kernel"].copy()))
        self.dense.bias = torch.nn.Parameter(torch.from_numpy(
            p["dense"]["bias"].copy()))
        self.layernorm = torch.nn.Module()
        self.layernorm.scale = torch.nn.Parameter(torch.from_numpy(
            p["layernorm"]["scale"].copy()))


def test_injected_inf_skips_the_step_as_jax():
    """One good step, then gradients holding an inf: both skip it (masters
    and moments unchanged, step counts too) and halve the scale; under
    O2 the normalization-named leaf stays fp32."""
    p = _params()
    rng = np.random.RandomState(1)
    g1 = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), p)
    g2 = jax.tree.map(np.copy, g1)
    g2["dense"]["bias"][1] = np.inf

    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2), opt_level="O2",
                           verbosity=0)
    js = a.init(jax.tree.map(jnp.asarray, p))
    scale0 = float(js.scaler_states[0].loss_scale)

    def jgrads(g):
        # gradients w.r.t. the compute params, still scaled
        cp = a.model_params(js)
        return jax.tree.map(lambda x, c: (jnp.asarray(x) * scale0)
                            .astype(c.dtype), g, cp)

    js, jinfo1 = a.apply_gradients(js, jgrads(g1))
    jmid = jax.tree.map(np.asarray, (js.master_params, js.opt_state.m,
                                     js.opt_state.v))
    js, jinfo2 = a.apply_gradients(js, jgrads(g2))

    model = _Tiny(p)
    t = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level="O2", device="cpu")
    assert model.layernorm.scale.dtype == torch.float32
    assert model.dense.kernel.dtype == torch.bfloat16

    def tgrads(g):
        return [torch.from_numpy(g[n.split(".")[0]][n.split(".")[1]]
                                 * scale0).to(q.dtype)
                for n, q in model.named_parameters()]

    tinfo1 = t.apply_gradients(tgrads(g1))
    mid = {n: (m.clone(), t.optimizer.state[m]["exp_avg"].clone(),
               t.optimizer.state[m]["exp_avg_sq"].clone())
           for n, m in t.masters.items()}
    tinfo2 = t.apply_gradients(tgrads(g2))

    for ji, ti, ov in ((jinfo1, tinfo1, False), (jinfo2, tinfo2, True)):
        assert bool(ji["overflow"]) == bool(ti["overflow"]) == ov
        assert float(ji["loss_scale"]) == float(ti["loss_scale"])
    assert float(tinfo2["loss_scale"]) == scale0 / 2
    for n, m in t.masters.items():
        a_, b_ = n.split(".")
        st = t.optimizer.state[m]
        assert torch.equal(m, mid[n][0]), n
        assert torch.equal(st["exp_avg"], mid[n][1])
        assert torch.equal(st["exp_avg_sq"], mid[n][2])
        assert int(st["step"]) == 1
        np.testing.assert_allclose(m.numpy(), jmid[0][a_][b_], atol=1e-7,
                                   rtol=0)
        np.testing.assert_allclose(st["exp_avg"].numpy(), jmid[1][a_][b_],
                                   atol=1e-7, rtol=0)
    for n, q in model.named_parameters():
        assert torch.equal(q, t.masters[n].to(q.dtype)), n


def test_o1_cast_ops_is_refused_until_ported():
    model = _Tiny(_params())
    with pytest.raises(NotImplementedError, match="cast-ops"):
        amp.initialize(model, FusedAdam(model.parameters(), device="cpu"),
                       opt_level="O1", device="cpu")
