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
          "half_dtype", "cast_model_outputs", "fp8", "fp8_dtype_fwd",
          "fp8_dtype_bwd", "fp8_amax_history_len", "fp8_margin")


def _dtype_name(d):
    if d is None:
        return None
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("overrides", [
    {}, {"loss_scale": 128.0}, {"keep_batchnorm_fp32": "False"},
    {"cast_model_dtype": False}, {"master_weights": True}])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4"])
def test_resolve_matches_jax_properties(level, overrides):
    want = jax_policy.resolve(level, **overrides)
    got = resolve(level, **overrides)
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if f.endswith("dtype") or f.endswith("_fwd") or \
                f.endswith("_bwd") or f == "cast_model_outputs":
            w, g = _dtype_name(w), _dtype_name(g)
        assert w == g, f
    assert want.fp8 == (level == "O4")
    assert got.use_master_weights == want.use_master_weights
    assert got.is_dynamic_loss_scale == want.is_dynamic_loss_scale


def test_o4_and_unknown_levels_are_refused():
    """O4 resolves to the JAX package's properties (fp8 training); an
    unknown level is refused, naming O4 among the options as JAX's
    message does."""
    want, got = jax_policy.resolve("O4"), resolve("O4")
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if f.endswith("dtype") or f.endswith("_fwd") or \
                f.endswith("_bwd") or f == "cast_model_outputs":
            w, g = _dtype_name(w), _dtype_name(g)
        assert w == g, f
    assert got.fp8 and got.fp8_dtype_fwd == torch.float8_e4m3fn \
        and got.fp8_dtype_bwd == torch.float8_e5m2
    with pytest.raises(ValueError, match="optimization level.*O4"):
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


#: a gradient tree mixing bf16 and fp32 leaves of odd sizes (none a
#: multiple of 8), one above a chunk of 65536 elements
TREE = [((3, 5), "bf16"), ((7,), "f32"), ((65537,), "bf16"), ((11, 91), "f32"),
        ((1,), "bf16"), ((333,), "f32")]


def _tree(seed, bad):
    rng = np.random.RandomState(seed)
    leaves = [(rng.standard_normal(s) * 3000).astype(np.float32)
              for s, _ in TREE]
    if bad:
        leaves[2][40000] = np.inf
        leaves[3][5, 6] = np.nan
    kinds = {"bf16": (torch.bfloat16, jnp.bfloat16),
             "f32": (torch.float32, jnp.float32)}
    ts = [torch.from_numpy(a.copy()).to(kinds[k][0])
          for a, (_, k) in zip(leaves, TREE)]
    js = [jnp.asarray(a).astype(kinds[k][1])
          for a, (_, k) in zip(leaves, TREE)]
    return ts, js


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("where", ["new", "kept_buffers", "in_place"])
def test_unscale_of_a_mixed_tree_matches_jax(where, bad):
    """``LossScaler.unscale`` (one K6 call over the whole list: its plain
    version here) against JAX's ``unscale`` on a mixed bf16 / fp32 tree
    with an inf in one leaf and a nan in another: every fp32 output bit
    for bit, the flag raised exactly when JAX's finite check fails; into
    new tensors, into kept fp32 buffers, and in place (fp32 leaves over
    themselves, as an fp32 list's unscale may run)."""
    ts, js = _tree(5, bad)
    jscaler, tscaler = JaxLossScaler(), LossScaler()
    jstate, tstate = jscaler.init_state(), tscaler.init_state()
    if where == "in_place":
        ts = [t.float() for t in ts]
        js = [j.astype(jnp.float32) for j in js]
        out = ts
    elif where == "kept_buffers":
        out = [torch.empty(t.shape) for t in ts]
    else:
        out = None
    jout, jfinite = jscaler.unscale(js, jstate)
    tout, flag = tscaler.unscale(ts, tstate, out=out)
    assert bool(jfinite) == (not bad) and int(flag[0]) == int(bad)
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t.dtype == torch.float32 and t.shape == ts[i].shape
        if out is not None:
            assert t is out[i]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


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


def test_o1_keeps_fp32_parameters_as_their_own_masters():
    """O1 casts no parameter: the masters are the parameters themselves
    (no copies for the optimizer to refresh), the gradient buffers fp32,
    and the optimizer holds the same tensors."""
    model = _Tiny(_params())
    opt = FusedAdam(model.parameters(), device="cpu")
    a = amp.initialize(model, opt, opt_level="O1", device="cpu")
    assert a.properties.cast_ops and a.properties.cast_model_dtype is None
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and a.masters[n] is p
    assert a._copies is None
    assert [t for g in opt.param_groups for t in g["params"]] == \
        list(model.parameters())
    assert all(b.dtype == torch.float32 for b in a.grad_buffers())


def test_the_default_opt_level_is_jaxs_o1_and_runs_as_jax():
    """``initialize`` defaults to O1, as the JAX package's does, and the
    default call runs: two O1 steps of a policy-cast linear layer (its
    product in bf16, the loss in fp32) land where JAX's do: losses within
    2**-8 relative (the frameworks round the bf16 product and sum at other
    places: measured 5.3e-4 relative), masters within 1e-4 (measured
    2.6e-5 after two Adam steps at lr 1e-2)."""
    import inspect
    from apex_tpu.amp import ops as jax_ops
    from apex_tpu_torch.amp import ops as ops
    default = inspect.signature(amp.initialize).parameters["opt_level"]
    jax_default = inspect.signature(jax_amp.initialize).parameters[
        "opt_level"]
    assert default.default == jax_default.default == "O1"
    p = _params()
    rng = np.random.RandomState(2)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2), verbosity=0)
    assert a.properties.opt_level == "O1"
    js = a.init(p)

    def jloss(params, x):
        y = jax_ops.linear(x, params["dense"]["kernel"],
                           params["dense"]["bias"])
        return jax_ops.mean(jnp.square(y.astype(jnp.float32))
                            * params["layernorm"]["scale"])

    jstep = jax.jit(jax_amp.make_train_step(a, jloss))
    model = _Tiny(p)
    t = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"), device="cpu")
    assert t.properties.opt_level == "O1"

    def tloss(m, x):
        y = ops.linear(x, m.dense.kernel, m.dense.bias)
        assert y.dtype == torch.bfloat16
        return ops.mean(y.float().square() * m.layernorm.scale)

    tstep = amp.make_train_step(t, model, tloss)
    for _ in range(2):
        js, jm = jstep(js, jnp.asarray(x))
        tm = tstep(torch.from_numpy(x))
        assert abs(float(jm["loss"]) - float(tm["loss"])) \
            <= 2.0 ** -8 * abs(float(jm["loss"]))
        assert float(jm["loss_scale"]) == float(tm["loss_scale"])
    for n, q in model.named_parameters():
        a_, b_ = n.split(".")
        np.testing.assert_allclose(q.detach().numpy(),
                                   np.asarray(js.master_params[a_][b_]),
                                   rtol=0, atol=1e-4)
