"""amp O1 of the port (``apex_tpu_torch.amp.ops`` / ``lists`` / ``handle``,
``Amp.run``'s cast context, the multi-loss pieces) against the JAX
package's ``apex_tpu.amp``, on the CPU.

Tolerances:

- The op layer: every op of the tables, under ``cast_context(O1)`` with
  bf16, fp16 and fp32 inputs, returns JAX's output dtype, and values
  within ``1e-5`` relative to the output's largest magnitude when it is
  fp32, ``2**-7`` (one bf16 ulp at that magnitude) when bf16, ``2**-10``
  when fp16: both sides cast the same inputs to the same dtype, then the
  frameworks round products and sums at other places.  Outside a cast
  context every op returns what its unwrapped function returns, bit for
  bit.
- MNIST MLP (BASELINE config 1: ``MLP((256, 256))``, B 256, O1,
  ``optax.sgd(0.05)`` against ``torch.optim.SGD(lr=0.05)``): per-step
  losses within ``1e-3`` over 7 steps (``BASELINE.md``'s harness bound);
  loss scale and overflow equal.
- gpt_tiny / d64 at O1 (FusedAdam lr 3e-3, 7 steps): per-step losses
  within ``2e-2`` (the O2 bound of ``tests/test_torch_train.py``: bf16
  products rounded at other places, and the port's attention rotates with
  bf16 tables where JAX's CPU path rotates in fp32); loss scale and
  overflow equal.
- O1 with ``remat`` against O1 without: losses and final parameters
  equal bit for bit (the recompute runs under the forward's policy).
- Multi-loss: scaler trajectories and skips equal; the masters within
  ``1e-6`` (one Adam step on sums of the same fp32 gradients).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp import ops as jax_ops
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_ce
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp import ops as ops
from apex_tpu_torch.convert import mlp_params_from_jax, params_from_jax
from apex_tpu_torch.models import GPTConfig, lm_loss
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam

JAX_O1 = jax_amp.resolve("O1")
PORT_O1 = amp.resolve("O1")
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16),
          "float32": (jnp.float32, torch.float32)}
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10,
       "bool": 0.0}


def _arr(rng, shape, kind="normal"):
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "pos":
        return (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
    if kind == "unit":
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if kind == "prob":
        return rng.uniform(0.05, 0.95, shape).astype(np.float32)
    raise ValueError(kind)


NHWC = ("NHWC", "HWIO", "NHWC")
# name: (float args as (shape, kind), extra args, kwargs); int args are
# ("int", shape, high)
CASES = {
    "matmul": ([((4, 8),), ((8, 5),)], {}),
    "dot": ([((4, 8),), ((8, 5),)], {}),
    "tensordot": ([((4, 8),), ((8, 5),)], {"axes": 1}),
    "einsum": (["ij,jk->ik", ((4, 8),), ((8, 5),)], {}),
    "dot_general": ([((2, 4, 8),), ((2, 8, 5),),
                     (((2,), (1,)), ((0,), (0,)))], {}),
    "conv_general_dilated": ([((2, 6, 6, 3),), ((3, 3, 3, 4),), (2, 2),
                              "SAME"], {"dimension_numbers": NHWC}),
    "conv_transpose": ([((2, 4, 4, 3),), ((4, 4, 3, 2),), (2, 2), "SAME"],
                       {"dimension_numbers": NHWC}),
    "conv": ([((2, 6, 6, 3),), ((3, 3, 3, 4),), ((4,),)], {}),
    "linear": ([((4, 8),), ((8, 5),), ((5,),)], {}),
    "prelu": ([((4, 5),), ((5,),)], {}),
    "exp": ([((4, 5),)], {}),
    "expm1": ([((4, 5),)], {}),
    "log": ([((4, 5), "pos")], {}),
    "log1p": ([((4, 5), "pos")], {}),
    "log2": ([((4, 5), "pos")], {}),
    "log10": ([((4, 5), "pos")], {}),
    "pow": ([((4, 5), "pos"), ((4, 5),)], {}),
    "reciprocal": ([((4, 5), "pos")], {}),
    "rsqrt": ([((4, 5), "pos")], {}),
    "sinh": ([((4, 5),)], {}),
    "cosh": ([((4, 5),)], {}),
    "tan": ([((4, 5), "unit")], {}),
    "acos": ([((4, 5), "unit")], {}),
    "asin": ([((4, 5), "unit")], {}),
    "erfinv": ([((4, 5), "unit")], {}),
    "sum": ([((4, 5),)], {"axis": -1}),
    "prod": ([((4, 5), "pos")], {"axis": -1}),
    "mean": ([((4, 5),)], {"axis": 0}),
    "var": ([((4, 5),)], {"axis": -1}),
    "std": ([((4, 5),)], {"axis": -1}),
    "norm": ([((4, 5),)], {}),
    "cumsum": ([((4, 5),)], {"axis": -1}),
    "cumprod": ([((4, 5), "pos")], {"axis": -1}),
    "logsumexp": ([((4, 5),)], {"axis": -1}),
    "softmax": ([((4, 5),)], {"axis": -1}),
    "log_softmax": ([((4, 5),)], {"axis": -1}),
    "softmin": ([((4, 5),)], {"axis": -1}),
    "softplus": ([((4, 5),)], {}),
    "layer_norm": ([((4, 8),), (8,), ((8,),), ((8,),)], {}),
    "group_norm": ([((2, 3, 3, 4),), 2, ((4,),), ((4,),)], {}),
    "batch_norm": ([((2, 3, 3, 4),), ((4,),), ((4,), "pos"), ((4,),),
                    ((4,),)], {"training": True}),
    "cross_entropy": ([((4, 5),), ("int", (4,), 5)], {}),
    "nll_loss": ([((4, 5),), ("int", (4,), 5)], {}),
    "l1_loss": ([((4, 5),), ((4, 5),)], {}),
    "mse_loss": ([((4, 5),), ((4, 5),)], {}),
    "smooth_l1_loss": ([((4, 5),), ((4, 5),)], {}),
    "kl_div": ([((4, 5),), ((4, 5), "prob")], {}),
    "poisson_nll_loss": ([((4, 5),), ((4, 5), "pos")], {}),
    "cosine_embedding_loss": ([((4, 8),), ((4, 8),), ("sign", (4,), 0)],
                              {}),
    "add": ([((4, 5),), ((4, 5),)], {}),
    "sub": ([((4, 5),), ((4, 5),)], {}),
    "mul": ([((4, 5),), ((4, 5),)], {}),
    "div": ([((4, 5),), ((4, 5), "pos")], {}),
    "atan2": ([((4, 5),), ((4, 5),)], {}),
    "maximum": ([((4, 5),), ((4, 5),)], {}),
    "minimum": ([((4, 5),), ((4, 5),)], {}),
    "equal": ([((4, 5),), ((4, 5),)], {}),
    "greater": ([((4, 5),), ((4, 5),)], {}),
    "less": ([((4, 5),), ((4, 5),)], {}),
}
TABLED = (lists.HALF_OPS + lists.FP32_OPS + lists.PROMOTE_OPS)


def test_the_cases_cover_every_op_of_the_tables():
    assert sorted(CASES) == sorted(TABLED)
    for name in TABLED + lists.SEQUENCE_PROMOTE_OPS + lists.BANNED_OPS:
        assert getattr(ops, name).__amp_wrapped__ in (
            "half", "float", "promote", "sequence_promote", "banned"), name


def test_the_tables_are_jaxs_without_fp8():
    """The five 16-bit tables are the JAX package's; since O4 is ported
    the fp8 tables are too (this test asserted their absence before)."""
    from apex_tpu.amp import lists as jax_lists
    for name in ("HALF_OPS", "FP32_OPS", "PROMOTE_OPS",
                 "SEQUENCE_PROMOTE_OPS", "BANNED_OPS", "FP8_OPS",
                 "FP8_DENY_OPS"):
        assert getattr(lists, name) == getattr(jax_lists, name), name


def _build(name, dtype_key, seed=0, second_dtype=None):
    """Matching JAX and torch argument lists for one op."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype_key]
    spec, kw = CASES[name]
    jargs, targs = [], []
    n_float = 0
    for a in spec:
        if isinstance(a, tuple) and a and isinstance(a[0], tuple) \
                and len(a) <= 2 and all(isinstance(d, int) for d in a[0]):
            x = _arr(rng, a[0], a[1] if len(a) > 1 else "normal")
            jd, td = (jdt, tdt)
            if n_float == 1 and second_dtype is not None:
                jd, td = DTYPES[second_dtype]
            n_float += 1
            jargs.append(jnp.asarray(x).astype(jd))
            targs.append(torch.from_numpy(x).to(td))
        elif isinstance(a, tuple) and a and a[0] in ("int", "sign"):
            if a[0] == "int":
                v = rng.randint(0, a[2], a[1]).astype(np.int32)
            else:
                v = np.where(rng.rand(*a[1]) > 0.5, 1, -1).astype(np.int32)
            jargs.append(jnp.asarray(v))
            targs.append(torch.from_numpy(v).long())
        else:
            jargs.append(a)
            targs.append(a)
    return jargs, targs, dict(kw), dict(kw)


def _compare(jout, tout):
    jd = jnp.asarray(jout).dtype.name
    td = str(tout.dtype).replace("torch.", "")
    assert td == jd, (td, jd)
    want = np.asarray(jnp.asarray(jout).astype(jnp.float32)) \
        if jd != "bool" else np.asarray(jout)
    got = tout.float().numpy() if td != "bool" else tout.numpy()
    assert got.shape == want.shape
    if jd == "bool":
        assert (got == want).all()
        return
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[jd] * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_casts_as_jax_under_o1(name, dtype):
    jargs, targs, jkw, tkw = _build(name, dtype)
    with jax_ops.cast_context(JAX_O1):
        jout = getattr(jax_ops, name)(*jargs, **jkw)
    with ops.cast_context(PORT_O1):
        tout = getattr(ops, name)(*targs, **tkw)
    _compare(jout, tout)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_is_a_passthrough_outside_a_cast_context(name):
    """Outside a policy: the unwrapped function's bits, and in fp32 JAX's
    values."""
    for dtype in ("float32", "bfloat16"):
        _, targs, _, tkw = _build(name, dtype, seed=1)
        op = getattr(ops, name)
        got = op(*targs, **tkw)
        want = op.__wrapped__(*targs, **tkw)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    jargs, targs, jkw, tkw = _build(name, "float32", seed=1)
    _compare(getattr(jax_ops, name)(*jargs, **jkw),
             getattr(ops, name)(*targs, **tkw))


@pytest.mark.parametrize("name", ["add", "mul", "maximum", "equal"])
@pytest.mark.parametrize("pair", [("bfloat16", "float32"),
                                  ("float16", "bfloat16"),
                                  ("bfloat16", "float16")])
def test_promote_ops_take_the_widest_input_as_jax(name, pair):
    jargs, targs, jkw, tkw = _build(name, pair[0], seed=2,
                                    second_dtype=pair[1])
    with jax_ops.cast_context(JAX_O1):
        jout = getattr(jax_ops, name)(*jargs, **jkw)
    with ops.cast_context(PORT_O1):
        tout = getattr(ops, name)(*targs, **tkw)
    _compare(jout, tout)


@pytest.mark.parametrize("name", ["concatenate", "stack"])
@pytest.mark.parametrize("dtypes", [("bfloat16", "float32", "bfloat16"),
                                    ("float16", "bfloat16"),
                                    ("float32", "float32")])
def test_sequence_promote_as_jax(name, dtypes):
    rng = np.random.RandomState(3)
    xs = [rng.standard_normal((2, 3)).astype(np.float32) for _ in dtypes]
    jl = [jnp.asarray(x).astype(DTYPES[d][0]) for x, d in zip(xs, dtypes)]
    tl = [torch.from_numpy(x).to(DTYPES[d][1]) for x, d in zip(xs, dtypes)]
    with jax_ops.cast_context(JAX_O1):
        jout = getattr(jax_ops, name)(jl, axis=0)
    with ops.cast_context(PORT_O1):
        tout = getattr(ops, name)(tl, axis=0)
    _compare(jout, tout)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_binary_cross_entropy_is_banned_on_half_inputs_as_jax(dtype):
    rng = np.random.RandomState(4)
    p = _arr(rng, (4, 5), "prob")
    t = (rng.rand(4, 5) > 0.5).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jargs = (jnp.asarray(p).astype(jdt), jnp.asarray(t))
    targs = (torch.from_numpy(p).to(tdt), torch.from_numpy(t))
    banned = dtype == "bfloat16"
    with jax_ops.cast_context(JAX_O1), ops.cast_context(PORT_O1):
        if banned:
            with pytest.raises(NotImplementedError):
                jax_ops.binary_cross_entropy(*jargs)
            with pytest.raises(NotImplementedError,
                               match="binary_cross_entropy"):
                ops.binary_cross_entropy(*targs)
        else:
            _compare(jax_ops.binary_cross_entropy(*jargs),
                     ops.binary_cross_entropy(*targs))
    # outside a policy, and with casts disabled, it runs
    _compare(jax_ops.binary_cross_entropy(*jargs),
             ops.binary_cross_entropy(*targs))
    with ops.cast_context(PORT_O1), ops.disable_casts():
        assert ops.active_policy() is None
        ops.binary_cross_entropy(*targs)


@pytest.mark.parametrize("kind", ["half", "float", "promote"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decorators_and_registrations_cast_as_jax(kind, dtype):
    """``half_function`` / ``float_function`` / ``promote_function`` on a
    user function, and their ``register_*`` forms on a namespace, give
    JAX's dtypes and values; ``deactivate_registrations`` restores the
    originals."""
    rng = np.random.RandomState(5)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((4, 2)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b)
    jwrap = getattr(jax_ops, f"{kind}_function")
    twrap = getattr(ops, f"{kind}_function")
    jf, tf = jwrap(lambda x, y: x @ y), twrap(lambda x, y: x @ y.to(x.dtype))
    jns = types.SimpleNamespace(f=lambda x, y: x @ y)
    tns = types.SimpleNamespace(f=lambda x, y: x @ y.to(x.dtype))
    originals = (jns.f, tns.f)
    getattr(jax_ops, f"register_{kind}_function")(jns, "f")
    getattr(ops, f"register_{kind}_function")(tns, "f")
    getattr(ops, f"register_{kind}_function")(tns, "f")   # idempotent
    try:
        with jax_ops.cast_context(JAX_O1), ops.cast_context(PORT_O1):
            _compare(jf(ja, jb), tf(ta, tb))
            _compare(jns.f(ja, jb), tns.f(ta, tb))
            with ops.disable_casts():
                assert tns.f(ta, tb).dtype == tdt
    finally:
        jax_ops.deactivate_registrations()
        ops.deactivate_registrations()
    assert (jns.f, tns.f) == originals
    assert tf(ta, tb).dtype == tdt                # no policy: passthrough


def test_cast_context_is_per_thread_and_nests():
    import threading
    seen = []
    with ops.cast_context(PORT_O1):
        assert ops.active_policy() is PORT_O1
        t = threading.Thread(target=lambda: seen.append(ops.active_policy()))
        t.start()
        t.join()
        with ops.cast_context(None):
            assert ops.active_policy() is None
        assert ops.active_policy() is PORT_O1
    assert seen == [None]
    assert ops.active_policy() is None
    o2 = amp.resolve("O2")
    with ops.cast_context(o2):
        assert ops.active_policy() is None      # O2 casts no ops


def test_recompute_context_carries_the_policy_to_another_thread():
    import threading
    with ops.cast_context(PORT_O1):
        _, recompute = ops.recompute_context()
    seen = []

    def run():
        with recompute:
            seen.append(ops.active_policy())
        seen.append(ops.active_policy())
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert seen == [PORT_O1, None]


# -- whole steps ---------------------------------------------------------------

STEPS = 7


def _mnist(n=STEPS, batch=256, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, (n, batch)).astype(np.int32)
    centers = rng.standard_normal((10, 784)).astype(np.float32) * 0.5
    x = centers[y] + 0.3 * rng.standard_normal((n, batch, 784)).astype(
        np.float32)
    return x.astype(np.float32), y


def test_mnist_mlp_o1_steps_match_jax():
    """BASELINE config 1: 7 O1 steps of ``MLP((256, 256))`` at B 256 with
    SGD(0.05), the port's default ``initialize`` against JAX's
    ``make_train_step``; losses within 1e-3 a step."""
    xs, ys = _mnist()
    jmodel = JaxMLP(features=(256, 256))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)))[
        "params"]
    ja = jax_amp.initialize(optimizer=optax.sgd(0.05), verbosity=0)
    jstate = ja.init(params)
    jstep = jax.jit(jax_amp.make_train_step(
        ja, lambda p, x, y: jax_ce(jmodel.apply({"params": p}, x), y)))
    model = mlp_params_from_jax(jax.tree.map(np.asarray, params),
                                device="cpu", trainable=True)
    ta = amp.initialize(model, torch.optim.SGD(model.parameters(), lr=0.05),
                        device="cpu")
    assert ta.properties.opt_level == ja.properties.opt_level == "O1"
    tstep = amp.make_train_step(
        ta, model, lambda m, x, y: cross_entropy_loss(m(x), y))
    jl, tl = [], []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        tm = tstep(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(jm["loss_scale"]) == float(tm["loss_scale"])
        assert bool(jm["overflow"]) == bool(tm["overflow"]) is False
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
    assert tl[-1] < tl[0]
    # the parameters stayed fp32 and are their own masters
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and ta.masters[n] is p


GPT_CONFIGS = {
    "tiny": dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128),
    "d64": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=256),
}


def _stream(vocab, b=4, l=32):
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return ((base + np.arange(l)[None, :]) % vocab).astype(np.int32)


def _gpt_torch(kw, tree, ids, remat=False, **init_kw):
    model = params_from_jax(tree, GPTConfig(**kw, remat=remat),
                            device="cpu", trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device="cpu"), device="cpu",
                       **init_kw)
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    x = torch.from_numpy(ids).long()
    metrics = [{k: float(v) for k, v in step(x).items()}
               for _ in range(STEPS)]
    return model, a, metrics


@pytest.mark.parametrize("kind", sorted(GPT_CONFIGS))
def test_gpt_o1_steps_match_jax(kind):
    kw = GPT_CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    jmodel = JaxGPT(JaxConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(ids[:, :16]))["params"]
    ja = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3), verbosity=0)
    jstate = ja.init(params)

    def loss_fn(p, x):
        return jax_lm_loss(jmodel.apply({"params": p}, x)[:, :-1], x[:, 1:])

    jstep = jax.jit(jax_amp.make_train_step(ja, loss_fn))
    jm = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, jnp.asarray(ids))
        jm.append({k: float(m[k]) for k in ("loss", "loss_scale",
                                             "overflow")})
    model, a, tm = _gpt_torch(kw, jax.tree.map(np.asarray, params), ids)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 2e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"]
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_gpt_o1_remat_equals_o1_without_it():
    """The remat recompute runs on autograd's side under the forward's
    policy: the same dtypes, so the same bits."""
    kw = GPT_CONFIGS["tiny"]
    ids = _stream(kw["vocab_size"])
    params = JaxGPT(JaxConfig(**kw)).init(
        jax.random.PRNGKey(1), jnp.asarray(ids[:, :16]))["params"]
    tree = jax.tree.map(np.asarray, params)
    m0, _, plain = _gpt_torch(kw, tree, ids)
    m1, _, remat = _gpt_torch(kw, tree, ids, remat=True)
    assert plain == remat
    for (n, p), (_, q) in zip(m0.named_parameters(), m1.named_parameters()):
        assert torch.equal(p, q), n


def test_an_o1_step_without_its_cast_context_differs():
    """The context is what makes O1 O1: a step whose loss runs outside
    it computes in fp32 and lands elsewhere."""
    kw = GPT_CONFIGS["tiny"]
    ids = _stream(kw["vocab_size"])
    params = JaxGPT(JaxConfig(**kw)).init(
        jax.random.PRNGKey(1), jnp.asarray(ids[:, :16]))["params"]
    tree = jax.tree.map(np.asarray, params)
    _, _, o1 = _gpt_torch(kw, tree, ids)
    _, _, o1_no_casts = _gpt_torch(kw, tree, ids, cast_ops=False)
    assert o1 != o1_no_casts


# -- handle API and several losses --------------------------------------------

def _tiny_model(seed=0):
    rng = np.random.RandomState(seed)
    m = torch.nn.Module()
    m.dense = torch.nn.Module()
    m.dense.kernel = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal((4, 3)).astype(np.float32)))
    m.dense.bias = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(3).astype(np.float32)))
    return m


def test_module_level_scale_loss_uses_the_latest_amp():
    m = _tiny_model()
    a = amp.initialize(m, FusedAdam(m.parameters(), device="cpu"),
                       device="cpu", num_losses=2)
    assert amp.active_amp() is a
    loss = torch.tensor(3.0)
    assert float(amp.scale_loss(loss)) == 3.0 * 2.0 ** 16
    a.scaler_states[1] = a.scaler_states[1]._replace(
        loss_scale=torch.tensor(4.0))
    assert float(amp.scale_loss(loss, loss_id=1)) == 12.0
    m2 = _tiny_model(1)
    b = amp.initialize(m2, FusedAdam(m2.parameters(), device="cpu"),
                       opt_level="O0", device="cpu")
    assert amp.active_amp() is b
    assert float(amp.scale_loss(loss, a, 1)) == 12.0


def test_legacy_handle_activates_o1_until_deactivated():
    handle = amp.init()
    try:
        assert handle.is_active and not handle.has_cache
        assert ops.active_policy() is not None
        x = torch.ones(2, 3)
        assert ops.matmul(x, torch.ones(3, 2)).dtype == torch.bfloat16
        m = _tiny_model()
        a = handle.wrap_optimizer(m, FusedAdam(m.parameters(),
                                               device="cpu"), num_loss=2)
        assert a.num_losses == 2 and a.properties.cast_ops
        assert float(handle.scale_loss(torch.tensor(1.0), 1)) == 2.0 ** 16
        handle._clear_cache()
    finally:
        handle._deactivate()
    assert ops.active_policy() is None
    noop = amp.init(enabled=False)
    assert not noop.is_active and isinstance(noop, amp.NoOpHandle)
    m = _tiny_model()
    a = noop.wrap_optimizer(m, FusedAdam(m.parameters(), device="cpu"))
    assert not a.properties.enabled
    assert float(noop.scale_loss(torch.tensor(5.0))) == 5.0


def _two_losses(seed=6):
    """Two gradient trees of the tiny model, loss 1's with an inf."""
    rng = np.random.RandomState(seed)
    g0 = {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
          "bias": rng.standard_normal(3).astype(np.float32)}
    g1 = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in g0.items()}
    return g0, g1


@pytest.mark.parametrize("overflow_in", [None, 0, 1])
def test_apply_gradients_multi_matches_jax(overflow_in):
    """Two losses on one optimizer, scaled by their own scalers: an
    overflow in either skips the step and halves only that scaler."""
    rng = np.random.RandomState(7)
    p = {"dense": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                   "bias": rng.standard_normal(3).astype(np.float32)}}
    ja = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2),
                            num_losses=2, verbosity=0)
    jstate = ja.init(p)
    m = torch.nn.Module()
    m.dense = torch.nn.Module()
    for k in ("kernel", "bias"):
        setattr(m.dense, k, torch.nn.Parameter(torch.from_numpy(
            p["dense"][k].copy())))
    ta = amp.initialize(m, FusedAdam(m.parameters(), lr=1e-2, device="cpu"),
                        num_losses=2, device="cpu")
    for step in range(3):
        g = _two_losses(10 + step)
        if overflow_in is not None and step == 1:
            g[overflow_in]["bias"][0] = np.inf
        jgs = [{"dense": {k: jnp.asarray(v) for k, v in gi.items()}}
               for gi in g]
        tgs = [[torch.from_numpy(gi["kernel"].copy()),
                torch.from_numpy(gi["bias"].copy())] for gi in g]
        jstate, jinfo = ja.apply_gradients_multi(jstate, jgs)
        tinfo = ta.apply_gradients_multi(tgs)
        assert bool(jinfo["overflow"]) == bool(tinfo["overflow"])
        assert [float(s) for s in jinfo["loss_scale"]] == \
            [float(s) for s in tinfo["loss_scale"]]
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(
                getattr(m.dense, k).detach().numpy(),
                np.asarray(jstate.master_params["dense"][k]), rtol=0,
                atol=1e-6)
    assert int(ta.step) == int(jstate.step) == 3


def test_update_scaler_and_step_if_compose_as_jax():
    """The pieces: per-loss unscale (``loss_id``), scaler update, and a
    skipped then a taken step."""
    rng = np.random.RandomState(8)
    p = {"w": rng.standard_normal(5).astype(np.float32)}
    ja = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2), num_losses=2,
                            verbosity=0)
    js = ja.init(p)
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.from_numpy(p["w"].copy()))
    ta = amp.initialize(m, FusedAdam(m.parameters(), lr=1e-2, device="cpu"),
                        num_losses=2, device="cpu")
    g = rng.standard_normal(5).astype(np.float32) * 2.0 ** 16
    bad = g.copy()
    bad[2] = np.nan
    for grads, skip in ((bad, True), (g, False)):
        ju, jfin = ja.unscale_gradients(js, {"w": jnp.asarray(grads)},
                                        loss_id=1)
        tu, tfin = ta.unscale_gradients([torch.from_numpy(grads.copy())],
                                        loss_id=1)
        assert bool(jfin) == bool(tfin) == (not skip)
        js, jov = ja.update_scaler(js, 1, jfin)
        tov = ta.update_scaler(1, tfin)
        assert bool(jov) == bool(tov) == skip
        js = ja.step_if(js, ju, jov)
        ta.step_if(tu, tov)
        np.testing.assert_allclose(m.w.detach().numpy(),
                                   np.asarray(js.master_params["w"]),
                                   rtol=0, atol=1e-7)
        assert [float(s.loss_scale) for s in js.scaler_states] == \
            [float(s.loss_scale) for s in ta.scaler_states]
