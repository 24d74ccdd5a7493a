"""The port's RNN stack (``apex_tpu_torch.rnn``) against the JAX package's
(``apex_tpu.rnn``) on the CPU: the same seeded inputs and the JAX
model's initial parameters (copied across by ``rnn_params_from_jax``)
through both, outputs, final states and the gradients of every parameter
and of the input within 1e-5 (JAX's own CPU tolerance in
``tests/l0/test_rnn.py``: rtol 1e-5, and atol 1e-5 times the tensor's
largest magnitude where that exceeds 1), for every mode alone, stacked and
bidirectional, with seq_lengths (bidirectional), with a recurrent
projection, and from a given initial state.  Under an O1 cast policy the
outputs are bf16 on both sides and agree within 2**-7 relative in norm
(``‖port - JAX‖ <= 2**-7 ‖JAX‖``; see ``O1_REL``).  The three cases the JAX package cannot run raise
``ValueError`` in the port; beside each, a JAX test pins JAX's
``TypeError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu import rnn as jax_rnn
from apex_tpu_torch import amp
from apex_tpu_torch import rnn
from apex_tpu_torch.amp.policy import O1
from apex_tpu_torch.convert import params_to_numpy, rnn_params_from_jax

T, B, F, H = 5, 3, 4, 8
TOL = 1e-5
#: the O1 outputs' norm-wise distance to JAX's: the relu and tanh stacks
#: agree bit for bit; the gated cells' bf16 sigmoid rounds otherwise in
#: XLA than in torch (0.0047-0.0051 here, while JAX's own O1 output lies
#: 0.0050-0.0067 from its fp32 one and the port's 0.0048-0.0053)
O1_REL = 2.0 ** -7
MODES = ("relu", "tanh", "gru", "lstm", "mlstm")
LENGTHS = np.array([T, 3, 1], np.int32)


def _x(seed=0):
    return np.random.RandomState(seed).randn(T, B, F).astype(np.float32)


def _init_states(mode, layers, dirs, seed=5, out=H):
    """Per-layer numpy initial states (tuples per direction)."""
    rng = np.random.RandomState(seed)

    def one():
        h = rng.randn(B, out).astype(np.float32)
        if rnn.is_lstm_like(mode):
            return (h, rng.randn(B, H).astype(np.float32))
        return h

    return [tuple(one() for _ in range(dirs)) if dirs == 2 else one()
            for _ in range(layers)]


def _to_jax_state(mode, s):
    if isinstance(s, tuple) and len(s) == 2 and not rnn.is_lstm_like(mode):
        return tuple(_to_jax_state(mode, d) for d in s)
    if rnn.is_lstm_like(mode):
        if isinstance(s[0], tuple):
            return tuple(_to_jax_state(mode, d) for d in s)
        return jax_rnn.LSTMState(h=jnp.asarray(s[0]), c=jnp.asarray(s[1]))
    return jnp.asarray(s)


def _to_port_state(mode, s):
    if rnn.is_lstm_like(mode):
        if isinstance(s[0], tuple):
            return tuple(_to_port_state(mode, d) for d in s)
        return rnn.LSTMState(h=torch.from_numpy(s[0]),
                             c=torch.from_numpy(s[1]))
    if isinstance(s, tuple):
        return tuple(torch.from_numpy(d) for d in s)
    return torch.from_numpy(s)


def _loss_jax(ys, finals):
    return jnp.sum(ys ** 2) + sum(jnp.sum(l ** 2)
                                  for l in jax.tree.leaves(finals))


def _leaves_port(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for s in tree for t in _leaves_port(s)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _jax_params(jmodel, x, seed):
    """The JAX model's parameter tree, drawn as its init draws it (flax's
    ``uniform(1/sqrt(H))`` kernels, zero biases) from a numpy seed: the
    shapes by ``eval_shape``, so nothing is compiled for them."""
    rng = np.random.RandomState(100 + seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def draw(path, s):
        if jax.tree_util.keystr(path[-1:]).startswith("['b_"):
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(rng.uniform(0, H ** -0.5, s.shape)
                           .astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _run(mode, layers=1, bidirectional=False, output_size=None,
         init=False, lengths=None, seed=0):
    """Both packages' outputs, finals and gradients (JAX's first)."""
    kw = dict(num_layers=layers, bidirectional=bidirectional,
              output_size=output_size)
    x = _x(seed)
    jmodel = jax_rnn.RNN(mode=mode, hidden_size=H, **kw)
    params = _jax_params(jmodel, x, seed)
    states = (_init_states(mode, layers, 2 if bidirectional else 1,
                           out=output_size or H) if init else None)
    jl = None if lengths is None else jnp.asarray(lengths)

    def jloss(p, xin):
        js = None if states is None else [_to_jax_state(mode, s)
                                          for s in states]
        ys, finals = jmodel.apply(p, xin, js, seq_lengths=jl)
        return _loss_jax(ys, finals), (ys, finals)

    (_, (jys, jfin)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    model = rnn.RNN(mode, F, H, device="cpu", **kw)
    rnn_params_from_jax(params["params"], model)
    xt = torch.from_numpy(x).requires_grad_(True)
    ps = (None if states is None else [_to_port_state(mode, s)
                                       for s in states])
    ys, finals = model(xt, ps, None if lengths is None
                       else torch.from_numpy(lengths))
    loss = (ys ** 2).sum() + sum((l ** 2).sum()
                                 for l in _leaves_port(finals))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()]
                                + [xt])
    jax_side = dict(ys=np.asarray(jys), x=np.asarray(jgx),
                    **{f"fin{i}": np.asarray(l) for i, l in
                       enumerate(jax.tree.leaves(jfin))},
                    **{f"d.{k}": v for k, v in
                       _flat(jgp["params"]).items()})
    port = dict(ys=ys.detach().numpy(), x=grads[-1].numpy(),
                **{f"fin{i}": l.detach().numpy() for i, l in
                   enumerate(_leaves_port(finals))},
                **{f"d.{n}": g.numpy() for n, g in zip(names, grads)})
    return jax_side, port


def _assert_match(jax_side, port):
    assert sorted(jax_side) == sorted(port)
    for k in jax_side:
        # fp32 rounding scales with the tensor: a ReLU stack's gradients
        # reach 1e4 here, where one ulp is 1e-3
        scale = max(1.0, float(np.abs(jax_side[k]).max()))
        np.testing.assert_allclose(port[k], jax_side[k], err_msg=k,
                                   rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("mode", MODES)
def test_single_layer_matches_jax(mode):
    _assert_match(*_run(mode))


@pytest.mark.parametrize("mode", MODES)
def test_stacked_bidirectional_lengths_and_initial_state_match_jax(mode):
    """2 layers, both directions, seq_lengths and a given initial state:
    a padded step emits zeros and passes no gradient to its input."""
    j, p = _run(mode, layers=2, bidirectional=True, init=True,
                lengths=LENGTHS, seed=1)
    assert p["ys"].shape == (T, B, 2 * H)
    for b, n in enumerate(LENGTHS):
        assert (p["ys"][n:, b] == 0).all()
        assert (p["x"][n:, b] == 0).all()
    _assert_match(j, p)


@pytest.mark.parametrize("mode", ("relu", "tanh", "lstm"))
def test_recurrent_projection_matches_jax(mode):
    """2 layers, both directions, h projected to 6 (and a given projected
    initial state): the projected h is the output and the carry."""
    j, p = _run(mode, layers=2, bidirectional=True, output_size=6,
                init=True, seed=3)
    assert p["ys"].shape == (T, B, 12)
    _assert_match(j, p)


@pytest.mark.parametrize("mode", MODES)
def test_o1_runs_in_bf16_as_jax(mode):
    x = _x(6)
    jmodel = jax_rnn.RNN(mode=mode, hidden_size=H, bidirectional=True)
    params = _jax_params(jmodel, x, 6)
    with jax_amp.cast_context(jax_amp.O1()):
        jys, _ = jmodel.apply(params, jnp.asarray(x),
                              seq_lengths=jnp.asarray(LENGTHS))
    model = rnn.RNN(mode, F, H, bidirectional=True, device="cpu")
    rnn_params_from_jax(params["params"], model)
    with amp.cast_context(O1()):
        ys, finals = model(torch.from_numpy(x),
                           seq_lengths=torch.from_numpy(LENGTHS))
    assert jys.dtype == jnp.bfloat16 and ys.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in _leaves_port(finals))
    want = np.asarray(jys, np.float32)
    err = np.linalg.norm(ys.detach().float().numpy() - want)
    assert err <= O1_REL * np.linalg.norm(want), err / np.linalg.norm(want)


def test_params_keep_jax_names_and_come_back():
    x = _x()
    jmodel = jax_rnn.mLSTM(hidden_size=H, num_layers=2, bidirectional=True,
                           bias=False)
    params = _jax_params(jmodel, x, 0)["params"]
    model = rnn.mLSTM(F, H, num_layers=2, bidirectional=True, bias=False,
                      device="cpu")
    rnn_params_from_jax(params, model)
    back = _flat(params_to_numpy(model))
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_init_draws_flax_uniform_from_zero_to_scale():
    gen = torch.Generator().manual_seed(0)
    model = rnn.LSTM(64, 256, device="cpu", generator=gen)
    w = model.layer_0_fwd.w_hh.detach()
    scale = 1.0 / 256 ** 0.5
    assert float(w.min()) >= 0.0 and float(w.max()) < scale
    assert abs(float(w.mean()) - scale / 2) < 0.01 * scale
    assert float(model.layer_0_fwd.b_ih.detach().abs().max()) == 0.0
    again = rnn.LSTM(64, 256, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.layer_0_fwd.w_hh, model.layer_0_fwd.w_hh)


def test_init_state_helper():
    s = rnn.init_state("mlstm", B, H, device="cpu")
    assert isinstance(s, rnn.LSTMState) and s.c.shape == (B, H)
    assert rnn.init_state("gru", B, H, torch.bfloat16,
                          device="cpu").dtype == torch.bfloat16


# -- the reference caveats: what JAX cannot run, the port refuses ----------

@pytest.mark.parametrize("mode", ("gru", "mlstm"))
def test_projected_gru_and_mlstm_are_refused(mode):
    with pytest.raises(ValueError, match="output_size"):
        rnn.RNN(mode, F, H, output_size=6, device="cpu")


@pytest.mark.parametrize("mode", ("gru", "mlstm"))
def test_jax_fails_on_projected_gru_and_mlstm(mode):
    model = jax_rnn.RNN(mode=mode, hidden_size=H, output_size=6)
    with pytest.raises(TypeError):
        model.init(jax.random.PRNGKey(0), jnp.asarray(_x()))


def test_projection_under_o1_is_refused():
    model = rnn.LSTM(F, H, output_size=6, device="cpu")
    with amp.cast_context(O1()):
        with pytest.raises(ValueError, match="O1"):
            model(torch.from_numpy(_x()))


def test_jax_fails_on_projection_under_o1():
    model = jax_rnn.LSTM(hidden_size=H, output_size=6)
    x = jnp.asarray(_x())
    params = _jax_params(model, _x(), 0)
    with jax_amp.cast_context(jax_amp.O1()):
        with pytest.raises(TypeError):
            model.apply(params, x)
