"""``Amp.add_params`` of the port against the JAX package's
``Amp.add_params``: the conformance MLP ``(64, 64)`` over 32 features
under ``FusedAdam(1e-2)`` takes 2 steps, then grows by a new ``Dense``
(32 -> 10, its logits added to the MLP's), then 3 more steps, from the
same weights and data (numpy, seed 0).

- The old leaves keep their moments and step counts through the growth,
  the new ones start at step 0 with zero moments (JAX's graft of
  ``leaf_step``).
- O0: losses, masters, moments and step counts within 1e-5 of JAX's
  (counts equal); O2: losses within 2e-2, masters within Adam's drift
  bound (twice lr a step: bf16 products round differently in XLA and
  PyTorch, and Adam's first steps are sign-like), step counts equal.
- The chunk tables cover every leaf after the growth: the whole-tree
  Adam's plain version walks its table and refuses tensors it does not
  match, so a stale table fails the step, and the test checks that the
  new leaves moved and the table's leaf count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_ce
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers.fused_adam import FusedAdamState
from apex_tpu_torch import amp
from apex_tpu_torch.convert import mlp_params_from_jax
from apex_tpu_torch.layers import Dense
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.ops.multi_tensor import ChunkTable
from apex_tpu_torch.optimizers import FusedAdam

FEATURES = (64, 64)
IN = 32
BEFORE, AFTER = 2, 3
LR = 1e-2


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(BEFORE + AFTER, 32, IN).astype(np.float32)
    y = rng.randint(0, 10, (BEFORE + AFTER, 32))
    extra = {"kernel": (rng.randn(IN, 10) * 0.1).astype(np.float32),
             "bias": (rng.randn(10) * 0.1).astype(np.float32)}
    return x, y, extra


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda t: isinstance(t, FusedAdamState))
        if isinstance(s, FusedAdamState)][0]


def _jax_run(opt_level):
    x, y, extra = _data()
    model = JaxMLP(features=FEATURES)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IN)))["params"]
    a = jamp.initialize(optimizer=JaxFusedAdam(lr=LR), opt_level=opt_level,
                        verbosity=0)
    state = a.init(dict(params))
    mlp_keys = sorted(params)

    def loss_fn(p, xb, yb):
        logits = model.apply({"params": {k: p[k] for k in mlp_keys}}, xb)
        if "extra" in p:
            logits = logits + (xb @ p["extra"]["kernel"]
                               + p["extra"]["bias"]).astype(logits.dtype)
        return jax_ce(logits, yb)

    losses = []
    for i in range(BEFORE + AFTER):
        if i == BEFORE:
            before = _adam_state(state.opt_state)
            state = a.add_params(state, {"extra": {
                k: jnp.asarray(v) for k, v in extra.items()}})
        step = jamp.make_train_step(a, loss_fn)
        state, m = step(state, jnp.asarray(x[i]), jnp.asarray(y[i]))
        losses.append(float(m["loss"]))
    names = [(l, k) for l in mlp_keys + ["extra"] for k in ("kernel",
                                                            "bias")]
    adam = _adam_state(state.opt_state)
    pick = lambda tree: [np.asarray(tree[l][k], np.float32)
                         for l, k in names]
    return dict(losses=losses, masters=pick(state.master_params),
                m=pick(adam.m), v=pick(adam.v),
                steps=[int(adam.leaf_step[l][k]) for l, k in names],
                before_m=[np.asarray(before.m[l][k]) for l, k in names[:-2]])


def _port_run(opt_level, new_group=False):
    x, y, extra = _data()
    model = mlp_params_from_jax(JaxMLP(features=FEATURES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IN)))["params"], FEATURES,
        in_features=IN, device="cpu", trainable=True)
    dense = Dense(IN, 10, device="cpu")
    with torch.no_grad():
        dense.kernel.copy_(torch.from_numpy(extra["kernel"]))
        dense.bias.copy_(torch.from_numpy(extra["bias"]))
    opt = FusedAdam(model.parameters(), lr=LR, device="cpu")
    a = amp.initialize(model, opt, opt_level=opt_level, device="cpu")
    grown = []

    def loss_fn(m, xb, yb):
        logits = m(xb)
        if grown:
            logits = logits + dense(xb).to(logits.dtype)
        return cross_entropy_loss(logits, yb)

    step = amp.make_train_step(a, model, loss_fn)
    losses, before = [], None
    for i in range(BEFORE + AFTER):
        if i == BEFORE:
            before = {n: (opt.state[t]["exp_avg"].clone(),
                          int(opt.state[t]["step"]))
                      for n, t in a.masters.items()}
            new = a.add_params(dense, prefix="extra", new_group=new_group)
            grown.append(True)
            assert new == list(dense.parameters())
            fresh = [a.masters[n].clone() for n in
                     ("extra.kernel", "extra.bias")]
        losses.append(float(step(torch.from_numpy(x[i]),
                                 torch.from_numpy(y[i]))["loss"]))
    ts = list(a.masters.values())
    return dict(losses=losses, masters=[t.detach().numpy() for t in ts],
                m=[opt.state[t]["exp_avg"].numpy() for t in ts],
                v=[opt.state[t]["exp_avg_sq"].numpy() for t in ts],
                steps=[int(opt.state[t]["step"]) for t in ts],
                before=before, fresh=fresh, amp=a, opt=opt, dense=dense)


def test_o0_matches_jax_and_keeps_the_old_state():
    want = _jax_run("O0")
    got = _port_run("O0")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    assert got["steps"] == want["steps"] == [BEFORE + AFTER] * 6 \
        + [AFTER] * 2
    for key in ("masters", "m", "v"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # the growth kept every old leaf's moments and count
    for (m, s), w in zip(got["before"].values(), want["before_m"]):
        assert s == BEFORE
        np.testing.assert_allclose(m.numpy(), w, rtol=0, atol=1e-6)


def test_o2_tracks_jax():
    want = _jax_run("O2")
    got = _port_run("O2")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=2e-2)
    assert got["steps"] == want["steps"]
    drift = 2 * LR * (BEFORE + AFTER) * 1.01
    for g, w in zip(got["masters"], want["masters"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=drift)
    a = got["amp"]
    assert all(p.dtype == torch.bfloat16 for p in a.params)
    assert got["dense"].kernel.dtype == torch.bfloat16
    for p, t in zip(a.params, a.masters.values()):
        assert torch.equal(p.detach(), t.to(torch.bfloat16))


@pytest.mark.parametrize("new_group", [False, True])
def test_the_tables_cover_the_new_leaves(new_group):
    got = _port_run("O2", new_group=new_group)
    a, opt = got["amp"], got["opt"]
    n = len(a.masters)
    assert n == 8 and len(a.params) == 8 and len(a.grad_buffers()) == 8
    assert len(opt.param_groups) == (2 if new_group else 1)
    assert sum(t.n_leaves for t in opt.tables) == n
    # the new leaves moved in all three steps after the growth
    for t, f in zip(list(a.masters.values())[-2:], got["fresh"]):
        assert not torch.equal(t, f)
    assert got["steps"][-2:] == [AFTER, AFTER]


def test_a_stale_table_is_refused():
    got = _port_run("O0")
    opt = got["opt"]
    group = opt.param_groups[0]
    stale = ChunkTable.of(group["params"][:-2])
    opt._tables[0] = stale
    # the optimizer notices and rebuilds it
    assert not stale.fits(group["params"])
    for t in group["params"]:
        t.grad = torch.zeros_like(t)
    opt.step()
    assert opt.tables[0] is not stale and opt.tables[0].n_leaves == 8
    from apex_tpu_torch.ops.cuda import packed_adam_tree
    ps = group["params"]
    ms = [opt.state[p]["exp_avg"] for p in ps]
    vs = [opt.state[p]["exp_avg_sq"] for p in ps]
    one = torch.ones(1)
    with pytest.raises(ValueError, match="chunk table"):
        packed_adam_tree(stale, ps, ms, vs, [p.grad for p in ps],
                         torch.ones(len(ps)), one, None, beta1=0.9,
                         beta2=0.999, eps=1e-8)


def test_refusals():
    got = _port_run("O0")
    a = got["amp"]
    with pytest.raises(ValueError, match="already present"):
        a.add_params({"extra.kernel": torch.nn.Parameter(torch.ones(2))})
    with pytest.raises(TypeError):
        a.add_params([torch.ones(2)])
    with pytest.raises(ValueError, match="not"):
        a.add_params({"w": torch.nn.Parameter(torch.ones(2,
                                                         device="meta"))})
