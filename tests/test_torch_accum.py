"""Gradient accumulation in the port (``make_train_step(...,
accum_steps=N)``, ``Amp.apply_gradients(stashed_grads=)``,
``LossScaler.unscale_with_stashed``, on the CPU through the kernels'
plain versions) against the JAX package's (its jnp path), from the same
initial parameters and batches made with numpy.

Tolerances, as ``tests/test_torch_train.py``'s:

- O0 (fp32): per-step losses within ``1e-5`` absolute; final masters
  every element within ``1e-4`` and all but 0.01% within ``1e-5`` (the
  frameworks sum matmuls in other orders, and Adam's ``m / sqrt(v)``
  turns last-bit gradient differences into small parameter ones).
- O2 (bf16 compute, fp32 masters): per-step losses within ``2e-2``;
  ``loss_scale`` and ``overflow`` equal at every step.
- BERT O0 + FusedLAMB: losses within ``1e-5``, masters within ``1e-5``
  (``tests/test_torch_bert.py``'s O0 bounds).
- The stashed path on one small tree: masters and moments within
  ``1e-7`` after a step, the unscaled sums bitwise (each product and the
  sum rounded on its own on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForPreTraining as JaxBert
from apex_tpu.models.bert import pretraining_loss as jax_pretraining_loss
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import fused_lamb
from apex_tpu_torch import amp
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.convert import (
    bert_params_from_jax,
    params_from_jax,
    params_to_numpy,
)
from apex_tpu_torch.models import BertConfig, GPTConfig, lm_loss
from apex_tpu_torch.models.bert import pretraining_loss
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

STEPS = 5
ACCUM = 4
CONFIGS = {
    "tiny": dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128),
    "d64": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=256),
}


def _stream(vocab, b=8, l=32):
    """``examples/gpt_lm.py``'s synthetic stream: next token = token + 1."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return ((base + np.arange(l)[None, :]) % vocab).astype(np.int32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_loss(model):
    def loss_fn(p, x, poison):
        logits = model.apply({"params": p}, x)
        return jax_lm_loss(logits[:, :-1], x[:, 1:]) \
            * (1.0 + poison.astype(jnp.float32).sum())
    return loss_fn


def _torch_loss(m, x, poison):
    return lm_loss(m(x)[:, :-1], x[:, 1:]) * (1.0 + poison.float().sum())


def _poisons(b, steps, bad_step=None, bad_micro=1):
    """One (B,) poison row per step: zeros (the loss unchanged), or inf
    on the rows of micro-batch ``bad_micro`` at ``bad_step``."""
    out = []
    for s in range(steps):
        p = np.zeros(b, np.float32)
        if s == bad_step:
            per = b // ACCUM
            p[bad_micro * per:(bad_micro + 1) * per] = np.inf
        out.append(p)
    return out


def _jax_run(kw, opt_level, ids, poisons, accum=ACCUM):
    model = JaxGPT(JaxConfig(**kw))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.asarray(ids[:, :16]))["params"]
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3),
                           opt_level=opt_level, verbosity=0)
    state = a.init(params)
    step = jax.jit(jax_amp.make_train_step(a, _jax_loss(model),
                                           accum_steps=accum))
    metrics, masters = [], []
    for poison in poisons:
        state, m = step(state, jnp.asarray(ids), jnp.asarray(poison))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
        masters.append(jax.tree.map(np.asarray, state.master_params))
    return jax.tree.map(np.asarray, params), metrics, masters


def _torch_run(kw, opt_level, tree, ids, poisons, accum=ACCUM):
    model = params_from_jax(tree, GPTConfig(**kw), device="cpu",
                            trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device="cpu"),
                       opt_level=opt_level, device="cpu")
    step = amp.make_train_step(a, model, _torch_loss, accum_steps=accum)
    x = torch.from_numpy(ids).long()
    metrics, masters = [], []
    for poison in poisons:
        m = step(x, torch.from_numpy(poison))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
        masters.append(params_to_numpy(a.masters))
    return a, metrics, masters


def _assert_o0_masters_close(got_tree, want_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert set(got) == set(want)
    beyond, total = 0, 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-4, rtol=0,
                                   err_msg="/".join(path))
        beyond += int((np.abs(got[path] - w) > 1e-5).sum())
        total += w.size
    assert beyond <= 1e-4 * total, (beyond, total)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o0_accumulated_steps_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    poisons = _poisons(len(ids), STEPS)
    tree, jm, jmasters = _jax_run(kw, "O0", ids, poisons)
    _, tm, tmasters = _torch_run(kw, "O0", tree, ids, poisons)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 1e-5, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"] == 1.0
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    _assert_o0_masters_close(tmasters[-1], jmasters[-1])


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o2_accumulated_steps_match_jax(kind):
    kw = CONFIGS[kind]
    ids = _stream(kw["vocab_size"])
    poisons = _poisons(len(ids), STEPS)
    tree, jm, _ = _jax_run(kw, "O2", ids, poisons)
    a, tm, _ = _torch_run(kw, "O2", tree, ids, poisons)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 2e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"]
        assert j["overflow"] == t["overflow"]
    assert tm[-1]["loss"] < tm[0]["loss"]
    # O2 accumulates into amp's own fp32 gradient buffers
    assert a.accumulators() is a.grad_buffers()


@pytest.mark.parametrize("opt_level", ["O2", "O3"])
def test_an_inf_in_one_micro_batch_skips_the_step_as_jax(opt_level):
    """Step 1 is clean; step 2 puts an inf into micro-batch 1 of 4: both
    skip it (masters unchanged, the dynamic scale halves under O2; under
    O3's static scale it stays), and step 3 trains again."""
    kw = CONFIGS["tiny"]
    ids = _stream(kw["vocab_size"])
    poisons = _poisons(len(ids), 3, bad_step=1)
    tree, jm, jmasters = _jax_run(kw, opt_level, ids, poisons)
    _, tm, tmasters = _torch_run(kw, opt_level, tree, ids, poisons)
    assert [m["overflow"] for m in jm] == [m["overflow"] for m in tm] \
        == [0.0, 1.0, 0.0]
    assert [m["loss_scale"] for m in jm] == [m["loss_scale"] for m in tm]
    if opt_level == "O2":
        assert tm[1]["loss_scale"] == tm[0]["loss_scale"] / 2
    for masters in (jmasters, tmasters):
        for (p, a), (_, b) in zip(_leaves(masters[0]),
                                  _leaves(masters[1])):
            np.testing.assert_array_equal(a, b, err_msg="/".join(p))
    assert not np.isfinite(tm[1]["loss"])


def test_accum_steps_1_is_the_plain_step():
    kw = CONFIGS["tiny"]
    ids = _stream(kw["vocab_size"])
    tree = _jax_run(kw, "O2", ids, [])[0]
    poisons = _poisons(len(ids), 3)
    _, m1, w1 = _torch_run(kw, "O2", tree, ids, poisons, accum=1)
    _, m0, w0 = _torch_run(kw, "O2", tree, ids, poisons, accum=None)
    assert m1 == m0
    for (p, a), (_, b) in zip(_leaves(w1[-1]), _leaves(w0[-1])):
        np.testing.assert_array_equal(a, b, err_msg="/".join(p))


def test_a_batch_that_does_not_divide_is_refused_as_in_jax():
    kw = CONFIGS["tiny"]
    ids = _stream(kw["vocab_size"], b=6)
    with pytest.raises(ValueError, match="divisible"):
        _jax_run(kw, "O0", ids, _poisons(6, 1))
    tree = _jax_run(kw, "O0", _stream(kw["vocab_size"]), [])[0]
    with pytest.raises(ValueError, match="divisible"):
        _torch_run(kw, "O0", tree, ids, _poisons(6, 1))
    model = params_from_jax(tree, GPTConfig(**kw), device="cpu",
                            trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), device="cpu"),
                       opt_level="O0", device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        amp.make_train_step(a, model, _torch_loss, accum_steps=0)


def test_o3_keeps_its_gradient_buffers_with_and_without_accumulation():
    """Without master weights the optimizer's gradients are bf16 buffers
    that keep their storage from step to step (so a whole-tree kernel's
    pointer rows go up once); accumulation adds into separate fp32
    buffers, also kept."""
    kw = CONFIGS["tiny"]
    ids = torch.from_numpy(_stream(kw["vocab_size"])).long()
    poison = torch.zeros(len(ids))
    tree = _jax_run(kw, "O3", _stream(kw["vocab_size"]), [])[0]
    model = params_from_jax(tree, GPTConfig(**kw), device="cpu",
                            trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-3, device="cpu")
    seen = []
    step_of = opt.step

    def spy(*args, **kw_):
        seen.append([t.grad.data_ptr() for t in
                     opt.param_groups[0]["params"]])
        return step_of(*args, **kw_)
    opt.step = spy
    a = amp.initialize(model, opt, opt_level="O3", device="cpu")
    plain = amp.make_train_step(a, model, _torch_loss)
    accum = amp.make_train_step(a, model, _torch_loss, accum_steps=ACCUM)
    for _ in range(2):
        plain(ids, poison)
    acc_ids = [b.data_ptr() for b in a.accumulators()]
    for _ in range(2):
        accum(ids, poison)
    assert len(seen) == 4 and all(s == seen[0] for s in seen)
    assert seen[0] == [b.data_ptr() for b in a.grad_buffers()]
    assert all(b.dtype == torch.bfloat16 for b in a.grad_buffers())
    assert [b.data_ptr() for b in a.accumulators()] == acc_ids
    assert all(b.dtype == torch.float32 for b in a.accumulators())


def _small_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.standard_normal((4, 3)).astype(
                np.float32),
                      "bias": rng.standard_normal(3).astype(np.float32)},
            "layernorm": {"scale": np.ones(3, np.float32)}}


class _Small(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        for mod, leaves in p.items():
            sub = torch.nn.Module()
            for name, v in leaves.items():
                setattr(sub, name, torch.nn.Parameter(
                    torch.from_numpy(v.copy())))
            setattr(self, mod, sub)


@pytest.mark.parametrize("stale_inf", [False, True])
def test_apply_gradients_with_stashed_grads_matches_jax(stale_inf):
    """``(1 / scale) * new + stashed`` then the step, under O2; a stale inf
    in the stash overflows the step on both sides (the check covers the
    combined gradients)."""
    p = _small_tree()
    rng = np.random.RandomState(3)
    new = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                       .astype(np.float32), p)
    stash = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.1)
                         .astype(np.float32), p)
    if stale_inf:
        stash["dense"]["kernel"][1, 2] = np.inf
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2), opt_level="O2",
                           verbosity=0)
    js = a.init(jax.tree.map(jnp.asarray, p))
    scale0 = float(js.scaler_states[0].loss_scale)
    cp = a.model_params(js)
    jnew = jax.tree.map(lambda x, c: (jnp.asarray(x) * scale0)
                        .astype(c.dtype), new, cp)
    js, jinfo = a.apply_gradients(js, jnew, stashed_grads=jax.tree.map(
        jnp.asarray, stash))

    model = _Small(p)
    t = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level="O2", device="cpu")
    names = [n for n, _ in model.named_parameters()]

    def pick(tree, n, dtype=torch.float32, mul=1.0):
        a_, b_ = n.split(".")
        return torch.from_numpy(tree[a_][b_] * mul).to(dtype)
    tnew = [pick(new, n, q.dtype, scale0)
            for n, q in model.named_parameters()]
    tinfo = t.apply_gradients(tnew, stashed_grads=[pick(stash, n)
                                                   for n in names])
    assert bool(jinfo["overflow"]) == bool(tinfo["overflow"]) == stale_inf
    assert float(jinfo["loss_scale"]) == float(tinfo["loss_scale"])
    for n in names:
        a_, b_ = n.split(".")
        m = t.masters[n]
        np.testing.assert_allclose(
            m.numpy(), np.asarray(js.master_params[a_][b_]), atol=1e-7,
            rtol=0, err_msg=n)
        np.testing.assert_allclose(
            t.optimizer.state[m]["exp_avg"].numpy(),
            np.asarray(js.opt_state.m[a_][b_]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("stale_inf", [False, True])
def test_unscale_with_stashed_matches_jax(stale_inf):
    """The scaler's and amp's ``unscale_gradients`` stashed path: the sums
    bitwise, and only the new gradients checked (arg 0), so a stale inf
    in the stash does not raise the flag."""
    rng = np.random.RandomState(4)
    shapes = [(4, 3), (70000,), (5,)]
    new = [(rng.standard_normal(s) * 1e3).astype(np.float32)
           for s in shapes]
    stash = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if stale_inf:
        stash[1][7] = np.inf
    js, ts = JaxLossScaler(), LossScaler()
    jout, jfinite = js.unscale_with_stashed(
        [jnp.asarray(a).astype(jnp.bfloat16) for a in new],
        [jnp.asarray(a) for a in stash], js.init_state())
    tnew = [torch.from_numpy(a).to(torch.bfloat16) for a in new]
    tst = [torch.from_numpy(a.copy()) for a in stash]
    tout, flag = ts.unscale_with_stashed(tnew, tst, ts.init_state())
    assert bool(jfinite) and int(flag[0]) == 0
    for j, t in zip(jout, tout):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # in place onto the stash, and through amp's unscale_gradients
    kept = list(tst)
    again, _ = ts.unscale_with_stashed(tnew, tst, ts.init_state(), out=tst)
    assert all(x is y for x, y in zip(again, kept))
    for j, t in zip(jout, again):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    model = _Small(_small_tree())
    t = amp.initialize(model, FusedAdam(model.parameters(), device="cpu"),
                       opt_level="O2", device="cpu")
    bad = [torch.full(q.shape, float("inf"), dtype=q.dtype)
           for q in model.parameters()]
    zeros = [torch.zeros(q.shape) for q in model.parameters()]
    _, finite = t.unscale_gradients(bad, stashed_grads=zeros)
    assert finite.shape == () and not bool(finite)
    _, finite = t.unscale_gradients(
        [torch.ones(q.shape, dtype=q.dtype) for q in model.parameters()],
        stashed_grads=[z + float("inf") for z in zeros])
    assert bool(finite)


def test_bert_o0_lamb_accumulated_steps_match_jax():
    """bert_tiny + FusedLAMB at O0 with ``accum_steps=2`` over a batch of
    4 ragged masked-LM rows, 5 steps."""
    kw = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
              intermediate_size=256, max_position_embeddings=64)
    jcfg, cfg = JaxBertConfig(**kw), BertConfig(**kw)
    rng = np.random.RandomState(0)
    b, l = 4, 32
    ids = rng.randint(0, 1024, (b, l)).astype(np.int32)
    mask_pos = rng.rand(b, l) < 0.15
    batch = dict(ids=np.where(mask_pos, 103, ids).astype(np.int32),
                 types=(np.arange(l)[None, :] >= l // 2).astype(np.int32)
                 .repeat(b, 0),
                 attn=(np.arange(l)[None, :] < (l - 5 * np.arange(b))
                       [:, None]).astype(np.int32),
                 labels=ids, mlm_mask=mask_pos.astype(np.float32),
                 nsp=rng.randint(0, 2, (b,)).astype(np.int32))
    order = ("ids", "types", "attn", "labels", "mlm_mask", "nsp")
    jmodel = JaxBert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(batch["ids"]),
                         attention_mask=jnp.asarray(batch["attn"]))["params"]
    a = jax_amp.initialize(optimizer=fused_lamb(learning_rate=1e-3),
                           opt_level="O0", verbosity=0)
    state = a.init(params)

    def jloss(p, ids_, types, attn, labels, mlm_mask, nsp):
        mlm, nspl = jmodel.apply({"params": p}, ids_, types, attn)
        return jax_pretraining_loss(mlm, nspl, labels, nsp, mlm_mask)
    jstep = jax.jit(jax_amp.make_train_step(a, jloss, accum_steps=2))
    jlosses = []
    for _ in range(STEPS):
        state, m = jstep(state, *[jnp.asarray(batch[k]) for k in order])
        jlosses.append(float(m["loss"]))

    model = bert_params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu", trainable=True)
    t = amp.initialize(model, FusedLAMB(model.parameters(), lr=1e-3,
                                        device="cpu"),
                       opt_level="O0", device="cpu")

    def tloss(m, ids_, types, attn, labels, mlm_mask, nsp):
        mlm, nspl = m(ids_, types, attn)
        return pretraining_loss(mlm, nspl, labels, nsp, mlm_mask)
    tstep = amp.make_train_step(t, model, tloss, accum_steps=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    args = [tb["ids"].long(), tb["types"].long(), tb["attn"],
            tb["labels"].long(), tb["mlm_mask"], tb["nsp"].long()]
    tlosses = [float(tstep(*args)["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    assert tlosses[-1] < tlosses[0]
    got = dict(_leaves(params_to_numpy(t.masters)))
    want = dict(_leaves(jax.tree.map(np.asarray, state.master_params)))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=0,
                                   err_msg="/".join(path))
