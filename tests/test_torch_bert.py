"""The port's BERT pretraining path against the JAX package's (its jnp
path, on the CPU): ``BertForPreTraining`` logits and
``pretraining_loss``, ``bert_params_from_jax`` in both layouts, and
train steps of ``amp.make_train_step`` + ``FusedLAMB`` against JAX
``make_train_step`` + ``fused_lamb``, from the same parameters, on the
synthetic masked-LM batch of ``examples/bert_pretraining.py`` (15% of
positions masked, NSP labels) with a ragged key mask (rows padded at
their ends).

Tolerances:

- forward, fp32: MLM and NSP logits within ``atol = 1e-4`` and the loss
  within ``1e-5`` (the port's attention pre-scales q and runs the flash
  plain version; the JAX path divides the scores; layer norm and softmax
  sum in other orders, and the differences pass through the layers).
- O0 (fp32) train steps at the example's lr 1e-3: per-step losses
  within ``1e-5``; final masters within ``1e-5`` (measured: losses within
  1e-6, masters within 1.2e-6; the largest differences sit in the qkv
  biases, whose key part gets a gradient of rounding noise that
  ``m / sqrt(v)`` normalises).
- O2 (bf16 compute, fp32 masters): per-step losses within ``3e-2``, loss
  scale and overflow equal at every step, and the port's first O2 loss
  within ``1e-2`` of the fp32 loss of the same parameters.  The GPT O2
  test's bound of 2e-2 does not hold here because of the JAX side: at
  the same parameters its O2 loss lies up to 0.021 from its own fp32
  loss, the port's within 0.0044 (measured over 3 batches and both
  configs; ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models.bert import BertConfig as JaxConfig
from apex_tpu.models.bert import BertForPreTraining as JaxBert
from apex_tpu.models.bert import pretraining_loss as jax_pretraining_loss
from apex_tpu.optimizers import fused_lamb
from apex_tpu_torch import amp
from apex_tpu_torch.convert import bert_params_from_jax, params_to_numpy
from apex_tpu_torch.models import (
    BertConfig,
    BertForPreTraining,
    bert_tiny,
    pretraining_loss,
)
from apex_tpu_torch.optimizers import FusedLAMB

CONFIGS = {
    "tiny": {},           # bert_tiny: 4 heads of 32
    # two heads of 64, the kernels' head width on the card
    "d64": dict(num_heads=2),
}
STEPS = 5
LR = 1e-3


def _cfgs(kind, **extra):
    kw = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
              intermediate_size=256, max_position_embeddings=64)
    kw.update(CONFIGS[kind], **extra)
    return JaxConfig(**kw), BertConfig(**kw)


def _batch(vocab, b=4, l=32, seed=0):
    """``synthetic_mlm_batch`` of ``examples/bert_pretraining.py`` drawn
    with numpy, and a ragged attention mask (row i keeps its first
    ``l - 5 i`` positions)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, l)).astype(np.int32)
    mask_pos = rng.rand(b, l) < 0.15
    masked = np.where(mask_pos, 103, ids).astype(np.int32)
    attn = (np.arange(l)[None, :] < (l - 5 * np.arange(b))[:, None]) \
        .astype(np.int32)
    types = (np.arange(l)[None, :] >= l // 2).astype(np.int32) \
        .repeat(b, 0)
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return dict(ids=masked, types=types, attn=attn, labels=ids,
                mlm_mask=mask_pos.astype(np.float32), nsp=nsp)


def _init(jcfg, batch, seed=1):
    params = JaxBert(jcfg).init(jax.random.PRNGKey(seed),
                                jnp.asarray(batch["ids"][:, :8]),
                                attention_mask=jnp.asarray(
                                    batch["attn"][:, :8]))["params"]
    return params, jax.tree.map(np.asarray, params)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_pretraining_logits_and_loss_match_jax(kind):
    jcfg, cfg = _cfgs(kind)
    batch = _batch(cfg.vocab_size)
    params, tree = _init(jcfg, batch)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    jm, jn = JaxBert(jcfg).apply({"params": params}, j["ids"], j["types"],
                                 j["attn"])
    jloss = jax_pretraining_loss(jm, jn, j["labels"], j["nsp"],
                                 j["mlm_mask"])
    model = bert_params_from_jax(tree, cfg, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tm, tn = model(t["ids"].long(), t["types"].long(), t["attn"])
        tloss = pretraining_loss(tm, tn, t["labels"].long(),
                                 t["nsp"].long(), t["mlm_mask"])
    assert tm.shape == (4, 32, cfg.vocab_size) and tn.shape == (4, 2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4,
                               rtol=0)
    assert abs(float(tloss) - float(jloss)) <= 1e-5


def _jax_run(jcfg, opt_level, batch, params):
    model = JaxBert(jcfg)
    a = jax_amp.initialize(optimizer=fused_lamb(learning_rate=LR),
                           opt_level=opt_level, verbosity=0)
    state = a.init(params)

    def loss_fn(p, ids, types, attn, labels, mlm_mask, nsp):
        mlm, nspl = model.apply({"params": p}, ids, types, attn)
        return jax_pretraining_loss(mlm, nspl, labels, nsp, mlm_mask)

    step = jax.jit(jax_amp.make_train_step(a, loss_fn))
    args = [jnp.asarray(batch[k]) for k in
            ("ids", "types", "attn", "labels", "mlm_mask", "nsp")]
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, *args)
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return metrics, jax.tree.map(np.asarray, state.master_params)


def _bert_loss(model, ids, types, attn, labels, mlm_mask, nsp):
    mlm, nspl = model(ids, types, attn)
    return pretraining_loss(mlm, nspl, labels, nsp, mlm_mask)


def _torch_run(cfg, opt_level, batch, tree):
    model = bert_params_from_jax(tree, cfg, device="cpu", trainable=True)
    a = amp.initialize(model, FusedLAMB(model.parameters(), lr=LR,
                                        device="cpu"),
                       opt_level=opt_level, device="cpu")
    step = amp.make_train_step(a, model, _bert_loss)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    args = [t["ids"].long(), t["types"].long(), t["attn"],
            t["labels"].long(), t["mlm_mask"], t["nsp"].long()]
    metrics = []
    for _ in range(STEPS):
        m = step(*args)
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return model, a, metrics, args


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o0_fp32_lamb_steps_match_jax(kind):
    jcfg, cfg = _cfgs(kind)
    batch = _batch(cfg.vocab_size)
    params, tree = _init(jcfg, batch)
    jm, jmaster = _jax_run(jcfg, "O0", batch, params)
    _, a, tm, _ = _torch_run(cfg, "O0", batch, tree)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 1e-5, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"] == 1.0
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    got = dict(_leaves(params_to_numpy(a.masters)))
    want = dict(_leaves(jmaster))
    assert set(got) == set(want) and len(got) == 5 + 12 * 2 + 10
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=0,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_o2_bf16_lamb_steps_match_jax(kind):
    jcfg, cfg = _cfgs(kind)
    batch = _batch(cfg.vocab_size)
    params, tree = _init(jcfg, batch)
    jm, _ = _jax_run(jcfg, "O2", batch, params)
    model, a, tm, args = _torch_run(cfg, "O2", batch, tree)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 3e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"]
        assert j["overflow"] == t["overflow"]
    assert tm[-1]["loss"] < tm[0]["loss"]
    fp32 = bert_params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        assert abs(float(_bert_loss(fp32, *args)) - tm[0]["loss"]) <= 1e-2
    # every leaf is cast (no name matches the keep-fp32 filter, as in JAX)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in a.masters.values())
    for n, p in model.named_parameters():
        assert torch.equal(p, a.masters[n].to(torch.bfloat16)), n


def test_an_overflow_is_skipped_and_halves_the_scale():
    """A step whose gradients hold an inf changes nothing but the scale:
    masters, compute params, m, v and the step counts stay."""
    jcfg, cfg = _cfgs("d64")
    batch = _batch(cfg.vocab_size)
    _, tree = _init(jcfg, batch)
    model, a, _, args = _torch_run(cfg, "O2", batch, tree)
    opt = a.optimizer
    with torch.enable_grad():
        loss = a.run(_bert_loss, model, *args)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[7].view(-1)[3] = float("inf")
    masters = {n: t.clone() for n, t in a.masters.items()}
    compute = [p.detach().clone() for p in a.params]
    moments = [(opt.state[t]["exp_avg"].clone(),
                opt.state[t]["exp_avg_sq"].clone())
               for t in a.masters.values()]
    steps = opt.param_groups[0]["leaf_steps"].clone()
    scale = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    assert bool(info["overflow"])
    assert float(info["loss_scale"]) == scale / 2
    assert all(torch.equal(masters[n], t) for n, t in a.masters.items())
    assert all(torch.equal(c, p) for c, p in zip(compute, a.params))
    for (m, v), t in zip(moments, a.masters.values()):
        assert torch.equal(opt.state[t]["exp_avg"], m)
        assert torch.equal(opt.state[t]["exp_avg_sq"], v)
    assert torch.equal(opt.param_groups[0]["leaf_steps"], steps)
    assert int(steps[0]) == STEPS


@pytest.mark.parametrize("scan", [False, True])
def test_bert_params_round_trip_in_both_layouts(scan):
    jcfg, cfg = _cfgs("d64", scan_layers=scan)
    batch = _batch(cfg.vocab_size)
    params, tree = _init(jcfg, batch, seed=3)
    assert ("layers" in tree["bert"]) == scan
    model = bert_params_from_jax(tree, cfg, device="cpu")
    back = dict(_leaves(params_to_numpy(model)))
    if scan:
        stacked = tree["bert"]["layers"]["layer"]
        np.testing.assert_array_equal(
            model.bert.layer_1.attention.qkv.kernel.numpy(),
            stacked["attention"]["qkv"]["kernel"][1])
        for path, w in _leaves(stacked):
            for i in range(cfg.num_layers):
                np.testing.assert_array_equal(
                    back[("bert", f"layer_{i}") + path], w[i])
        assert len(back) == len(list(_leaves(tree))) + 12 * (
            cfg.num_layers - 1)
    else:
        want = dict(_leaves(tree))
        assert set(back) == set(want)
        for path, w in want.items():
            np.testing.assert_array_equal(back[path], w)
    # the scan-layout model computes what the JAX scan model computes
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    jm, _ = JaxBert(jcfg).apply({"params": params}, j["ids"], j["types"],
                                j["attn"])
    with torch.no_grad():
        tm, _ = model(torch.from_numpy(batch["ids"]).long(),
                      torch.from_numpy(batch["types"]).long(),
                      torch.from_numpy(batch["attn"]))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4,
                               rtol=0)


def test_configs_and_refusals():
    from apex_tpu.models import bert as jbert
    from apex_tpu_torch.models import bert
    for name in ("bert_large", "bert_large_tpu", "bert_base", "bert_tiny"):
        mine = dataclasses.asdict(getattr(bert, name)())
        theirs = dataclasses.asdict(getattr(jbert, name)())
        assert mine == theirs, name
    assert bert.bert_large().head_dim == 64
    n = sum(p.numel() for p in BertForPreTraining(
        bert.bert_large(), device="meta").parameters())
    assert len(list(BertForPreTraining(bert.bert_large(), device="meta")
                    .parameters())) == 303
    assert n == 367_480_636
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BertForPreTraining(dataclasses.replace(bert_tiny(), remat=True),
                           device="meta")


@pytest.mark.parametrize("masked", [False, True])
def test_attention_bhld_layout_is_the_permuted_blhd(masked):
    """``layout="bhld"`` (the JAX flash wrapper's head-major layout) gives
    the blhd result permuted, with the lse still ``(B, L, H)``, and the
    same gradients, exactly."""
    from apex_tpu_torch.attention import attention
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, 20, 64))
                                    .astype(np.float32)) for _ in range(4))
    mask = torch.from_numpy(rng.rand(2, 20) > 0.3) if masked else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = attention(*leaves, kv_mask=mask, return_lse=True,
                       layout="bhld")
    o.backward(do)
    flat = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    o2, lse2 = attention(*flat, kv_mask=mask, return_lse=True)
    o2.backward(do.transpose(1, 2))
    assert o.shape == (2, 3, 20, 64) and lse.shape == (2, 20, 3)
    assert torch.equal(o, o2.transpose(1, 2)) and torch.equal(lse, lse2)
    for a, b in zip(leaves, flat):
        assert torch.equal(a.grad, b.grad.transpose(1, 2))
    with pytest.raises(ValueError, match="layout"):
        attention(q, k, v, layout="hbld")
