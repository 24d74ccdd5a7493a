"""The long-context training path of the port on the CPU: the gate that
picks the fused or the two-pass flash backward, the two-pass route's plain
versions against the JAX package, and per-layer recomputation (``remat``)
in GPT and BERT.

Tolerances: the two-pass gradients in fp32 ``atol = 1e-4`` against
``jax.grad`` of JAX's ``_jnp_attention`` and against JAX's own two-pass
Pallas route in interpret mode (the bound of ``tests/l0/
test_flash_attention.py`` on the CPU; both sum the score products in
other orders); in bf16 the two routes within one bf16 ulp of each other;
``remat`` against no ``remat`` within ``1e-6`` (the same fp32 operations
run again); ``remat`` against JAX's ``remat`` / ``scan_layers`` model the
bounds of ``tests/test_torch_train.py``'s O0 test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import flash_attention as jax_fa
from apex_tpu.ops.rope import apply_rope as jax_apply_rope
from apex_tpu_torch.attention import attention
from apex_tpu_torch.ops.cuda import (
    attn_delta,
    flash_attn_bwd,
    flash_attn_bwd_dkv,
    flash_attn_bwd_dq,
    flash_attn_fwd,
    fused_bwd,
    fused_bwd_max_bytes,
    fused_bwd_partials_bytes,
)
from apex_tpu_torch.ops.cuda import flash_attention as port_fa
from apex_tpu_torch.testing import bf16_ulp_distance
from test_torch_flash_attention import GRAD_CASES, _inputs, _np, _rope_tables

ENV = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"


# -- (a) the gate -----------------------------------------------------------

def test_budget_reads_the_variable_as_jax_does(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert fused_bwd_max_bytes() == jax_fa._fused_bwd_max_bytes() == 1 << 30
    monkeypatch.setenv(ENV, "123456789")
    assert fused_bwd_max_bytes() == jax_fa._fused_bwd_max_bytes() \
        == 123456789
    monkeypatch.setenv(ENV, "1e9x")
    for fn in (fused_bwd_max_bytes, jax_fa._fused_bwd_max_bytes):
        with pytest.raises(ValueError, match="plain integer"):
            fn()


def test_partials_bytes_are_the_fused_kernels_planes():
    assert fused_bwd_partials_bytes(8, 2048, 12, 64, torch.bfloat16) \
        == 32 * 8 * 2048 * 12 * 64 * 4 == 1_610_612_736
    assert fused_bwd_partials_bytes(32, 512, 16, 64, torch.bfloat16) \
        == 536_870_912
    assert fused_bwd_partials_bytes(1, 16384, 12, 64, torch.bfloat16) \
        == 12_884_901_888
    assert fused_bwd_partials_bytes(2, 37, 3, 64, torch.bfloat16) \
        == 1 * 2 * 37 * 3 * 64 * 4          # one plane for a ragged tile
    assert fused_bwd_partials_bytes(8, 2048, 12, 64, torch.float32) == 0


@pytest.mark.parametrize("shape,dtype,env,fused", [
    ((8, 2048, 12, 64), torch.bfloat16, None, False),   # gpt_small train
    ((32, 512, 16, 64), torch.bfloat16, None, True),    # bert_large
    ((1, 16384, 12, 64), torch.bfloat16, None, False),  # long context
    ((32, 512, 16, 64), torch.bfloat16, "0", False),
    ((8, 2048, 12, 64), torch.bfloat16, str(2 << 30), True),
    ((8, 2048, 12, 64), torch.float32, "0", True),      # no planes in fp32
])
def test_route_follows_the_budget(monkeypatch, shape, dtype, env, fused):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    q = torch.empty(shape, dtype=dtype, device="meta")
    assert fused_bwd(q) is fused


# -- (b)-(e) the two-pass route's plain versions ----------------------------

def _case(shape, causal, masked, rope, dtype="float32"):
    b, l, h, d = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, 3 * l + d)
    do = np.random.RandomState(l).standard_normal(shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.random.RandomState(l + 1).rand(b, l) > 0.4
        mask[:, 0] = True
        mask[0, :] = False                      # a fully masked batch row
    jtables, tables = _rope_tables(b, l, d)
    kw = dict(causal=causal,
              kv_mask=None if mask is None else torch.from_numpy(mask),
              rope=tables if rope else None)
    return (jq, jk, jv), (tq, tk, tv), do, mask, jtables, kw


def _two_pass(tq, tk, tv, do, kw):
    """dq, dk, dv of the two-pass route's wrappers (their plain versions
    on CPU tensors)."""
    o, lse = flash_attn_fwd(tq, tk, tv, return_lse=True, **kw)
    do_t = torch.from_numpy(do).to(tq.dtype)
    delta = attn_delta(o, do_t, None)
    dq = flash_attn_bwd_dq(tq, tk, tv, do_t, lse, delta, **kw)
    return (dq, *flash_attn_bwd_dkv(tq, tk, tv, do_t, lse, delta, **kw))


@pytest.mark.parametrize("shape,causal,masked,rope", GRAD_CASES)
def test_two_pass_route_matches_jax_grad(monkeypatch, shape, causal,
                                         masked, rope):
    """The two-pass plain versions against ``jax.grad`` of JAX's
    ``_jnp_attention`` on ``apply_rope``-rotated q and k, fp32."""
    monkeypatch.setenv(ENV, "0")
    (jq, jk, jv), (tq, tk, tv), do, mask, (jcos, jsin), kw = _case(
        shape, causal, masked, rope)

    def f(q, k, v):
        if rope:
            q, k = (jax_apply_rope(t, jcos, jsin) for t in (q, k))
        o = jax_fa._jnp_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            scale=1 / shape[-1] ** 0.5)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    got = _two_pass(tq, tk, tv, do, kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    if masked:
        assert all(torch.all(g[0] == 0) for g in got)


@pytest.mark.parametrize("shape,causal,masked,rope", GRAD_CASES)
def test_two_pass_route_matches_jax_two_pass_pallas(monkeypatch, shape,
                                                    causal, masked, rope):
    """The same inputs through JAX's own two-pass route: the Pallas
    ``_dq_kernel`` / ``_dkv_kernel`` in interpret mode, forced by the
    budget variable at 0, as ``tests/l0/test_flash_attention.py`` runs
    it."""
    monkeypatch.setenv(ENV, "0")
    (jq, jk, jv), (tq, tk, tv), do, mask, (jcos, jsin), kw = _case(
        shape, causal, masked, rope)

    def f(q, k, v):
        o = jax_fa.flash_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            rope=(jcos, jsin) if rope else None)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    got = _two_pass(tq, tk, tv, do, kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")


class _Spy:
    """Counts the calls of the two-pass dq wrapper behind
    :func:`flash_attn_bwd`."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = port_fa.flash_attn_bwd_dq

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)
        monkeypatch.setattr(port_fa, "flash_attn_bwd_dq", spy)


@pytest.mark.parametrize("shape,causal,masked,rope", GRAD_CASES)
def test_bf16_routes_agree(monkeypatch, shape, causal, masked, rope):
    """In bf16 the public :func:`flash_attn_bwd` routes by the budget: the
    fused route at the default and the two-pass one at 0 give dq, dk, dv
    within one bf16 ulp of each other."""
    spy = _Spy(monkeypatch)
    _, (tq, tk, tv), do, _, _, kw = _case(shape, causal, masked, rope,
                                          "bfloat16")
    o, lse = flash_attn_fwd(tq, tk, tv, return_lse=True, **kw)
    do_t = torch.from_numpy(do).to(torch.bfloat16)
    routes = {}
    for env in (None, "0"):
        if env is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, env)
        routes[env] = flash_attn_bwd(tq, tk, tv, o, lse, do_t, **kw)
    assert spy.calls == 1                       # only the "0" call
    for a, b_ in zip(routes[None], routes["0"]):
        assert a.dtype == b_.dtype == torch.bfloat16
        assert bf16_ulp_distance(a, b_) <= 1


def test_lse_cotangent_folds_in_on_the_two_pass_route(monkeypatch):
    """A gradient through the returned lse reaches the two-pass kernels
    through ``delta``: bf16 gradients of ``o.sum() + 0.5 lse.sum()`` on
    the two-pass route equal the fused route's, and match fp32 autograd
    of the materialising version on the same values within 2e-2."""
    spy = _Spy(monkeypatch)
    _, (tq, tk, tv) = _inputs((1, 19, 2, 64), "bfloat16", 4)

    def grads(env):
        monkeypatch.setenv(ENV, env)
        q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
        o, lse = attention(q, k, v, causal=True, return_lse=True)
        (o.float().sum() + (lse * 0.5).sum()).backward()
        return q.grad, k.grad, v.grad

    two_pass = grads("0")
    assert spy.calls == 1
    fused = grads(str(1 << 30))
    assert spy.calls == 1
    for a, b_ in zip(two_pass, fused):
        assert bf16_ulp_distance(a, b_) <= 1
    q2, k2, v2 = (t.float().clone().requires_grad_() for t in (tq, tk, tv))
    s = torch.einsum("bqhd,bkhd->bhqk", q2, k2) / 8.0
    s = s.masked_fill(~torch.ones(19, 19, dtype=torch.bool).tril(), -1e30)
    o2 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v2)
    lse2 = torch.logsumexp(s, -1).permute(0, 2, 1)
    (o2.sum() + (lse2 * 0.5).sum()).backward()
    for a, b_ in zip(two_pass, (q2.grad, k2.grad, v2.grad)):
        torch.testing.assert_close(a.float(), b_, atol=2e-2, rtol=0)
    # without the lse term the gradients differ: the cotangent was used
    q3 = tq.clone().requires_grad_()
    monkeypatch.setenv(ENV, "0")
    attention(q3, tk, tv, causal=True).float().sum().backward()
    assert not torch.allclose(q3.grad.float(), two_pass[0].float(),
                              atol=1e-2)


# -- (f)-(h) remat ----------------------------------------------------------

def _gpt_pair(kw, seed=0):
    from apex_tpu_torch.models import GPTConfig, GPTModel
    torch.manual_seed(seed)
    base = GPTModel(GPTConfig(**kw), device="cpu")
    remat = GPTModel(GPTConfig(**kw, remat=True), device="cpu")
    remat.load_state_dict(base.state_dict())
    return base, remat


def _stream(vocab, b=4, l=32):
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return ((base + np.arange(l)[None, :]) % vocab).astype(np.int64)


TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128)


def test_gpt_remat_matches_no_remat_and_runs_the_forward_twice(monkeypatch):
    """gpt_tiny with ``remat=True`` against ``remat=False`` from the same
    weights, fp32: equal loss and gradients within 1e-6, and the flash
    forward called twice per layer in a backward pass (the recompute)
    against once; under ``no_grad`` once."""
    import apex_tpu_torch.attention as attn_mod
    from apex_tpu_torch.models import lm_loss
    calls = []
    real = attn_mod.flash_attn_fwd

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(attn_mod, "flash_attn_fwd", spy)
    ids = torch.from_numpy(_stream(TINY["vocab_size"]))
    out = {}
    for model in _gpt_pair(TINY):
        calls.clear()
        loss = lm_loss(model(ids)[:, :-1], ids[:, 1:])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[model.cfg.remat] = (float(loss.detach()), grads, len(calls))
        with torch.no_grad():
            calls.clear()
            model(ids)
            assert len(calls) == TINY["num_layers"]
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert (n0, n1) == (TINY["num_layers"], 2 * TINY["num_layers"])
    assert abs(l0 - l1) <= 1e-6
    for a, b_ in zip(g0, g1):
        torch.testing.assert_close(a, b_, atol=1e-6, rtol=0)


def test_gpt_remat_o0_steps_match_no_remat():
    """Three amp O0 FusedAdam steps of gpt_tiny with and without remat:
    losses and fp32 masters within 1e-6."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import lm_loss
    from apex_tpu_torch.optimizers import FusedAdam
    ids = torch.from_numpy(_stream(TINY["vocab_size"]))
    runs = []
    for model in _gpt_pair(TINY, seed=1):
        a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                            device="cpu"),
                           opt_level="O0", device="cpu")
        step = amp.make_train_step(
            a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
        runs.append(([float(step(ids)["loss"]) for _ in range(3)],
                     {k: t.clone() for k, t in a.masters.items()}))
    (la, ma), (lb, mb) = runs
    np.testing.assert_allclose(la, lb, atol=1e-6, rtol=0)
    for k, t in ma.items():
        torch.testing.assert_close(t, mb[k], atol=1e-6, rtol=0)


def test_gpt_remat_steps_match_jax_remat_scan_model():
    """gpt_tiny with ``remat=True`` against JAX ``make_train_step`` on a
    ``GPTConfig(remat=True, scan_layers=True)`` model, 3 steps at O0 from
    the JAX tree (its scan layout unstacked by ``params_from_jax``):
    losses within 1e-5, every fp32 master within 1e-4 and all but 0.01%
    within 1e-5, as ``tests/test_torch_train.py``'s O0 test holds them."""
    from apex_tpu import amp as jax_amp
    from apex_tpu.models import GPTModel as JaxGPT
    from apex_tpu.models.gpt import GPTConfig as JaxConfig
    from apex_tpu.models.gpt import lm_loss as jax_lm_loss
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax, params_to_numpy
    from apex_tpu_torch.models import GPTConfig, lm_loss
    from apex_tpu_torch.optimizers import FusedAdam
    ids = _stream(TINY["vocab_size"]).astype(np.int32)
    jmodel = JaxGPT(JaxConfig(**TINY, remat=True, scan_layers=True))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(ids[:, :16]))["params"]
    assert "layers" in params                    # the scan layout
    ja = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3),
                            opt_level="O0", verbosity=0)
    state = ja.init(params)

    def jloss(p, x):
        return jax_lm_loss(jmodel.apply({"params": p}, x)[:, :-1], x[:, 1:])

    jstep = jax.jit(jax_amp.make_train_step(ja, jloss))
    jlosses = []
    for _ in range(3):
        state, m = jstep(state, jnp.asarray(ids))
        jlosses.append(float(m["loss"]))

    cfg = GPTConfig(**TINY, remat=True)
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tree, cfg, device="cpu", trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device="cpu"),
                       opt_level="O0", device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    x = torch.from_numpy(ids).long()
    tlosses = [float(step(x)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    assert tlosses[-1] < tlosses[0]
    # the JAX masters, unstacked by the same converter
    want = params_to_numpy(params_from_jax(
        jax.tree.map(np.asarray, state.master_params), cfg, device="cpu"))
    got = params_to_numpy(a.masters)

    def leaves(t, pre=()):
        for k, v in t.items():
            yield from (leaves(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), v)])
    want, got = dict(leaves(want)), dict(leaves(got))
    assert set(want) == set(got)
    beyond = total = 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-4, rtol=0,
                                   err_msg="/".join(path))
        beyond += int((np.abs(got[path] - w) > 1e-5).sum())
        total += w.size
    assert beyond <= 1e-4 * total, (beyond, total)


def test_bert_remat_matches_no_remat():
    """bert_tiny with ``remat=True`` builds and gives the loss and
    gradients of ``remat=False`` from the same weights, fp32, within
    1e-6, with a ragged attention mask."""
    from apex_tpu_torch.models import (BertForPreTraining, bert_tiny,
                                       pretraining_loss)
    cfg = bert_tiny()
    torch.manual_seed(0)
    base = BertForPreTraining(cfg, device="cpu")
    remat = BertForPreTraining(dataclasses.replace(cfg, remat=True),
                               device="cpu")
    remat.load_state_dict(base.state_dict())
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 24)))
    attn = torch.from_numpy(np.arange(24)[None] < np.array([[24], [17]]))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 24)))
    weights = torch.from_numpy((rng.rand(2, 24) < 0.3).astype(np.float32))
    nsp = torch.tensor([0, 1])
    out = []
    for model in (base, remat):
        mlm, nsp_logits = model(ids, torch.zeros_like(ids), attn.int())
        loss = pretraining_loss(mlm, nsp_logits, labels, nsp, weights)
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert abs(out[0][0] - out[1][0]) <= 1e-6
    for a, b_ in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b_, atol=1e-6, rtol=0)
