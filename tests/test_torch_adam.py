"""The port's fused Adam (K5's plain version, ``adam_step`` and the
``FusedAdam`` optimizer, on the CPU) against the JAX package's
``adam_step`` and ``fused_adam`` (its jnp path).

Tolerance: at most 1 fp32 ulp per element.  Both sides run the same op
order in fp32 (``g / scale``, the weight decay, both moments, ``denom``,
``p - step_size * m / denom``); the bias-corrected step size goes
through ``pow`` and ``sqrt``, whose last bit two libraries may round
differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers.fused_adam import adam_step as jax_adam_step
from apex_tpu.optimizers.fused_adam import fused_adam as jax_fused_adam
from apex_tpu_torch.ops.cuda import packed_adam, packed_adam_ref
from apex_tpu_torch.optimizers import (
    EPS_MODE_INSIDE,
    EPS_MODE_OUTSIDE,
    FusedAdam,
    adam_step,
)
from apex_tpu_torch.testing import bf16_ulp_distance


def _ulps(a, b):
    """Largest distance in fp32 units in the last place."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max())


def _state(n, seed):
    rng = np.random.RandomState(seed)
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return p, m, v, g


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("eps_mode", [EPS_MODE_OUTSIDE, EPS_MODE_INSIDE])
def test_adam_step_matches_jax(eps_mode, weight_decay, copy):
    p, m, v, g = _state(1037, 7)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=weight_decay, eps_mode=eps_mode)
    want = jax_adam_step(*(jnp.asarray(a) for a in (p, m, v, g)),
                         step=jnp.asarray(3, jnp.int32), scale=2.0,
                         p_copy_dtype=jnp.bfloat16 if copy else None, **kw)
    tp, tm, tv, tg = (torch.from_numpy(a.copy()) for a in (p, m, v, g))
    pc = torch.zeros(1037, dtype=torch.bfloat16) if copy else None
    adam_step(tp, tm, tv, tg, step=torch.tensor(3), scale=2.0, p_copy=pc,
              **kw)
    for got, w in zip((tp, tm, tv), want[:3]):
        assert _ulps(got.numpy(), np.asarray(w)) <= 1
    if copy:
        np.testing.assert_array_equal(
            pc.float().numpy(), np.asarray(want[3].astype(jnp.float32)))


@pytest.mark.parametrize("eps_mode", [EPS_MODE_OUTSIDE, EPS_MODE_INSIDE])
def test_adam_step_on_bf16_param_and_grad_matches_jax(eps_mode):
    """O3's case (no master weights): a bf16 parameter stepped with its
    bf16 gradient, moments in fp32.  Both sides widen p and g to fp32 and
    round the new p to bf16 once; that rounding may differ by one bf16
    ulp where the fp32 values differ by their one ulp."""
    p, m, v, g = _state(1037, 11)
    p16 = torch.from_numpy(p).to(torch.bfloat16)
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              eps_mode=eps_mode)
    want = jax_adam_step(jnp.asarray(p16.float().numpy(), jnp.bfloat16),
                         jnp.asarray(m), jnp.asarray(v),
                         jnp.asarray(g16.float().numpy(), jnp.bfloat16),
                         step=jnp.asarray(2, jnp.int32), **kw)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    adam_step(p16, tm, tv, g16, step=torch.tensor(2), **kw)
    assert p16.dtype == torch.bfloat16
    want_p = torch.tensor(np.asarray(want[0].astype(jnp.float32)))
    assert bf16_ulp_distance(p16, want_p.to(torch.bfloat16)) <= 1
    assert _ulps(tm.numpy(), np.asarray(want[1])) <= 1
    assert _ulps(tv.numpy(), np.asarray(want[2])) <= 1


def test_kernel_plain_version_is_what_the_wrapper_runs_on_the_cpu():
    p, m, v, g = _state(100, 3)
    a = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    b = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    tg = torch.from_numpy(g)
    ss, sc = torch.tensor([1e-3]), torch.tensor([1.0])
    before = packed_adam.launches
    packed_adam(*a, tg, ss, sc, None, beta1=0.9, beta2=0.999, eps=1e-8)
    packed_adam_ref(*b, tg, ss, sc, None, beta1=0.9, beta2=0.999, eps=1e-8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert packed_adam.launches == before


def test_noop_flag_writes_nothing():
    p, m, v, g = _state(50, 4)
    t = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    pc = torch.full((50,), 7.0, dtype=torch.bfloat16)
    packed_adam(*t, torch.from_numpy(g), torch.tensor([1e-3]),
                torch.tensor([1.0]), torch.ones(1, dtype=torch.int32),
                beta1=0.9, beta2=0.999, eps=1e-8, p_copy=pc)
    for x, y in zip(t, (p, m, v)):
        np.testing.assert_array_equal(x.numpy(), y)
    assert torch.all(pc == 7.0)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "c": rng.standard_normal((2, 2, 2)).astype(np.float32)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_fused_adam_matches_jax_over_three_updates(weight_decay):
    """Per-leaf step counts and bias correction over 3 updates; the port
    takes one more call, with the device noop flag set, which must change
    nothing (not even the step counts)."""
    params = _tree(0)
    grads = [_tree(s) for s in (1, 2, 3)]
    tx = jax_fused_adam(learning_rate=1e-2, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = FusedAdam(list(tp.values()), lr=1e-2, weight_decay=weight_decay,
                    device="cpu")
    flags = [0, 1, 0, 0]
    gi = iter(grads)
    for f in flags:
        g = grads[0] if f else next(gi)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step(noop_flag=torch.tensor([f], dtype=torch.int32))
    for k, t in tp.items():
        st = opt.state[t]
        assert int(st["step"]) == int(js.leaf_step[k]) == 3
        assert _ulps(t.numpy(), np.asarray(jp[k])) <= 1, k
        assert _ulps(st["exp_avg"].numpy(), np.asarray(js.m[k])) <= 1
        assert _ulps(st["exp_avg_sq"].numpy(), np.asarray(js.v[k])) <= 1


def test_constructor_refusals_match_the_reference():
    w = [torch.zeros(3)]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(w, amsgrad=True)
    with pytest.raises(RuntimeError, match="max_grad_norm"):
        FusedAdam(w, max_grad_norm=1.0)
