"""The port's fused Adam (K5's and K11's plain versions, ``adam_step``
and the ``FusedAdam`` optimizer, whose step is K11 over each parameter
group, on the CPU) against the JAX package's ``adam_step`` and
``fused_adam`` (its jnp path).

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
from apex_tpu_torch.ops.cuda import (
    packed_adam,
    packed_adam_ref,
    packed_adam_tree,
    packed_adam_tree_ref,
)
from apex_tpu_torch.ops.cuda.adam import _sqrt_rn
from apex_tpu_torch.ops.multi_tensor import ChunkTable
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


def test_plain_sqrt_is_correctly_rounded_where_torchs_is_not():
    """Why K5's and K11's plain version takes its sqrt through fp64: at
    v = 0x3a3a7114 PyTorch's fp32 ``torch.sqrt`` on the CPU returns the
    float one ulp below the nearest one, while ``_sqrt_rn`` (the kernels'
    ``__fsqrt_rn``), numpy and XLA (the JAX package's ``adam_step``)
    return the nearest, checked here in exact rationals."""
    from fractions import Fraction
    x = np.full(64, 0x3A3A7114, np.int32).view(np.float32)
    got = _sqrt_rn(torch.from_numpy(x)).numpy()
    r = got[0]
    lo, hi = (np.nextafter(r, np.float32(d)) for d in (0, np.inf))
    fx, fr = Fraction(float(x[0])), Fraction(float(r))
    assert ((Fraction(float(lo)) + fr) / 2) ** 2 < fx \
        < ((fr + Fraction(float(hi))) / 2) ** 2
    assert np.all(got == r)
    np.testing.assert_array_equal(got, np.sqrt(x))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))
    theirs = torch.sqrt(torch.from_numpy(x)).numpy()
    assert _ulps(theirs, got) == 1 and np.all(theirs < got)


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


def _group_tree(seed, dtype):
    rng = np.random.RandomState(seed)
    shapes = {"a": (3, 5), "b": (70001,), "c": (2, 2, 2), "d": (7,)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps_inside", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fused_adam_groups_through_k11_match_jax_per_leaf(weight_decay,
                                                          eps_inside, dtype):
    """Two parameter groups (lr 1e-2 over a, b; 3e-3 over c, d), one step
    through K11's plain version against the JAX per-leaf update
    (``adam_step``, what ``fused_adam`` runs on each leaf before optax
    adds the delta back, a second rounding the port does not make), fp32
    or bf16 (O3) parameters, then a step under the noop flag that changes
    nothing."""
    params, grads = _group_tree(0, dtype), _group_tree(1, dtype)
    lrs = {"a": 1e-2, "b": 1e-2, "c": 3e-3, "d": 3e-3}
    tp = {k: v.clone() for k, v in params.items()}
    opt = FusedAdam([{"params": [tp["a"], tp["b"]]},
                     {"params": [tp["c"], tp["d"]], "lr": 3e-3}], lr=1e-2,
                    weight_decay=weight_decay, eps_inside_sqrt=eps_inside,
                    device="cpu")
    for k, t in tp.items():
        t.grad = grads[k].clone()
    opt.step()
    kept = {k: (t.clone(), opt.state[t]["exp_avg"].clone()) for k, t in
            tp.items()}
    opt.step(noop_flag=torch.ones(1, dtype=torch.int32))
    mode = EPS_MODE_INSIDE if eps_inside else EPS_MODE_OUTSIDE
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for k, t in tp.items():
        st = opt.state[t]
        assert torch.equal(t, kept[k][0])
        assert torch.equal(st["exp_avg"], kept[k][1])
        assert int(st["step"]) == 1
        p32 = params[k].float().numpy()
        want_p, want_m, want_v = jax_adam_step(
            jnp.asarray(p32).astype(jdt), jnp.zeros(p32.shape),
            jnp.zeros(p32.shape),
            jnp.asarray(grads[k].float().numpy()).astype(jdt), lr=lrs[k],
            beta1=0.9, beta2=0.999, eps=1e-8,
            step=jnp.asarray(1, jnp.int32), weight_decay=weight_decay,
            eps_mode=mode)
        assert t.dtype == dtype
        if dtype == torch.float32:
            assert _ulps(t.numpy(), np.asarray(want_p)) <= 1, k
        else:
            assert bf16_ulp_distance(t, torch.tensor(np.asarray(
                want_p.astype(jnp.float32))).to(torch.bfloat16)) <= 1, k
        assert _ulps(st["exp_avg"].numpy(), np.asarray(want_m)) <= 1
        assert _ulps(st["exp_avg_sq"].numpy(), np.asarray(want_v)) <= 1


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_k11_plain_version_is_k5s_leaf_by_leaf(p_dtype, g_dtype):
    """K11's plain version (and its wrapper on the CPU, which launches
    nothing) equals ``packed_adam_ref`` run leaf by leaf with each leaf's
    own step size, bf16 copies and all, and writes nothing under the noop
    flag."""
    sizes = [1000, 2 * 1024 + 5, 0, 7]
    rng = np.random.RandomState(5)

    def leaves(dt, s=1.0):
        return [torch.from_numpy((rng.standard_normal(n) * s).astype(
            np.float32)).to(dt) for n in sizes]
    p, g = leaves(p_dtype), leaves(g_dtype)
    m, v = leaves(torch.float32, 0.1), [t.abs() for t in
                                        leaves(torch.float32, 0.01)]
    copies = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    table = ChunkTable(sizes, "cpu", chunk_size=1024)
    step_sizes = torch.tensor([1e-3, 2e-3, 3e-3, 4e-3])
    scale = torch.tensor([4.0])
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              eps_mode=EPS_MODE_INSIDE)
    runs = []
    for fn in (packed_adam_tree, packed_adam_tree_ref, None):
        ts = [[t.clone() for t in ls] for ls in (p, m, v, copies)]
        if fn is None:
            for i in range(len(sizes)):
                packed_adam_ref(ts[0][i], ts[1][i], ts[2][i], g[i],
                                step_sizes[i:i + 1], scale, None,
                                p_copy=ts[3][i], **kw)
        else:
            before = packed_adam_tree.launches
            fn(table, *ts[:3], g, step_sizes, scale, None, p_copy=ts[3],
               **kw)
            assert packed_adam_tree.launches == before
        runs.append(ts)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    kept = [[t.clone() for t in ls] for ls in runs[0]]
    packed_adam_tree(table, *runs[0][:3], g, step_sizes, scale,
                     torch.ones(1, dtype=torch.int32), p_copy=runs[0][3],
                     **kw)
    for a, b in zip(runs[0], kept):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="leaf sizes"):
        packed_adam_tree(table, p[:-1], m, v, g, step_sizes, scale, None,
                         **kw)


def test_fused_adam_splits_a_group_of_mixed_dtypes():
    """A group of fp32 parameters with bf16 and fp32 compute copies (O2
    with an fp32-kept normalization leaf) steps each leaf as ``adam_step``
    would, in one K11 call: an fp32 copy is the new parameter itself.  A
    group whose parameters mix dtypes (O3 with an fp32-kept normalization
    leaf) steps each leaf as ``adam_step`` would too, one K11 call per
    dtype, each leaf at its own step count."""
    rng = np.random.RandomState(6)
    arrs = [rng.standard_normal(n).astype(np.float32) for n in (9, 5, 12)]
    grads = [rng.standard_normal(a.shape).astype(np.float32) for a in arrs]
    tp = [torch.from_numpy(a.copy()) for a in arrs]
    for t, g in zip(tp, grads):
        t.grad = torch.from_numpy(g)
    copies = [torch.zeros(9, dtype=torch.bfloat16),
              torch.zeros(5, dtype=torch.bfloat16), torch.zeros(12)]
    opt = FusedAdam(tp, lr=1e-2, device="cpu")
    opt.step(model_params=copies)
    assert len(opt.tables) == 1
    for a, g, t, c in zip(arrs, grads, tp, copies):
        want = torch.from_numpy(a.copy())
        m, v = torch.zeros(a.shape), torch.zeros(a.shape)
        pc = torch.zeros(a.shape, dtype=c.dtype)
        adam_step(want, m, v, torch.from_numpy(g), lr=1e-2, beta1=0.9,
                  beta2=0.999, eps=1e-8, step=torch.tensor(1), p_copy=pc)
        assert torch.equal(t, want)
        assert torch.equal(c, pc)
    with pytest.raises(ValueError, match="model_params has"):
        opt.step(model_params=copies[:2])
    mixed = [torch.zeros(3), torch.zeros(4, dtype=torch.bfloat16),
             torch.zeros(5)]
    for t in mixed:
        t.grad = torch.ones_like(t)
    opt = FusedAdam(mixed, lr=1e-2, device="cpu")
    opt.step()
    assert len(opt.tables) == 2
    assert [int(opt.state[t]["step"]) for t in mixed] == [1, 1, 1]
    for t in mixed:
        want = torch.zeros_like(t)
        m = torch.zeros(t.shape)
        v = torch.zeros(t.shape)
        adam_step(want, m, v, torch.ones_like(t), lr=1e-2, beta1=0.9,
                  beta2=0.999, eps=1e-8, step=torch.tensor(1))
        assert torch.equal(t, want)
        assert torch.equal(opt.state[t]["exp_avg"], m)
