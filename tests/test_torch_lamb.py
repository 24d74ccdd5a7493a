"""The port's FusedLAMB (the plain versions of K7, K8 and K9 over a chunk
table, on the CPU) against the JAX package's ``fused_lamb`` (its jnp
path) followed by ``optax.apply_updates``, over 3 updates of a mixed
tree: a leaf larger than one chunk, a leaf that is not a multiple of 4,
a 0-dim leaf and an all-zero leaf (whose trust ratio falls back to lr).

Tolerance: masters within ``rtol = 1e-6`` plus ``atol = 2e-7``, m and v
within ``rtol = 1e-6`` plus ``atol = 1e-9``; leaf step counts equal.
Both sides run the same fp32 op order, but the port multiplies the
gradients by ``1 / clip`` (the Pallas kernel's form) where the jnp path
divides by ``clip``, and the norms and the global gradient norm are
summed in other orders (measured: masters within 3.0e-8, m within
4.7e-10, v within 1.8e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.optimizers.fused_lamb import fused_lamb as jax_fused_lamb
from apex_tpu_torch.ops.cuda import (
    lamb_stage1,
    lamb_stage1_ref,
    lamb_stage2,
    lamb_stage2_ref,
    packed_sumsq,
    packed_sumsq_ref,
)
from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE, ChunkTable
from apex_tpu_torch.optimizers import FusedLAMB

#: leaf name -> shape; sorted, so the JAX flatten order is this order
SHAPES = {"a_big": (CHUNK_SIZE + 1003,), "b_odd": (37, 53),
          "c_scalar": (), "d_zero": (8, 16), "e_deep": (8, 3, 5)}


def _tree(seed, scale=1.0, zero=True):
    rng = np.random.RandomState(seed)
    out = {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
           for k, s in SHAPES.items()}
    if zero:
        out["d_zero"] = np.zeros(SHAPES["d_zero"], np.float32)
    return out


def _jax_run(params, grads, **kw):
    tx = jax_fused_lamb(learning_rate=1e-2, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
    return jp, js


def _torch_opt(params, **kw):
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = FusedLAMB(list(tp.values()), lr=1e-2, device="cpu", **kw)
    return tp, opt


def _set_grads(tp, g):
    for k, t in tp.items():
        t.grad = torch.from_numpy(g[k].copy())


CASES = {
    "clip_active": dict(max_grad_norm=0.5, weight_decay=0.01),
    "clip_off": dict(max_grad_norm=0.0, weight_decay=0.01),
    "no_bias_correction": dict(bias_correction=False, weight_decay=0.01),
    "no_weight_decay": dict(weight_decay=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_lamb_matches_jax_over_three_updates(case):
    kw = CASES[case]
    params = _tree(0, 0.1)
    grads = [_tree(s, zero=False) for s in (1, 2, 3)]
    jp, js = _jax_run(params, grads, **kw)
    tp, opt = _torch_opt(params, **kw)
    for g in grads:
        _set_grads(tp, g)
        opt.step()
    for k, t in tp.items():
        st = opt.state[t]
        assert int(st["step"]) == int(js.leaf_step[k]) == 3
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=2e-7, err_msg=k)
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(js.m[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(js.v[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert int(opt.param_groups[0]["step"]) == int(js.step) == 3
    # the zero leaf moved by lr * u (the ratio's fallback), away from 0
    assert float(tp["d_zero"].abs().max()) > 0


def _ulps(a, b):
    """Largest distance in fp32 units in the last place."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max())


def test_stage1_equals_jaxs_update_expression_to_the_ulp():
    """Stage 1's plain version against the expression of the JAX
    package's ``fused_lamb`` loop (``m``, ``v``, then ``m_hat / (sqrt(v_hat)
    + eps) + weight_decay * p``) on the same fp32 inputs: every op is the
    same correctly rounded fp32 op, the square root included (the plain
    version takes K7's ``__fsqrt_rn`` through fp64), so m, v and u are
    equal bit for bit.  PyTorch's own fp32 ``torch.sqrt`` on the CPU is
    one ulp off at some of these ``v_hat`` (about 0.7% of them)."""
    rng = np.random.RandomState(11)
    n = 4096
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    b1, b2, eps, wd = 0.9, 0.999, 1e-6, 0.01
    bc1, bc2 = np.float32(1 - b1 ** 3), np.float32(1 - b2 ** 3)
    jm = b1 * jnp.asarray(m) + (1.0 - b1) * jnp.asarray(g)
    jv = b2 * jnp.asarray(v) + (1.0 - b2) * jnp.asarray(g) * jnp.asarray(g)
    ju = (jm / bc1) / (jnp.sqrt(jv / bc2) + eps) + wd * jnp.asarray(p)
    vhat = torch.from_numpy(np.asarray(jv / bc2))
    assert int((torch.sqrt(vhat) != torch.sqrt(vhat.double()).float())
               .sum()) > 0
    table = ChunkTable([n], "cpu", chunk_size=256)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    tu = torch.zeros(n)
    lamb_stage1_ref(table, [torch.from_numpy(p)], [torch.from_numpy(g)],
                    [tm], [tv], [tu], torch.tensor([bc1]),
                    torch.tensor([bc2]), None, None, beta1=b1, beta2=b2,
                    eps=eps, weight_decay=wd, max_grad_norm=0.0)
    for got, want in ((tm, jm), (tv, jv), (tu, ju)):
        assert _ulps(got.numpy(), np.asarray(want)) == 0


@pytest.mark.parametrize("bias_correction", [True, False])
def test_moments_equal_jax_bit_for_bit_without_the_clip(bias_correction):
    """Over 3 updates without the gradient clip, m and v take the same
    fp32 ops on both sides and are equal bit for bit.  The masters are
    not held to the ulp: the trust ratio's two norms are summed in
    another order (K7's per-chunk partials), so the ratio differs in its
    last bits, and where ``p - ratio * u`` cancels toward 0 that is many
    ulps of the small result (measured up to 1280 ulps, 3.0e-8
    absolute: the tolerance of ``test_fused_lamb_matches_jax_over_three_
    updates``).  With the clip, the port multiplies by ``1 / clip`` (the
    Pallas kernel's form) where the jnp path divides."""
    kw = dict(CASES["clip_off"], bias_correction=bias_correction)
    params = _tree(0, 0.1)
    grads = [_tree(s, zero=False) for s in (1, 2, 3)]
    _, js = _jax_run(params, grads, **kw)
    tp, opt = _torch_opt(params, **kw)
    for g in grads:
        _set_grads(tp, g)
        opt.step()
    for k, t in tp.items():
        st = opt.state[t]
        assert _ulps(st["exp_avg"].numpy(), np.asarray(js.m[k])) == 0, k
        assert _ulps(st["exp_avg_sq"].numpy(), np.asarray(js.v[k])) == 0, k


def test_the_clip_is_active_in_that_case():
    g = _tree(1, zero=False)
    norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                       for x in g.values()))
    assert norm > 10 * CASES["clip_active"]["max_grad_norm"]


def test_a_step_under_the_noop_flag_changes_nothing():
    params = _tree(0, 0.1)
    grads = [_tree(s, zero=False) for s in (1, 2)]
    tp, opt = _torch_opt(params)
    copies = [torch.zeros(t.shape, dtype=torch.bfloat16)
              for t in tp.values()]
    _set_grads(tp, grads[0])
    opt.step(noop_flag=torch.zeros(1, dtype=torch.int32),
             model_params=copies)
    for t, c in zip(tp.values(), copies):
        assert torch.equal(c, t.to(torch.bfloat16))
    before = {k: (t.clone(), opt.state[t]["exp_avg"].clone(),
                  opt.state[t]["exp_avg_sq"].clone()) for k, t in
              tp.items()}
    copies_before = [c.clone() for c in copies]
    bad = dict(grads[1])
    bad["b_odd"] = bad["b_odd"].copy()
    bad["b_odd"][3, 4] = np.inf
    _set_grads(tp, bad)
    opt.step(noop_flag=torch.ones(1, dtype=torch.int32),
             model_params=copies)
    for k, t in tp.items():
        st = opt.state[t]
        assert torch.equal(t, before[k][0])
        assert torch.equal(st["exp_avg"], before[k][1])
        assert torch.equal(st["exp_avg_sq"], before[k][2])
        assert int(st["step"]) == 1
    assert int(opt.param_groups[0]["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(copies, copies_before))


def test_the_chunk_table():
    t = ChunkTable([5, 0, 9, 4], "cpu", chunk_size=4)
    assert t.n_chunks == 2 + 0 + 3 + 1
    assert t.first_chunk == (0, 2, 2, 5, 6)
    assert t.chunk_leaf.tolist() == [0, 0, 2, 2, 2, 3]
    assert t.chunk_start.tolist() == [0, 4, 0, 4, 8, 0]
    buf, views = t.flat_views([(5,), (0,), (3, 3), (2, 2)])
    assert [v.shape for v in views] == [(5,), (0,), (3, 3), (2, 2)]
    assert all(v.storage_offset() % 64 == 0 for v in views)
    x = torch.arange(9.0)
    np.testing.assert_allclose(t.leaf_chunk_sums(x).numpy(),
                               [0 + 1 + 4 + 9, 16 + 25 + 36 + 49, 64])
    with pytest.raises(ValueError, match="multiple of 4"):
        ChunkTable([3], "cpu", chunk_size=6)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper is its plain version, and no launch is
    counted."""
    rng = np.random.RandomState(5)
    sizes = [70, 3, 0, 130]
    table = ChunkTable(sizes, "cpu", chunk_size=64)
    mk = lambda s=1.0: [torch.from_numpy(
        (rng.standard_normal(n) * s).astype(np.float32)) for n in sizes]
    p, g, m = mk(), mk(), mk(0.1)
    v = [x.abs() for x in mk(0.01)]
    twins = [[x.clone() for x in xs] for xs in (p, m, v)]
    u, u2 = [torch.zeros(n) for n in sizes], [torch.zeros(n) for n in sizes]
    steps = torch.ones(len(sizes), dtype=torch.int32)
    bc = (1 - 0.9 ** steps.float(), 1 - 0.999 ** steps.float())
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              max_grad_norm=1.0)
    counts = (lamb_stage1.launches, lamb_stage2.launches,
              packed_sumsq.launches)
    s = packed_sumsq(table, g)
    assert torch.equal(s, packed_sumsq_ref(table, g))
    np.testing.assert_allclose(
        float(s), sum(float((x.double() ** 2).sum()) for x in g), rtol=1e-6)
    a = lamb_stage1(table, p, g, m, v, u, *bc, s, None, **kw)
    b = lamb_stage1_ref(table, twins[0], g, twins[1], twins[2], u2, *bc, s,
                        None, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (table.n_chunks,)
    lamb_stage2(table, p, u, *a, None, lr=1e-2)
    lamb_stage2_ref(table, twins[0], u2, *b, None, lr=1e-2)
    assert all(torch.equal(x, y) for x, y in zip(p, twins[0]))
    assert (lamb_stage1.launches, lamb_stage2.launches,
            packed_sumsq.launches) == counts


def test_one_parameter_group_and_every_grad():
    w = [torch.zeros(3), torch.zeros(2)]
    opt = FusedLAMB([{"params": [w[0]]}, {"params": [w[1]]}], device="cpu")
    for t in w:
        t.grad = torch.ones_like(t)
    with pytest.raises(ValueError, match="one parameter group"):
        opt.step()
    opt = FusedLAMB(w, device="cpu")
    w[1].grad = None
    with pytest.raises(RuntimeError, match="no grad"):
        opt.step()


def test_pointer_rows_are_uploaded_once_per_storage():
    t = ChunkTable([5, 9], "cpu", chunk_size=4)
    a, b = [torch.zeros(5), torch.zeros(9)], [torch.ones(5), torch.ones(9)]
    rows = [t.pointers(a), t.pointers(b), t.pointers(a)]
    assert rows[0].tolist() == [x.data_ptr() for x in a]
    assert rows[2] is rows[0]
    assert (t.lookups, t.uploads) == (3, 2)


def test_amp_unscales_into_the_same_gradient_buffers_every_step():
    """Under O2 the masters' gradients are buffers that keep their storage
    from step to step (so FusedLAMB's pointer rows are uploaded once), and
    the unscale into them equals the unscale into fresh tensors."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.models import bert_tiny
    from apex_tpu_torch.models.bert import BertForPreTraining
    torch.manual_seed(0)
    model = BertForPreTraining(bert_tiny(), device="cpu")
    opt = FusedLAMB(model.parameters(), device="cpu")
    seen = []
    step_of = opt.step

    def spy(*args, **kw):
        seen.append([t.grad.data_ptr() for t in
                     opt.param_groups[0]["params"]])
        return step_of(*args, **kw)
    opt.step = spy
    a = amp.initialize(model, opt, opt_level="O2", device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, x: sum(o.float().square().mean() for o in m(x)))
    ids = torch.randint(0, 1024, (2, 16))
    for _ in range(3):
        step(ids)
    assert len(seen) == 3 and seen[0] == seen[1] == seen[2]
    assert opt.table.uploads == 0          # plain versions: no rows
    scaler = LossScaler(loss_scale="dynamic")
    state = scaler.init_state("cpu")
    grads = [torch.randn(4, 3).to(torch.bfloat16), torch.randn(7)
             .to(torch.bfloat16)]
    fresh, f1 = scaler.unscale(grads, state)
    bufs = [torch.full((4, 3), 9.0), torch.full((7,), 9.0)]
    kept, f2 = scaler.unscale(grads, state, out=bufs)
    assert all(k is b for k, b in zip(kept, bufs))
    assert all(torch.equal(x, y) for x, y in zip(fresh, kept))
    assert int(f1) == int(f2) == 0
