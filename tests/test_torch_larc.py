"""The port's LARC (``apex_tpu_torch.optimizers.larc``) against the JAX
package's ``apex_tpu.optimizers.larc`` on the CPU: clip and scale modes
and zero norms (the cases of ``tests/l0/test_larc.py``), per-leaf norms
from K12's plain version; and a LARC-wrapped FusedAdam under amp O2, 3
steps against JAX's ``LARC(FusedAdam)`` under its O2, then an injected
overflow skipped through the device flag that LARC passes on.

Tolerances: the rescaled gradients within ``rtol 1e-5, atol 1e-6``
(``test_larc.py``'s; the norms sum in other orders).  O2: the bf16
products round at other places than XLA's: losses within ``1e-3``
relative, masters within ``1e-5`` (lr 1e-3 and LARC's trust ratio keep
each step's move far below that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import amp as jax_amp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import LARC as JaxLARC
from apex_tpu.optimizers import larc as jax_larc
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import LARC, FusedAdam, larc

LR = 0.1
TRUST = 0.02
WD = 0.01
EPS = 1e-8


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": rng.randn(300, 4).astype(np.float32)}


@pytest.mark.parametrize("clip", [True, False])
def test_rescaled_gradients_match_jax(clip):
    params, grads = _tree(0), _tree(1)
    tx = jax_larc(LR, trust_coefficient=TRUST, clip=clip, eps=EPS,
                  weight_decay=WD)
    want, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(params),
                        jax.tree.map(jnp.asarray, params))
    got = larc([torch.from_numpy(grads[k]) for k in sorted(grads)],
               [torch.from_numpy(params[k]) for k in sorted(params)], LR,
               trust_coefficient=TRUST, clip=clip, eps=EPS, weight_decay=WD)
    for k, g in zip(sorted(grads), got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_zero_norms_leave_the_gradient_untouched():
    tx = jax_larc(LR, weight_decay=WD)
    for p, g in ((np.zeros(3, np.float32), np.ones(3, np.float32)),
                 (np.ones(3, np.float32), np.zeros(3, np.float32))):
        want, _ = tx.update({"p": jnp.asarray(g)}, tx.init({"p": p}),
                            {"p": jnp.asarray(p)})
        got, = larc([torch.from_numpy(g)], [torch.from_numpy(p)], LR,
                    weight_decay=WD)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want["p"]))
        np.testing.assert_array_equal(got.numpy(), g)


def test_bf16_gradients_keep_their_dtype():
    p = torch.randn(6, generator=torch.Generator().manual_seed(2))
    g = p.flip(0).to(torch.bfloat16)
    got, = larc([g], [p], LR, weight_decay=WD)
    want, = larc([g.float()], [p], LR, weight_decay=WD)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


class _Linear(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.w + self.b


def _data():
    rng = np.random.RandomState(3)
    w = (rng.randn(16, 4) * 0.3).astype(np.float32)
    b = (rng.randn(4) * 0.1).astype(np.float32)
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randn(32, 4).astype(np.float32)
    return w, b, x, y


def test_larc_wrapped_fused_adam_under_o2_matches_jax(monkeypatch):
    w, b, x, y = _data()
    a = jax_amp.initialize(
        optimizer=JaxLARC(JaxFusedAdam(lr=1e-3), 1e-3,
                          trust_coefficient=TRUST, weight_decay=WD),
        opt_level="O2", verbosity=0)
    state = a.init({"b": jnp.asarray(b), "w": jnp.asarray(w)})

    def jloss(p, x, y):
        out = x @ p["w"] + p["b"]
        return jnp.mean(jnp.square(out.astype(jnp.float32) - y))

    jstep = jax.jit(jax_amp.make_train_step(a, jloss))
    jlosses = []
    for _ in range(3):
        state, m = jstep(state, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(m["loss"]))

    model = _Linear(w, b)
    opt = LARC(FusedAdam(model.parameters(), lr=1e-3, device="cpu"),
               trust_coefficient=TRUST, weight_decay=WD)
    t = amp.initialize(model, opt, opt_level="O2", device="cpu")
    seen = []
    inner = opt.optimizer.step
    monkeypatch.setattr(opt.optimizer, "step",
                        lambda **kw: (seen.append(kw), inner(**kw))[1])

    def tloss(m, x, y):
        return (m(x).float() - y).square().mean()

    step = amp.make_train_step(t, model, tloss)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(step(tx, ty)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for k in ("w", "b"):
        np.testing.assert_allclose(t.masters[k].numpy(),
                                   np.asarray(state.master_params[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    # the device skip flag and the compute copies reach FusedAdam
    assert all(kw["noop_flag"] is not None and kw["model_params"]
               for kw in seen) and len(seen) == 3
    masters = {k: v.clone() for k, v in t.masters.items()}
    scale = float(t.scaler_state.loss_scale)
    grads = [torch.full_like(p, float("inf")) for p in t.params]
    info = t.apply_gradients(grads)
    assert bool(info["overflow"])
    assert float(info["loss_scale"]) == scale / 2
    assert all(torch.equal(masters[k], v) for k, v in t.masters.items())


def test_larc_over_a_host_stepped_optimizer_reads_the_flag():
    p = nn.Parameter(torch.ones(4))
    opt = LARC(torch.optim.SGD([p], lr=LR), weight_decay=WD)
    p.grad = torch.full((4,), 0.5)
    opt.step(noop_flag=torch.ones(1, dtype=torch.int32))
    assert torch.equal(p.detach(), torch.ones(4))       # skipped
    opt.step(noop_flag=torch.zeros(1, dtype=torch.int32))
    assert not torch.equal(p.detach(), torch.ones(4))
    with pytest.raises(TypeError, match="model_params"):
        opt.step(model_params=[torch.zeros(4)])
