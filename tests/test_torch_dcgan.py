"""The port's DCGAN (BASELINE config 5: ``models/dcgan.py``,
``layers.ConvTranspose``, the conv route's transposed conv) against the
JAX package's ``apex_tpu.models.dcgan`` and ``lax.conv_transpose``, on
the CPU.

Tolerances:

- The transposed conv, fp32, its output and its gradients w.r.t. input
  and kernel: within ``1e-5`` (both are exact fp32 convolutions, summed
  in other orders).
- G and D forwards in fp32 (train mode: batch statistics; then the
  running statistics they leave and an eval-mode forward on them):
  within ``1e-4`` of JAX (the BatchNorms normalize sums of up to 4096
  products).
- The two-scaler O1 loop of ``examples/dcgan_main_amp.py`` (fm 8, zdim
  16, 32^2, B 8, Adam(2e-4, b1 0.5)), 4 iterations with D's loss
  overflowed at iteration 1: the loss scales and the skips equal JAX's at
  every step (D's scale halves and D's step is skipped, G's are not);
  the losses within ``2e-2`` (bf16 products rounded at other places,
  fed back through BatchNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from apex_tpu import amp as jax_amp
from apex_tpu.models.dcgan import Discriminator as JaxD
from apex_tpu.models.dcgan import Generator as JaxG
from apex_tpu.models.dcgan import gan_losses as jax_gan_losses
from apex_tpu_torch import amp
from apex_tpu_torch.amp import ops
from apex_tpu_torch.convert import dcgan_params_from_jax
from apex_tpu_torch.models.dcgan import (
    d_loss,
    dcgan_step,
    frozen_stats,
    gan_losses,
)

NHWC = ("NHWC", "HWIO", "NHWC")


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (0, 1))])
@pytest.mark.parametrize("kernel,strides,dil", [(4, 2, 1), (3, 2, 1),
                                                (3, 1, 1), (2, 3, 1),
                                                (3, 2, 2)])
@pytest.mark.parametrize("transpose_kernel", [False, True])
def test_transposed_conv_matches_lax(padding, kernel, strides, dil,
                                     transpose_kernel):
    rng = np.random.RandomState(kernel * 10 + strides)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32)
    if transpose_kernel:
        w = np.ascontiguousarray(w.transpose(0, 1, 3, 2))
    kw = dict(rhs_dilation=(dil, dil), dimension_numbers=NHWC,
              transpose_kernel=transpose_kernel)

    def jf(x, w):
        return lax.conv_transpose(x, w, (strides, strides), padding, **kw)

    want = jf(jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = ops.conv_transpose(tx, tw, (strides, strides), padding, **kw)
    got.backward(torch.from_numpy(g))
    for name, a, b in (("y", got, want), ("dx", tx.grad, jdx),
                       ("dw", tw.grad, jdw)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_conv_general_dilated_takes_lhs_dilation_as_lax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((1, 4, 5, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 3)).astype(np.float32)
    for pad in ("SAME", "VALID"):
        with pytest.raises(ValueError, match="String padding"):
            lax.conv_general_dilated(
                jnp.asarray(x), jnp.asarray(w), (1, 2), pad,
                lhs_dilation=(2, 3), dimension_numbers=NHWC)
        with pytest.raises(ValueError, match="String padding"):
            ops.conv_general_dilated(
                torch.from_numpy(x), torch.from_numpy(w), (1, 2), pad,
                lhs_dilation=(2, 3), dimension_numbers=NHWC)
    for pad in (((2, 1), (1, 2)), ((0, 0), (3, 0)), ((-1, 2), (1, 1))):
        want = lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1, 2), pad, lhs_dilation=(2, 3),
            dimension_numbers=NHWC)
        got = ops.conv_general_dilated(
            torch.from_numpy(x), torch.from_numpy(w), (1, 2), pad,
            lhs_dilation=(2, 3), dimension_numbers=NHWC)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


FM, ZDIM, SIZE, B = 8, 16, 32, 8


def _jax_nets(seed=0):
    G, D = JaxG(feature_maps=FM, n_upsample=2), JaxD(feature_maps=FM,
                                                      n_down=3)
    gv = G.init(jax.random.PRNGKey(seed), jnp.zeros((2, ZDIM)), train=True)
    dv = D.init(jax.random.PRNGKey(seed + 1),
                jnp.zeros((2, SIZE, SIZE, 3)), train=True)
    return G, D, gv, dv


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(seed, n=1):
    rng = np.random.RandomState(seed)
    z = rng.standard_normal((n, B, ZDIM)).astype(np.float32)
    real = np.tanh(rng.standard_normal((n, B, SIZE, SIZE, 3))).astype(
        np.float32)
    return z, real


def test_generator_and_discriminator_match_jax():
    G, D, gv, dv = _jax_nets()
    tg, td = dcgan_params_from_jax(_np(gv), _np(dv), FM, 2, ZDIM, SIZE,
                                   device="cpu", trainable=True)
    z, real = _data(2)
    img, gmut = G.apply(gv, jnp.asarray(z[0]), train=True,
                        mutable=["batch_stats"])
    logits, dmut = D.apply(dv, jnp.asarray(real[0]), train=True,
                           mutable=["batch_stats"])
    timg = tg(torch.from_numpy(z[0]), train=True)
    tlogits = td(torch.from_numpy(real[0]), train=True)
    assert timg.shape == (B, SIZE, SIZE, 3) and tlogits.shape == (B, 1)
    np.testing.assert_allclose(timg.detach().numpy(), np.asarray(img),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=0, atol=1e-4)
    for (name, buf) in tg.named_buffers():
        mod, leaf = name.split(".")
        np.testing.assert_allclose(
            buf.numpy(), np.asarray(gmut["batch_stats"][mod][leaf]),
            rtol=0, atol=1e-5, err_msg=name)
    # eval mode on the running statistics just updated
    ev = D.apply({"params": dv["params"], **dmut}, jnp.asarray(real[0]),
                 train=False)
    np.testing.assert_allclose(
        td(torch.from_numpy(real[0]), train=False).detach().numpy(),
        np.asarray(ev), rtol=0, atol=1e-4)
    jd, jg = jax_gan_losses(logits, logits, logits)
    td_, tg_ = gan_losses(tlogits, tlogits, tlogits)
    np.testing.assert_allclose([float(td_.detach()), float(tg_.detach())],
                               [float(jd), float(jg)], rtol=0, atol=1e-5)


def test_frozen_stats_restores_running_statistics():
    _, _, gv, dv = _jax_nets()
    tg, _ = dcgan_params_from_jax(_np(gv), _np(dv), FM, 2, ZDIM, SIZE,
                                  device="cpu", trainable=True)
    before = {n: b.clone() for n, b in tg.named_buffers()}
    with frozen_stats(tg):
        tg(torch.randn(B, ZDIM), train=True)
    assert all(torch.equal(b, before[n]) for n, b in tg.named_buffers())
    tg(torch.randn(B, ZDIM), train=True)
    assert not all(torch.equal(b, before[n]) for n, b in tg.named_buffers())


STEPS = 4
POISON_AT = 1


def _jax_loop(G, D, gv, dv, zs, reals):
    adam = lambda: optax.adam(2e-4, b1=0.5, b2=0.999)  # noqa: E731
    a_g = jax_amp.initialize(optimizer=adam(), opt_level="O1", verbosity=0)
    a_d = jax_amp.initialize(optimizer=adam(), opt_level="O1", verbosity=0)
    gs, ds = a_g.init(gv["params"]), a_d.init(dv["params"])
    g_stats, d_stats = gv["batch_stats"], dv["batch_stats"]

    def d_loss_fn(dp, gp, z, real, poison):
        fake = G.apply({"params": gp, "batch_stats": g_stats}, z,
                       train=True, mutable=["batch_stats"])[0]
        d_real, d_mut = D.apply({"params": dp, "batch_stats": d_stats},
                                real, train=True, mutable=["batch_stats"])
        d_fake, d_mut = D.apply({"params": dp, "batch_stats":
                                 d_mut["batch_stats"]},
                                jax.lax.stop_gradient(fake), train=True,
                                mutable=["batch_stats"])
        loss, _ = jax_gan_losses(d_real, d_fake, d_fake)
        return loss * (1.0 + poison), d_mut["batch_stats"]

    def g_loss_fn(gp, dp, z):
        fake, g_mut = G.apply({"params": gp, "batch_stats": g_stats}, z,
                              train=True, mutable=["batch_stats"])
        logits, d_mut = D.apply({"params": dp, "batch_stats": d_stats},
                                fake, train=True, mutable=["batch_stats"])
        _, loss = jax_gan_losses(logits, logits, logits)
        return loss, (g_mut["batch_stats"], d_mut["batch_stats"])

    out = []
    for i in range(STEPS):
        z, real = jnp.asarray(zs[i]), jnp.asarray(reals[i])
        poison = jnp.float32(np.inf if i == POISON_AT else 0.0)

        def scaled_d(dp):
            l, st = a_d.run(d_loss_fn, dp, a_g.model_params(gs), z, real,
                            poison)
            return a_d.scale_loss(l, ds), (l, st)
        dg, (dl, d_stats) = jax.grad(scaled_d, has_aux=True)(
            a_d.model_params(ds))
        ds, d_info = a_d.apply_gradients(ds, dg)

        def scaled_g(gp):
            l, st = a_g.run(g_loss_fn, gp, a_d.model_params(ds), z)
            return a_g.scale_loss(l, gs), (l, st)
        gg, (gl, (g_stats, d_stats)) = jax.grad(scaled_g, has_aux=True)(
            a_g.model_params(gs))
        gs, g_info = a_g.apply_gradients(gs, gg)
        out.append({"d_loss": float(dl), "g_loss": float(gl),
                    "d_scale": float(d_info["loss_scale"]),
                    "g_scale": float(g_info["loss_scale"]),
                    "d_overflow": bool(d_info["overflow"]),
                    "g_overflow": bool(g_info["overflow"])})
    return out


def test_two_scaler_o1_loop_matches_jax():
    from apex_tpu_torch.optimizers import FusedAdam
    G, D, gv, dv = _jax_nets(3)
    zs, reals = _data(4, STEPS)
    want = _jax_loop(G, D, gv, dv, zs, reals)
    tg, td = dcgan_params_from_jax(_np(gv), _np(dv), FM, 2, ZDIM, SIZE,
                                   device="cpu", trainable=True)
    a_g = amp.initialize(tg, FusedAdam(tg.parameters(), lr=2e-4,
                                       betas=(0.5, 0.999), device="cpu"),
                         device="cpu")
    a_d = amp.initialize(td, FusedAdam(td.parameters(), lr=2e-4,
                                       betas=(0.5, 0.999), device="cpu"),
                         device="cpu")
    got = []
    for i in range(STEPS):
        poison = float("inf") if i == POISON_AT else 0.0

        def poisoned(D_, G_, z, real):
            return d_loss(D_, G_, z, real) * (1.0 + poison)
        d_before = {n: p.detach().clone() for n, p in td.named_parameters()}
        g_before = {n: p.detach().clone() for n, p in tg.named_parameters()}
        info = dcgan_step(a_g, a_d, torch.from_numpy(zs[i]),
                          torch.from_numpy(reals[i]), d_loss_fn=poisoned)
        d_moved = any(not torch.equal(p, d_before[n])
                      for n, p in td.named_parameters())
        g_moved = any(not torch.equal(p, g_before[n])
                      for n, p in tg.named_parameters())
        assert d_moved == (i != POISON_AT) and g_moved
        got.append({"d_loss": float(info["d"]["loss"]),
                    "g_loss": float(info["g"]["loss"]),
                    "d_scale": float(info["d"]["loss_scale"]),
                    "g_scale": float(info["g"]["loss_scale"]),
                    "d_overflow": bool(info["d"]["overflow"]),
                    "g_overflow": bool(info["g"]["overflow"])})
    for w, g in zip(want, got):
        for k in ("d_scale", "g_scale", "d_overflow", "g_overflow"):
            assert w[k] == g[k], (k, want, got)
        for k in ("d_loss", "g_loss"):
            if np.isfinite(w[k]):
                assert abs(w[k] - g[k]) <= 2e-2, (k, want, got)
            else:
                assert not np.isfinite(g[k])
    assert got[POISON_AT]["d_scale"] == got[0]["d_scale"] / 2
    assert got[POISON_AT]["g_scale"] == got[0]["g_scale"]
