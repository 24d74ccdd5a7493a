"""The port's ResNet training path against the JAX package's, on the CPU
(the kernels' plain versions): small ResNets (``stage_sizes (1, 1, 1,
1)``, width 8, 10 classes: both stride-2 paths, stage 0's stride-1
projection and the max-pool) with the ``conv7`` and ``s2d`` stems, and a
BasicBlock ResNet18, converted by ``resnet_params_from_jax``; then the
step of ``examples/imagenet_main_amp.py`` (``amp.make_train_step`` +
``FusedAdam(lr=1e-3)`` against JAX ``make_train_step(has_aux=True)``).

Tolerances and why:

- Logits ``atol = 5e-5`` (measured at most 1.4e-5; fc's weights are
  drawn at std 0.01).  BatchNorm over 4 images is ill-conditioned: JAX's
  own gradients move by 2.6e-5 of their largest element when its
  parameters move by 1e-7 relative (measured), and the one-pass variance
  loses bits to cancellation.
- O0 first-step gradients: each leaf within ``1e-4`` of its largest
  element (measured at most 6e-5).
- O0, 3 steps at B 8 x 32^2: losses within ``1e-5`` (measured 2.9e-6);
  running stats within ``1e-4`` (relative above 1; measured 2.3e-5);
  masters: every element within ``1e-3`` (lr: Adam's first step moves
  each element by about lr times the sign of its gradient, so where a
  gradient is within rounding of 0 the two may step apart; measured
  2.0e-4) and all but 1% within ``1e-5`` (measured 0.13%).
- O2, the same 3 steps: losses within ``3e-2`` of JAX's O2 (measured
  0.020), the first within ``1e-2`` of JAX's fp32 loss (measured 4.4e-3),
  equal loss scales and overflow flags.  At this size the bf16
  gradients are mostly rounding noise in both frameworks: each leaf's
  first bf16 gradient lies 8-110% of its largest element from the fp32
  one, in JAX as in the port (measured), so from the second step the
  two O2 runs follow different noise (JAX's own O2 lies 3.8e-3 from its
  O0 here, the port's 0.022).
- With ``APEX_TPU_FUSED_CONV1X1=1`` the forward is the same function
  call, so the first loss is equal; the backward of the routed convs
  sums in another order: losses within ``1e-5``, first-step gradients
  within ``1e-5`` of each leaf's largest element.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models import resnet as jr
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch.convert import params_to_numpy, resnet_params_from_jax
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.ops.cuda import conv1x1 as tc1
from apex_tpu_torch.optimizers import FusedAdam

SMALL = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
KINDS = {"conv7": (dict(SMALL), jr.Bottleneck, tr.Bottleneck),
         "s2d": (dict(SMALL, stem="s2d"), jr.Bottleneck, tr.Bottleneck),
         "resnet18": (dict(SMALL, stage_sizes=(2, 2, 2, 2)), jr.BasicBlock,
                      tr.BasicBlock)}
STEPS = 3
LR = 1e-3


def _batch(b, size, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, size, size, 3)).astype(np.float32),
            rng.randint(0, 10, (b,)).astype(np.int32))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_init():
    """``{kind: (jax model, params, batch_stats)}`` from one init each."""
    out = {}
    x, _ = _batch(4, 32)
    for kind, (kw, jblock, _) in KINDS.items():
        model = jr.ResNet(block_cls=jblock, **kw)
        v = jax.jit(functools.partial(model.init, train=True))(
            jax.random.PRNGKey(0), jnp.asarray(x))
        out[kind] = (model, jax.tree.map(np.asarray, v["params"]),
                     jax.tree.map(np.asarray, v["batch_stats"]))
    return out


def _port(kind, params, stats, trainable=True):
    kw, _, tblock = KINDS[kind]
    return resnet_params_from_jax(params, stats, tr.ResNet, device="cpu",
                                  trainable=trainable, block_cls=tblock,
                                  **kw)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_converted_model_matches_jax(jax_init, kind, train):
    jmodel, params, stats = jax_init[kind]
    model = _port(kind, params, stats, trainable=train)
    assert model.training == train
    got = dict(_leaves(params_to_numpy(model)))
    want = dict(_leaves(params))
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    x, _ = _batch(4, 32)
    apply = jax.jit(functools.partial(jmodel.apply, train=train,
                                      mutable=["batch_stats"]))
    jl, mut = apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    jstats = dict(_leaves(jax.tree.map(np.asarray, mut["batch_stats"])))
    if not train:
        assert all(np.array_equal(v, dict(_leaves(stats))[k])
                   for k, v in jstats.items())
    logits = model(torch.from_numpy(x))
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=5e-5, rtol=0)
    buffers = dict(model.named_buffers())
    assert {tuple(n.split(".")) for n in buffers} == set(jstats)
    for path, v in jstats.items():
        np.testing.assert_allclose(buffers[".".join(path)].numpy(), v,
                                   rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(path))


def test_the_converter_checks_names_and_shapes(jax_init):
    _, params, stats = jax_init["conv7"]
    bad = jax.tree.map(lambda a: a, params)
    bad["fc"] = dict(bad["fc"], kernel=np.zeros((64, 11), np.float32))
    with pytest.raises(ValueError, match="shapes differ"):
        _port("conv7", bad, stats)
    with pytest.raises(ValueError, match="names differ"):
        _port("conv7", params, {})


def _jax_steps(jmodel, params, stats, opt_level, x, y):
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=LR),
                           opt_level=opt_level, verbosity=0)
    state = a.init(params)

    def step(s, st, x, y):
        def loss_fn(p, x, y):
            logits, mut = jmodel.apply({"params": p, "batch_stats": st}, x,
                                       train=True, mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            return (-jnp.mean(jnp.take_along_axis(logp, y[:, None], 1)),
                    mut["batch_stats"])
        s2, m = jax_amp.make_train_step(a, loss_fn, has_aux=True)(s, x, y)
        return s2, m["aux"], m

    step = jax.jit(step)
    metrics = []
    for _ in range(STEPS):
        state, stats, m = step(state, stats, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return (metrics, dict(_leaves(jax.tree.map(np.asarray,
                                               state.master_params))),
            dict(_leaves(jax.tree.map(np.asarray, stats))))


def _loss(model, x, y):
    return tr.resnet_loss(model(x, train=True), y)


def _torch_steps(params, stats, opt_level, x, y):
    model = _port("conv7", params, stats)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=LR,
                                        device="cpu"),
                       opt_level=opt_level, device="cpu")
    step = amp.make_train_step(a, model, _loss)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    metrics = [{k: float(v) for k, v in step(tx, ty).items()
                if k in ("loss", "loss_scale", "overflow")}
               for _ in range(STEPS)]
    return model, a, metrics


@pytest.fixture(scope="module")
def jax_runs(jax_init):
    """JAX's O0 and O2 runs of the conv7 model at B 8 x 32^2."""
    jmodel, params, stats = jax_init["conv7"]
    x, y = _batch(8, 32, seed=1)
    return {lvl: _jax_steps(jmodel, params, stats, lvl, x, y)
            for lvl in ("O0", "O2")}


@pytest.mark.parametrize("switch", ["0", "1"])
def test_o0_steps_match_jax(jax_init, jax_runs, monkeypatch, switch):
    monkeypatch.setenv("APEX_TPU_FUSED_CONV1X1", switch)
    _, params, stats = jax_init["conv7"]
    x, y = _batch(8, 32, seed=1)
    jm, jmasters, jstats = jax_runs["O0"]
    model, a, tm = _torch_steps(params, stats, "O0", x, y)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 1e-5, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"] == 1.0
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    got = dict(_leaves(params_to_numpy(a.masters)))
    assert set(got) == set(jmasters)
    beyond = total = 0
    for path, w in jmasters.items():
        np.testing.assert_allclose(got[path], w, atol=LR, rtol=0,
                                   err_msg="/".join(path))
        beyond += int((np.abs(got[path] - w) > 1e-5).sum())
        total += w.size
    assert beyond <= 0.01 * total, (beyond, total)
    buffers = dict(model.named_buffers())
    for path, v in jstats.items():
        d = np.abs(buffers[".".join(path)].numpy() - v)
        assert (d <= 1e-4 * np.maximum(1.0, np.abs(v))).all(), path


def _first_grads(params, stats, x, y):
    model = _port("conv7", params, stats)
    _loss(model, torch.from_numpy(x), torch.from_numpy(y).long()).backward()
    return {tuple(n.split(".")): p.grad.numpy()
            for n, p in model.named_parameters()}


def test_o0_first_step_gradients_match_jax(jax_init):
    jmodel, params, stats = jax_init["conv7"]
    x, y = _batch(8, 32, seed=1)

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             1))

    want = dict(_leaves(jax.tree.map(np.asarray,
                                     jax.jit(jax.grad(loss_fn))(params))))
    got = _first_grads(params, stats, x, y)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg="/".join(path))


def test_the_switch_routes_each_1x1_conv_and_keeps_the_steps(
        jax_init, monkeypatch):
    _, params, stats = jax_init["conv7"]
    x, y = _batch(8, 32, seed=1)
    calls = []
    plain = tc1.conv1x1_bwd_ref

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(tc1, "conv1x1_bwd_ref", counted)
    runs, grads = {}, {}
    for switch in ("0", "1"):
        monkeypatch.setenv("APEX_TPU_FUSED_CONV1X1", switch)
        del calls[:]
        grads[switch] = _first_grads(params, stats, x, y)
        # conv1 + conv3 of 4 bottlenecks, and stage 0's projection
        assert len(calls) == (9 if switch == "1" else 0)
        runs[switch] = _torch_steps(params, stats, "O0", x, y)[2]
    assert runs["1"][0]["loss"] == runs["0"][0]["loss"]
    for a, b in zip(runs["1"], runs["0"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5, runs
    for path, g in grads["0"].items():
        np.testing.assert_allclose(grads["1"][path], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg="/".join(path))


def test_o2_steps_match_jax(jax_init, jax_runs):
    _, params, stats = jax_init["conv7"]
    x, y = _batch(8, 32, seed=1)
    jm, _, _ = jax_runs["O2"]
    _, _, tm = _torch_steps(params, stats, "O2", x, y)
    assert abs(tm[0]["loss"] - jax_runs["O0"][0][0]["loss"]) <= 1e-2
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= 3e-2, (jm, tm)
        assert j["loss_scale"] == t["loss_scale"]
        assert j["overflow"] == t["overflow"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]


def test_o2_keeps_batchnorm_fp32_casts_the_images_and_never_the_stats(
        jax_init):
    _, params, stats = jax_init["conv7"]
    x, y = _batch(8, 32, seed=1)
    model = _port("conv7", params, stats)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=LR,
                                        device="cpu"),
                       opt_level="O2", device="cpu")
    for n, p in model.named_parameters():
        want = torch.float32 if "bn" in n else torch.bfloat16
        assert p.dtype == want, n
    assert all(t.dtype == torch.float32 for t in a.masters.values())
    seen = []
    model.stem_conv.register_forward_hook(
        lambda m, args, out: seen.append((args[0].dtype, out.dtype)))
    poison = torch.ones(8)

    def loss_fn(m, x, y, p):
        return _loss(m, x, y) * p.prod()

    step = amp.make_train_step(a, model, loss_fn)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    out = step(tx, ty, poison)
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert not bool(out["overflow"])
    assert all(b.dtype == torch.float32 for b in model.buffers())
    # an overflowing step is skipped, but its forward still moved the
    # running stats (JAX's example keeps m["aux"] on every step)
    masters = {n: t.clone() for n, t in a.masters.items()}
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    scale = float(out["loss_scale"])
    out = step(tx, ty, torch.full((8,), float("inf")))
    assert bool(out["overflow"]) and float(out["loss_scale"]) == scale / 2
    assert all(torch.equal(masters[n], t) for n, t in a.masters.items())
    moved = [n for n, b in model.named_buffers()
             if not torch.equal(bufs[n], b)]
    assert len(moved) == len(bufs)
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_resnet50_has_the_jax_package_leaves_and_routed_convs():
    model = tr.ARCHS["resnet50"](device="meta")
    named = dict(model.named_parameters())
    assert len(named) == 161
    assert sum(p.numel() for p in named.values()) == 25_557_032
    assert len(dict(model.named_buffers())) == 2 * 53
    routed = [n for n, m in model.named_modules()
              if isinstance(m, tr.Conv) and m.kernel.shape[:2] == (1, 1)
              and m.strides == (1, 1)]
    assert len(routed) == 33
    assert model.stem_conv.kernel.shape == (7, 7, 3, 64)
    assert model.fc.kernel.shape == (2048, 1000)
    s2d = tr.ARCHS["resnet50_s2d"](device="meta")
    assert s2d.stem_conv.kernel.shape == (2, 2, 48, 64)
    r18 = tr.ARCHS["resnet18"](device="meta")
    assert len(dict(r18.named_parameters())) == 62


def test_the_example_pieces_match_jax():
    gen = torch.Generator().manual_seed(0)
    x, y = tr.synthetic_batch(gen, 6, 16, device="cpu")
    assert x.shape == (6, 16, 16, 3) and x.dtype == torch.float32
    assert y.dtype == torch.int64 and 0 <= int(y.min()) <= int(y.max()) < 1000
    rng = np.random.RandomState(2)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.randint(0, 10, 6).astype(np.int32)
    jl = jax.nn.log_softmax(jnp.asarray(logits))
    want = -jnp.mean(jnp.take_along_axis(jl, jnp.asarray(labels)[:, None], 1))
    got = tr.resnet_loss(torch.from_numpy(logits).to(torch.bfloat16).float(),
                         torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        float(tr.resnet_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))), float(want),
        rtol=1e-6)
    _, pred = jax.lax.top_k(jnp.asarray(logits), 5)
    correct = np.asarray(pred) == labels[:, None]
    want_acc = [100.0 * correct[:, :k].sum() / 6 for k in (1, 5)]
    got_acc = tr.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                          (1, 5))
    np.testing.assert_allclose([float(a) for a in got_acc], want_acc,
                               rtol=1e-6)
