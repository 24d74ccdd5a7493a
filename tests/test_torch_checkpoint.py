"""The port's amp checkpoint (``apex_tpu_torch/checkpoint.py``) against
the JAX package's (``apex_tpu/checkpoint.py``), on the CPU through the
kernels' plain versions, and its contract: a resume continues bit for
bit, the scalers persist, extras round-trip, a structural mismatch names
its first path, retention keeps the newest snapshots.

``state_dict`` parity: 5 amp O2 FusedAdam steps on the same weights and
batches in both packages (the MLP of ``tests/l0/test_resilience.py``'s
``_workload``, lr 1e-2; a 2-layer narrow GPT, lr 3e-3, as
``tests/test_torch_train.py``'s).  The payloads name the same leaves in
the same order.  Tolerances, from ``tests/test_torch_train.py``'s O2
bounds (bf16 compute rounds activations at other places in XLA and
PyTorch):

- the integer leaves (step counts, the step) and the scaler state
  (scale, good-step count) equal;
- the per-step losses within ``2e-2``;
- each master within Adam's drift bound, ``2 * lr`` a step (Adam
  normalizes every element's step to at most ~``lr``, whatever its
  gradient: measured 1.9e-2 of 3.0e-2 on the GPT);
- each moment ``m`` and ``v`` within ``0.1`` of its leaf's largest
  magnitude (the bf16 gradients agree to a few 1e-2 of their scale:
  measured 4.6e-2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu import checkpoint as jax_checkpoint
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_cross_entropy
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.resilience import durable as jax_durable
from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.convert import (mlp_params_from_jax, params_from_jax,
                                    params_to_numpy)
from apex_tpu_torch.models import GPTModel, ResNet, gpt_tiny, lm_loss
from apex_tpu_torch.models.mlp import MLP, cross_entropy_loss
from apex_tpu_torch.models.resnet import resnet_loss
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.resilience import (CheckpointCorruptError,
                                       DurableCheckpointManager)
from apex_tpu_torch.resilience.durable import tree_leaves_with_path

STEPS = 5
LOSS_TOL = 2e-2
MOMENT_REL_TOL = 0.1


@functools.lru_cache(maxsize=None)
def _mlp_data():
    """The JAX ``_workload``'s weights and batch, as numpy (made once)."""
    tree = jax.tree.map(np.array, JaxMLP(features=(32,)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"])
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (32, 16)))
    y = np.array(jax.random.randint(jax.random.PRNGKey(2), (32,), 0, 10))
    return tree, x, y


def _mlp_case():
    jm = JaxMLP(features=(32,))
    tree, x, y = _mlp_data()
    model = mlp_params_from_jax(tree, features=(32,), in_features=16,
                                device="cpu", trainable=True)
    return dict(
        lr=1e-2, tree=tree, model=model,
        jax_loss=lambda p, x, y: jax_cross_entropy(
            jm.apply({"params": p}, x), y),
        jax_batch=(jnp.asarray(x), jnp.asarray(y)),
        loss=lambda m, x, y: cross_entropy_loss(m(x), y),
        batch=(torch.from_numpy(x), torch.from_numpy(y).long()))


def _gpt_case():
    cfg = gpt_tiny()
    torch.manual_seed(0)
    tree = params_to_numpy(GPTModel(cfg, device="cpu"))
    rng = np.random.RandomState(0)
    ids = ((rng.randint(0, cfg.vocab_size, (4, 1)) + np.arange(32)[None])
           % cfg.vocab_size).astype(np.int32)
    jm = JaxGPT(JaxConfig(vocab_size=cfg.vocab_size,
                          hidden_size=cfg.hidden_size,
                          num_layers=cfg.num_layers,
                          num_heads=cfg.num_heads,
                          intermediate_size=cfg.intermediate_size))
    return dict(
        lr=3e-3, tree=tree,
        model=params_from_jax(tree, cfg, device="cpu", trainable=True),
        jax_loss=lambda p, x: jax_lm_loss(jm.apply({"params": p}, x)[:, :-1],
                                          x[:, 1:]),
        jax_batch=(jnp.asarray(ids),),
        loss=lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]),
        batch=(torch.from_numpy(ids).long(),))


def _adam_drift_bound(steps, lr, betas=(0.9, 0.999)):
    """Twice the sum over steps of Adam's largest update, ``lr *
    max|m_hat| / sqrt(v_hat)``, bounded by Cauchy-Schwarz over the
    moments' weights (1 at step 1, 1.0014 at 2, ...)."""
    b1, b2 = betas
    total = 0.0
    for t in range(1, steps + 1):
        w1 = [(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)]
        w2 = [(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)]
        total += (sum(a * a / b for a, b in zip(w1, w2)) * sum(w2)) ** 0.5 \
            / sum(w1)
    return 2.0 * lr * total


@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_state_dict_matches_jax_leaf_for_leaf(kind):
    case = _mlp_case() if kind == "mlp" else _gpt_case()
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=case["lr"]),
                           opt_level="O2", verbosity=0)
    state = a.init(case["tree"])
    step = jax.jit(jax_amp.make_train_step(a, case["jax_loss"]))
    jax_losses = []
    for _ in range(STEPS):
        state, m = step(state, *case["jax_batch"])
        jax_losses.append(float(m["loss"]))
    want = [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in
            jax.tree_util.tree_leaves_with_path(
                jax_checkpoint.state_dict(state))]

    model = case["model"]
    ta = amp.initialize(model, FusedAdam(model.parameters(), lr=case["lr"],
                                         device="cpu"),
                        opt_level="O2", device="cpu")
    tstep = amp.make_train_step(ta, model, case["loss"])
    losses = [float(tstep(*case["batch"])["loss"]) for _ in range(STEPS)]
    got = list(tree_leaves_with_path(checkpoint.state_dict(ta)))

    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    assert [k for k, _ in got] == [k for k, _ in want]
    drift = _adam_drift_bound(STEPS, case["lr"])
    for (key, t), (_, w) in zip(got, want):
        g = t.float().numpy() if t.is_floating_point() else t.numpy()
        assert g.shape == w.shape, key
        if key.startswith("['master_params']"):
            np.testing.assert_allclose(g, w, atol=drift, rtol=0,
                                       err_msg=key)
        elif key.startswith(("['opt_state'].m", "['opt_state'].v")):
            tol = MOMENT_REL_TOL * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=key)
        else:       # counts, the step, the scaler: equal
            np.testing.assert_array_equal(g, w, err_msg=key)
            assert g.dtype == w.dtype, key


def _mlp_run(optimizer="adam"):
    case = _mlp_case()
    model = case["model"]
    opt = FusedAdam(model.parameters(), lr=case["lr"], device="cpu") \
        if optimizer == "adam" else \
        FusedLAMB(model.parameters(), lr=case["lr"], device="cpu")
    a = amp.initialize(model, opt, opt_level="O2", device="cpu")
    return a, amp.make_train_step(a, model, case["loss"]), case["batch"]


def _snapshot(a):
    return [(k, t.clone()) for k, t in
            tree_leaves_with_path(checkpoint.state_dict(a))]


def _assert_same(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert torch.equal(g, w), k


@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_resume_in_a_fresh_process_continues_bitwise(optimizer, tmp_path):
    """3 steps, a save, then a fresh model, Amp and manager restore and
    take 3 more: masters, moments, counts (FusedLAMB's global count too),
    scaler and losses equal the uninterrupted 6 steps bit for bit."""
    a, step, batch = _mlp_run(optimizer)
    want_losses = [float(step(*batch)["loss"]) for _ in range(6)]
    want = _snapshot(a)
    assert int(dict(want)["['opt_state'].step"]) == 6

    a, step, batch = _mlp_run(optimizer)
    losses = [float(step(*batch)["loss"]) for _ in range(3)]
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(2, a)
    mgr.close()
    b, step_b, batch = _mlp_run(optimizer)
    restored, _ = DurableCheckpointManager(str(tmp_path)).restore(b)
    assert restored is b
    losses += [float(step_b(*batch)["loss"]) for _ in range(3)]
    assert losses == want_losses
    _assert_same(_snapshot(b), want)
    # the compute params are the bf16 rounding of the restored masters
    for p, master in zip(b.params, b.masters.values()):
        assert torch.equal(p, master.to(torch.bfloat16))


def test_restore_in_place_keeps_the_kernels_views(tmp_path):
    """A restore into the Amp that ran on copies into its tensors: the
    per-leaf step counts stay views of the vector the Adam kernel reads,
    the moments keep their storage, and the first step after the restore
    equals the uninterrupted step."""
    a, step, batch = _mlp_run()
    for _ in range(2):
        step(*batch)
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False,
                                   async_save=False)
    mgr.save(1, a)
    want_loss = float(step(*batch)["loss"])
    want = _snapshot(a)
    opt = a.optimizer
    group = opt.param_groups[0]
    vector = group["leaf_steps"]
    storage = [opt.state[p]["exp_avg"].data_ptr() for p in group["params"]]
    for _ in range(2):       # run past the snapshot, then go back
        step(*batch)
    mgr.restore(a)
    assert group["leaf_steps"] is vector
    assert all(int(opt.state[p]["step"]) == 2 for p in group["params"])
    assert [opt.state[p]["exp_avg"].data_ptr()
            for p in group["params"]] == storage
    assert float(step(*batch)["loss"]) == want_loss
    _assert_same(_snapshot(a), want)


def test_scaler_state_persists(tmp_path):
    a, step, batch = _mlp_run()
    step(*batch)
    grads = [torch.full_like(p, float("inf")) for p in a.params]
    a.apply_gradients(grads)          # an overflow: the scale halves
    step(*batch)
    scale, good = float(a.scaler_state.loss_scale), \
        int(a.scaler_state.unskipped)
    assert (scale, good) == (2.0 ** 15, 1)
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(2, a)
    b, _, _ = _mlp_run()
    mgr.restore(b)
    assert float(b.scaler_state.loss_scale) == scale
    assert int(b.scaler_state.unskipped) == good
    assert int(b.step) == 3
    mgr.close()


def test_extras_round_trip_batchnorm_buffers_and_an_epoch(tmp_path):
    torch.manual_seed(0)
    model = ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                   device="cpu")
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-3,
                                        device="cpu"),
                       opt_level="O2", device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, x, y: resnet_loss(m(x, train=True), y))
    x = torch.randn(4, 32, 32, 3)
    y = torch.tensor([0, 1, 2, 3])
    step(x, y)
    buffers = dict(model.named_buffers())
    assert buffers
    saved = {n: b.clone() for n, b in buffers.items()}
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a, extras={"batch_stats": buffers, "epoch": 7})
    mgr.wait()
    step(x, y)                        # moves the running stats
    assert not all(torch.equal(saved[n], b) for n, b in buffers.items())
    _, extras = mgr.restore(a, extras={"batch_stats": buffers, "epoch": 0})
    assert extras["epoch"] == 7 and isinstance(extras["epoch"], int)
    for n, b in buffers.items():
        assert extras["batch_stats"][n] is b
        assert torch.equal(b, saved[n]), n
    mgr.close()


def test_structural_mismatch_names_the_first_path(tmp_path):
    a, _, _ = _mlp_run()
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a)
    mgr.wait()
    model = MLP((32, 8), in_features=16, device="cpu")
    b = amp.initialize(model, FusedAdam(model.parameters(), device="cpu"),
                       opt_level="O2", device="cpu")
    with pytest.raises(ValueError, match=r"at leaf \"\['master_params'\]"
                                         r"\['AmpDense_2'\]"):
        mgr.restore(b)
    with pytest.raises(ValueError, match=r"\['extras'\]\['epoch'\]"):
        mgr.restore(a, extras={"epoch": 0})
    mgr.close()


def test_retention_keeps_the_newest(tmp_path):
    a, step, batch = _mlp_run()
    mgr = DurableCheckpointManager(str(tmp_path), max_to_keep=2,
                                   fsync=False)
    for i in range(5):
        step(*batch)
        mgr.save(i, a)
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]
    mgr.close()
    empty = DurableCheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        empty.restore(a)


def test_a_payload_without_fp8_state_restores():
    """A payload saved before the fp8 state existed (no ``fp8_state``
    key) restores into an O2 ``Amp``, as one holding None does."""
    a, step, batch = _mlp_run()
    step(*batch)
    d = checkpoint.state_dict(a)
    assert d["fp8_state"] is None
    del d["fp8_state"]
    b, _, _ = _mlp_run()
    checkpoint.load_state_dict(b, d)
    _assert_same(_snapshot(b), _snapshot(a))


def _o4_mlp_run(steps=3):
    case = _mlp_case()
    model = case["model"]
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=case["lr"],
                                        device="cpu"),
                       opt_level="O4", device="cpu")
    step = amp.make_train_step(a, model, case["loss"])
    for _ in range(steps):
        step(*case["batch"])
    return a, step, case["batch"]


def test_an_o4_state_round_trips_through_state_dict_and_durable(tmp_path):
    """The fp8 state is in the payload under the JAX package's names
    (each class's ``amax_history`` and ``scale``), and an O4 ``Amp``
    restored from it, by ``load_state_dict`` or through the durable
    manager, equals the saved one bit for bit and takes the same next
    step."""
    a, step, batch = _o4_mlp_run()
    d = checkpoint.state_dict(a)
    keys = [k for k, _ in tree_leaves_with_path(d)]
    fp8_keys = [k for k in keys if k.startswith("['fp8_state']")]
    assert fp8_keys == [f"['fp8_state'].{c}.{f}"
                        for c in ("input", "weight", "grad")
                        for f in ("amax_history", "scale")]
    assert float(a.fp8_state.input.scale) != 1.0
    b, _, _ = _o4_mlp_run(steps=0)
    checkpoint.load_state_dict(b, d)
    _assert_same(_snapshot(b), _snapshot(a))
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(2, a)
    mgr.close()
    c, step_c, _ = _o4_mlp_run(steps=0)
    DurableCheckpointManager(str(tmp_path)).restore(c)
    _assert_same(_snapshot(c), _snapshot(a))
    want, got = step(*batch), step_c(*batch)
    for k in ("loss", "fp8_amax_saturation", "fp8_rescales"):
        assert torch.equal(got[k], want[k]), k
    _assert_same(_snapshot(c), _snapshot(a))


def test_a_jax_o4_snapshot_restores_into_the_port_and_back(tmp_path):
    case = _mlp_case()
    ja = jax_amp.initialize(optimizer=JaxFusedAdam(lr=case["lr"]),
                            opt_level="O4", verbosity=0)
    jstep = jax.jit(jax_amp.make_train_step(ja, case["jax_loss"]))
    state = ja.init(case["tree"])
    for _ in range(3):
        state, _ = jstep(state, *case["jax_batch"])
    jmgr = jax_durable.DurableCheckpointManager(str(tmp_path / "jax"),
                                                fsync=False)
    jmgr.save(2, state)
    jmgr.close()

    def jax_leaves(st):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_leaves_with_path(
                    jax_checkpoint.state_dict(st))}
    want = jax_leaves(state)
    assert "['fp8_state'].grad.amax_history" in want
    a, step, batch = _o4_mlp_run(steps=0)
    DurableCheckpointManager(str(tmp_path / "jax")).restore(a)
    got = dict(_snapshot(a))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    for p, master in zip(a.params, a.masters.values()):
        assert torch.equal(p, master.to(torch.bfloat16))
    step(*batch)                        # the restored state trains

    # and back: the port's O4 snapshot into a JAX O4 template
    mgr = DurableCheckpointManager(str(tmp_path / "port"), fsync=False)
    mgr.save(3, a)
    mgr.close()
    restored, _ = jax_durable.DurableCheckpointManager(
        str(tmp_path / "port")).restore(ja.init(case["tree"]))
    back = jax_leaves(restored)
    for k, t in _snapshot(a):
        np.testing.assert_array_equal(back[k], t.numpy(), err_msg=k)


def test_an_o2_payload_warm_starts_an_o4_amp():
    """The O2 -> O4 warm start: a payload without ``fp8_state`` restores
    the masters, moments and scalers into an O4 ``Amp``, which keeps its
    fresh fp8 state (unit scales, empty histories)."""
    a, step, batch = _mlp_run()
    for _ in range(2):
        step(*batch)
    d = checkpoint.state_dict(a)
    del d["fp8_state"]
    b, _, _ = _o4_mlp_run(steps=0)
    checkpoint.load_state_dict(b, d)
    for c in b.fp8_state:
        assert float(c.scale) == 1.0 and not bool(c.amax_history.any())
    got = dict(_snapshot(b))
    for k, t in _snapshot(a):
        if not k.startswith("['fp8_state']"):
            assert torch.equal(got[k], t), k


def test_restore_raises_when_every_snapshot_is_corrupt(tmp_path):
    a, step, batch = _mlp_run()
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a)
    mgr.wait()
    for f in (tmp_path / "step_00000000").glob("*.npy"):
        f.write_bytes(b"rot")
    step(*batch)
    before = _snapshot(a)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(a)
    _assert_same(_snapshot(a), before)    # the template is untouched


def test_a_non_fused_optimizer_is_refused():
    model = _mlp_case()["model"]
    a = amp.initialize(model, torch.optim.SGD(model.parameters(), lr=0.1),
                       opt_level="O2", device="cpu")
    with pytest.raises(TypeError, match="fused optimizers"):
        checkpoint.state_dict(a)
