"""The port's durable snapshots (``apex_tpu_torch/resilience/durable.py``)
against the JAX package's (``apex_tpu/resilience/durable.py``), on the
CPU.

Format parity: a snapshot written by either package verifies and reads
in the other with equal arrays, bit for bit (bf16 leaves included: both
store their 2-byte words as ``V2`` under the manifest dtype
``"bfloat16"``), under the same leaf names and manifest dtypes; an amp
O2 state saved by one package's manager restores into the other's state
with every leaf equal.

Then the JAX package's durable scenarios (``tests/l0/test_resilience.py``
lines 83-311), one parametrized case each, with the JAX tests'
assertions, on a port amp O2 state (the MLP of that file's
``_workload``): truncation, a bit flip, every snapshot corrupt, a stale
tmp dir, a background error on ``wait``, the async retry, a save safe
under in-place updates, the re-save crash window, a process crash
between the rename-aside and the commit, a transient leaf read, a
missing leaf.
"""

import builtins
import functools
import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu.models.mlp import cross_entropy_loss as jax_cross_entropy
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.resilience import durable as jax_durable
from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.convert import mlp_params_from_jax
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import (CheckpointCorruptError,
                                       CorruptCheckpoint,
                                       DurableCheckpointManager,
                                       FaultInjector, FlakyIO, retry_io)
from apex_tpu_torch.resilience import durable
from apex_tpu_torch.resilience.durable import tree_leaves_with_path


class Pair(NamedTuple):
    step: Any
    m: Any


def _values():
    rng = np.random.default_rng(0)
    return dict(w=rng.standard_normal((3, 4)).astype(np.float32),
                half=np.linspace(-3.0, 3.0, 7, dtype=np.float32),
                n=np.int32(5), m=rng.standard_normal(5).astype(np.float32),
                count=np.int64(9), flags=np.array([True, False]))


def _jax_payload():
    v = _values()
    return {"w": jnp.asarray(v["w"]),
            "half": jnp.asarray(v["half"], dtype=jnp.bfloat16),
            "opt": Pair(step=jnp.asarray(v["n"]),
                        m={"a": jnp.asarray(v["m"])}),
            "lst": [np.asarray(v["count"]), v["flags"]],
            "none": None}


def _port_payload():
    v = _values()
    return {"w": torch.from_numpy(v["w"]),
            "half": torch.from_numpy(v["half"]).to(torch.bfloat16),
            "opt": Pair(step=torch.tensor(int(v["n"]), dtype=torch.int32),
                        m={"a": torch.from_numpy(v["m"])}),
            "lst": [torch.tensor(int(v["count"])),
                    torch.from_numpy(v["flags"])],
            "none": None}


def _jax_keys(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def test_leaf_names_and_order_are_the_jax_packages():
    assert [k for k, _ in tree_leaves_with_path(_port_payload())] == \
        _jax_keys(_jax_payload())


def test_a_jax_snapshot_verifies_and_reads_in_the_port(tmp_path):
    jax_durable.write_snapshot(str(tmp_path), 3, _jax_payload())
    path = str(tmp_path / "step_00000003")
    ok, problems = durable.verify_snapshot(path)
    assert ok, problems
    got, manifest = durable.read_snapshot(path)
    want, _ = jax_durable.read_snapshot(path)
    assert list(got) == list(want) == _jax_keys(_jax_payload())
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    key = "['half']"
    assert manifest["leaves"][key]["dtype"] == "bfloat16"
    half = durable.as_tensor(got[key], manifest["leaves"][key]["dtype"])
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, _port_payload()["half"])


def test_a_port_snapshot_verifies_and_reads_in_jax(tmp_path):
    durable.write_snapshot(str(tmp_path / "port"), 3, _port_payload())
    jax_durable.write_snapshot(str(tmp_path / "jax"), 3, _jax_payload())
    path = str(tmp_path / "port" / "step_00000003")
    ok, problems = jax_durable.verify_snapshot(path)
    assert ok, problems
    got, manifest = jax_durable.read_snapshot(path)
    want, jax_manifest = jax_durable.read_snapshot(
        str(tmp_path / "jax" / "step_00000003"))
    assert list(got) == list(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
        assert got[k].shape == want[k].shape, k
        for field in ("dtype", "shape"):
            assert manifest["leaves"][k][field] == \
                jax_manifest["leaves"][k][field], (k, field)
        assert manifest["leaves"][k]["file"] == \
            jax_manifest["leaves"][k]["file"], k
        if manifest["leaves"][k]["dtype"] != "bfloat16":
            # the bytes np.save writes (a bf16 leaf's header spells V2
            # with JAX's byte-order mark)
            name = manifest["leaves"][k]["file"]
            assert (tmp_path / "port" / "step_00000003" / name).read_bytes() \
                == (tmp_path / "jax" / "step_00000003" / name).read_bytes(), k


@functools.lru_cache(maxsize=None)
def _mlp_data():
    tree = jax.tree.map(np.array, JaxMLP(features=(32,)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"])
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (32, 16)))
    y = np.array(jax.random.randint(jax.random.PRNGKey(2), (32,), 0, 10))
    return tree, x, y


def _port_workload(min_loss_scale=None):
    """The port's counterpart of ``_workload``: MLP((32,)) at amp O2 with
    FusedAdam(1e-2), ``step()`` one train step on the fixed batch."""
    tree, x, y = _mlp_data()
    model = mlp_params_from_jax(tree, features=(32,), in_features=16,
                                device="cpu", trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level="O2", device="cpu",
                       min_loss_scale=min_loss_scale)
    step = amp.make_train_step(a, model,
                               lambda m, x, y: cross_entropy_loss(m(x), y))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    return a, lambda: step(xt, yt)


def _flat(a):
    return {k: t.clone() for k, t in
            tree_leaves_with_path(checkpoint.state_dict(a))}


def test_amp_snapshots_cross_between_the_packages(tmp_path):
    tree, x, y = _mlp_data()
    ja = jax_amp.initialize(optimizer=JaxFusedAdam(lr=1e-2), opt_level="O2",
                            verbosity=0)
    jstep = jax.jit(jax_amp.make_train_step(ja, lambda p, x, y:
                                            jax_cross_entropy(
                                                JaxMLP(features=(32,)).apply(
                                                    {"params": p}, x), y)))
    state = ja.init(tree)
    for _ in range(5):
        state, _ = jstep(state, jnp.asarray(x), jnp.asarray(y))
    jmgr = jax_durable.DurableCheckpointManager(str(tmp_path / "jax"),
                                                fsync=False)
    jmgr.save(4, state)
    jmgr.close()
    a, _ = _port_workload()
    DurableCheckpointManager(str(tmp_path / "jax")).restore(a)
    want = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, {
                    "master_params": state.master_params,
                    "m": state.opt_state.m, "v": state.opt_state.v,
                    "leaf_step": state.opt_state.leaf_step}))}
    got = _flat(a)
    for k, w in want.items():
        port_key = k.replace("['m']", "['opt_state'].m", 1) \
            .replace("['v']", "['opt_state'].v", 1) \
            .replace("['leaf_step']", "['opt_state'].leaf_step", 1)
        np.testing.assert_array_equal(got[port_key].numpy(), w, err_msg=k)
    assert float(a.scaler_state.loss_scale) == \
        float(state.scaler_states[0].loss_scale)
    assert int(a.step) == int(state.step) == 5
    # the compute params follow the restored masters
    for p, master in zip(a.params, a.masters.values()):
        assert torch.equal(p, master.to(torch.bfloat16))

    # and back: the port's snapshot restores into a JAX template
    b, step = _port_workload()
    for _ in range(3):
        step()
    mgr = DurableCheckpointManager(str(tmp_path / "port"), fsync=False)
    mgr.save(2, b)
    mgr.close()
    restored, _ = jax_durable.DurableCheckpointManager(
        str(tmp_path / "port")).restore(ja.init(tree))
    for k, w in _flat(b).items():
        if k.startswith("['master_params']"):
            path = k[len("['master_params']"):]
            leaf = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_leaves_with_path(
                        restored.master_params)}[path]
            np.testing.assert_array_equal(np.asarray(leaf), w.numpy(),
                                          err_msg=k)
    assert int(restored.step) == 3


# ---------------------------------------------------------------------------
# the JAX package's durable scenarios
# ---------------------------------------------------------------------------

def _truncation(tmp_path, monkeypatch):
    a, step = _port_workload()
    inj = FaultInjector([CorruptCheckpoint(step=2, kind="truncate")], seed=3)
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False,
                                   on_commit=inj.on_commit)
    for i in range(3):
        step()
        mgr.save(i, a)
    mgr.wait()
    assert any(e["fault"] == "corrupt_checkpoint" for e in inj.events)
    mgr.restore(a)
    assert mgr.last_restore["step"] == 1
    assert mgr.last_restore["skipped"][0]["step"] == 2
    ok, problems = durable.verify_snapshot(str(tmp_path / "step_00000002"))
    assert not ok and problems


def _bit_flip(tmp_path, monkeypatch):
    a, step = _port_workload()
    inj = FaultInjector([CorruptCheckpoint(step=1, kind="corrupt")], seed=5)
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False,
                                   on_commit=inj.on_commit)
    mgr.save(0, a)
    step()
    mgr.save(1, a)
    mgr.wait()
    mgr.restore(a)
    assert mgr.last_restore["step"] == 0


def _all_corrupt(tmp_path, monkeypatch):
    a, _ = _port_workload()
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a)
    mgr.wait()
    for name in os.listdir(tmp_path / "step_00000000"):
        if name.endswith(".npy"):
            (tmp_path / "step_00000000" / name).write_bytes(b"rot")
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(a)


def _stale_tmp(tmp_path, monkeypatch):
    a, _ = _port_workload()
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(4, a)
    mgr.wait()
    stale = tmp_path / ".tmp-step_00000009-dead"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"partial")
    mgr2 = DurableCheckpointManager(str(tmp_path))
    assert not stale.exists()
    assert mgr2.latest_step() == 4


def _background_error_on_wait(tmp_path, monkeypatch):
    a, _ = _port_workload()
    inj = FaultInjector([FlakyIO(op="save", fails=1)])
    mgr = DurableCheckpointManager(str(tmp_path), io_hook=inj.io_hook,
                                   io_retries=0, fsync=False)
    mgr.save(0, a)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        mgr.wait()


def _async_retry(tmp_path, monkeypatch):
    import apex_tpu_torch.resilience.loop as loop_mod
    monkeypatch.setattr(loop_mod.time, "sleep", lambda s: None)
    a, _ = _port_workload()
    inj = FaultInjector([FlakyIO(op="save", fails=2)])
    mgr = DurableCheckpointManager(str(tmp_path), io_hook=inj.io_hook,
                                   io_retries=3, io_backoff_s=0.01,
                                   fsync=False)
    mgr.save(0, a)
    mgr.wait()                       # absorbed on the 3rd try
    assert mgr.latest_step() == 0


def _safe_under_in_place_updates(tmp_path, monkeypatch):
    """save() copies to the host before it returns: the next step (and
    here every tensor of the state, changed in place at once) must not
    reach the snapshot the writer serializes."""
    a, step = _port_workload()
    step()
    want = _flat(a)
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a)
    with torch.no_grad():
        for _, t in tree_leaves_with_path(checkpoint.payload_template(a)):
            t.add_(1)
    step()
    mgr.wait()
    b, _ = _port_workload()
    mgr.restore(b)
    got = _flat(b)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _close_stops_writer(tmp_path, monkeypatch):
    a, _ = _port_workload()
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a)
    mgr.close()
    assert mgr._worker is None
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(1, a)


def _resave_crash_window(tmp_path, monkeypatch):
    p_old = {"w": np.arange(4.0)}
    durable.write_snapshot(str(tmp_path), 7, p_old)
    real_replace = os.replace

    def exploding(src, dst):
        if os.path.basename(str(src)).startswith(".tmp-"):
            raise OSError(5, "simulated crash in the commit window")
        return real_replace(src, dst)

    monkeypatch.setattr(durable.os, "replace", exploding)
    with pytest.raises(OSError):
        durable.write_snapshot(str(tmp_path), 7, {"w": np.arange(4.0) * 2})
    monkeypatch.undo()
    values, manifest = durable.read_snapshot(str(tmp_path / "step_00000007"))
    assert manifest["step"] == 7
    np.testing.assert_array_equal(next(iter(values.values())), p_old["w"])
    assert [n for n in os.listdir(tmp_path)
            if n.startswith((".old-", ".tmp-"))] == []


def _resave_commits_new_payload(tmp_path, monkeypatch):
    durable.write_snapshot(str(tmp_path), 7, {"w": np.arange(4.0)})
    durable.write_snapshot(str(tmp_path), 7, {"w": np.arange(4.0) * 2})
    values, _ = durable.read_snapshot(str(tmp_path / "step_00000007"))
    np.testing.assert_array_equal(next(iter(values.values())),
                                  np.arange(4.0) * 2)
    assert [n for n in os.listdir(tmp_path)
            if n.startswith((".old-", ".tmp-"))] == []


def _crash_between_aside_and_commit(tmp_path, monkeypatch):
    durable.write_snapshot(str(tmp_path), 2, {"w": np.ones(3)})
    final = tmp_path / "step_00000002"
    os.replace(final, tmp_path / ".old-step_00000002-123-456")
    mgr = DurableCheckpointManager(str(tmp_path))
    assert final.is_dir()
    assert not (tmp_path / ".old-step_00000002-123-456").exists()
    assert mgr.latest_step() == 2
    ok, problems = durable.verify_snapshot(str(final))
    assert ok, problems
    # post-commit garbage: both exist, the aside is swept
    durable.write_snapshot(str(tmp_path), 2, {"w": np.ones(3) * 2})
    stale = tmp_path / ".old-step_00000002-9-9"
    stale.mkdir()
    DurableCheckpointManager(str(tmp_path))
    assert not stale.exists() and final.is_dir()
    values, _ = durable.read_snapshot(str(final))
    np.testing.assert_array_equal(next(iter(values.values())),
                                  np.ones(3) * 2)


def _transient_leaf_read(tmp_path, monkeypatch):
    a, step = _port_workload()
    mgr = DurableCheckpointManager(str(tmp_path), fsync=False)
    mgr.save(0, a)
    step()
    mgr.save(1, a)
    mgr.wait()
    real_open = builtins.open
    flakes = {"n": 2}

    def flaky_open(file, *args, **kwargs):
        name = str(file)
        if "step_00000001" in name and "leaf_" in name and flakes["n"] > 0:
            flakes["n"] -= 1
            raise OSError(5, "Input/output error", name)
        return real_open(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", flaky_open)
    with pytest.raises(OSError) as ei:
        durable.read_snapshot(str(tmp_path / "step_00000001"))
    assert not isinstance(ei.value, CheckpointCorruptError)
    retry_io(lambda: mgr.restore(a), retries=3, backoff_s=0.0)
    assert mgr.last_restore["step"] == 1
    assert flakes["n"] == 0


def _missing_leaf(tmp_path, monkeypatch):
    durable.write_snapshot(str(tmp_path), 0, {"w": np.ones(3)})
    os.unlink(tmp_path / "step_00000000" / "leaf_00000.npy")
    with pytest.raises(CheckpointCorruptError, match="missing"):
        durable.read_snapshot(str(tmp_path / "step_00000000"))


SCENARIOS = {f.__name__[1:]: f for f in (
    _truncation, _bit_flip, _all_corrupt, _stale_tmp,
    _background_error_on_wait, _async_retry, _safe_under_in_place_updates,
    _close_stops_writer, _resave_crash_window, _resave_commits_new_payload,
    _crash_between_aside_and_commit, _transient_leaf_read, _missing_leaf)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_durable_scenario(name, tmp_path, monkeypatch):
    SCENARIOS[name](tmp_path, monkeypatch)
