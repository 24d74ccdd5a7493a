"""The whole data-parallel step across 2 gloo processes on the CPU: the
small Bottleneck ResNet of ``tests/test_torch_resnet.py`` (stages (1, 1,
1, 1), width 8, 10 classes, converted from JAX weights), made
synchronized by ``convert_syncbn_model`` and reduced by
``DistributedDataParallel``, 3 FusedAdam steps at O0 and at O2, each rank
on its half of the B 8 x 32^2 batch (``shard_rows``); and at O2 with
``accum_steps=2`` and a ``Reducer``.

By definition that step is the same ResNet stepped once in one process,
with local BatchNorm, on the whole batch at the mean loss; JAX's
whole-batch ``make_train_step`` is the oracle (the JAX package cannot run
its own DDP and SyncBatchNorm together here: its BatchNorm backward
hands back an axis-invariant scale gradient for a varying one, a
``ValueError`` under ``shard_map``).  With accumulation the whole batch
is ordered so that JAX's micro-batch k holds both ranks' micro-batch k.

Tolerances are ``tests/test_torch_resnet.py``'s (its docstring says
why): O0 losses within ``1e-5``, masters within lr with all but 1%
within ``1e-5``, running stats within ``1e-4`` (relative above 1); O2
losses within ``3e-2`` of JAX's O2, the first within ``1e-2`` of JAX's
fp32 loss, equal scales and overflow flags.  The ranks' masters and
running stats are equal bit for bit.  An inf on rank 1 alone (its loss
times ``1 + sum(poison)``) skips the step on both ranks and halves both
scales.  The ranks are spawned once (``start_ranks``, a 120 s
deadline) and run while JAX compiles.
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
from apex_tpu_torch.convert import resnet_params_from_jax
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.testing import start_ranks

SMALL = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
WORLD = 2
B = 8
STEPS = 3
LR = 1e-3
RUNS = {"O0": ("O0", None), "O2": ("O2", None), "O2_accum2": ("O2", 2)}


def _batch():
    rng = np.random.RandomState(1)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.randint(0, 10, (B,)).astype(np.int32))


def _accum_order(a, world=WORLD, n=2):
    """The whole batch as JAX's ``accum_steps=n`` splits it, from the
    ranks' batches: micro-batch k is every rank's micro-batch k."""
    per = a.shape[0] // world // n
    ranks = [a[r * per * n:(r + 1) * per * n] for r in range(world)]
    return np.concatenate([rk[k * per:(k + 1) * per]
                           for k in range(n) for rk in ranks])


RANK = r'''
import sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
from apex_tpu_torch import amp
from apex_tpu_torch.models import ResNet, resnet_loss, shard_rows
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                     convert_syncbn_model, multiproc)
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r, w = dist.get_rank(), dist.get_world_size()
state = torch.load(out / "init.pt")
data = np.load(out / "batch.npz")
RUNS = %(runs)r

def loss_fn(m, x, y, poison):
    return resnet_loss(m(x, train=True), y) * (1 + poison.sum())

res = {}
for name, (level, accum) in RUNS.items():
    model = ResNet(device="cpu", **%(small)r)
    model.load_state_dict(state)
    model = convert_syncbn_model(model, axis_name="data")
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=%(lr)r,
                                        device="cpu"),
                       opt_level=level, device="cpu")
    reducer = Reducer() if accum else DistributedDataParallel()
    step = amp.make_train_step(a, model, loss_fn, reduce_fn=reducer.reduce,
                               accum_steps=accum)
    x, y = shard_rows([torch.from_numpy(data["x"]),
                       torch.from_numpy(data["y"]).long()], r, w)
    clean = torch.zeros(x.shape[0])
    infos = [step(x, y, clean) for _ in range(%(steps)d)]
    for k in ("loss", "loss_scale", "overflow"):
        res[f"{name}/{k}"] = np.asarray([float(i[k]) for i in infos])
    for n, t in a.masters.items():
        res[f"{name}/master/{n}"] = t.detach().numpy().copy()
    for n, t in model.named_buffers():
        res[f"{name}/stat/{n}"] = t.numpy().copy()
    # an inf on rank 1 alone: skipped on every rank
    poison = clean.clone()
    if r == 1:
        poison[0] = float("inf")
    info = step(x, y, poison)
    res[f"{name}/inf_overflow"] = np.asarray(bool(info["overflow"]))
    res[f"{name}/inf_scale"] = np.asarray(float(info["loss_scale"]))
    res[f"{name}/inf_kept"] = np.asarray(all(
        np.array_equal(t.detach().numpy(), res[f"{name}/master/{n}"])
        for n, t in a.masters.items()))
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def jax_init():
    x, _ = _batch()
    model = jr.ResNet(block_cls=jr.Bottleneck, **SMALL)
    v = jax.jit(functools.partial(model.init, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x[:4]))
    return (model, jax.tree.map(np.asarray, v["params"]),
            jax.tree.map(np.asarray, v["batch_stats"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    """The ranks' results and JAX's whole-batch runs (which compile while
    the ranks run)."""
    _, params, stats = jax_init
    work = tmp_path_factory.mktemp("ddp_resnet")
    model = resnet_params_from_jax(params, stats, tr.ResNet, device="cpu",
                                   trainable=True, **SMALL)
    torch.save(model.state_dict(), work / "init.pt")
    x, y = _batch()
    np.savez(work / "batch.npz", x=x, y=y)
    wait = start_ranks(RANK % dict(runs=RUNS, small=SMALL, lr=LR,
                                   steps=STEPS), WORLD, work)
    jax_runs = {name: _jax_steps(jax_init, lvl, accum)
                for name, (lvl, accum) in RUNS.items()}
    wait()
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)], \
        jax_runs


def _jax_steps(jax_init, opt_level, accum):
    """JAX's whole-batch steps; with ``accum`` on the batch reordered so
    that each of its micro-batches is both ranks' micro-batch."""
    jmodel, params, stats = jax_init
    x, y = _batch()
    if accum:
        x, y = _accum_order(x), _accum_order(y)
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
        s2, m = jax_amp.make_train_step(a, loss_fn, has_aux=True,
                                        accum_steps=accum)(s, x, y)
        aux = m["aux"]
        if accum:
            aux = jax.tree.map(lambda t: t[-1], aux)
        return s2, aux, m

    step = jax.jit(step)
    metrics = []
    for _ in range(STEPS):
        state, stats, m = step(state, stats, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "loss_scale", "overflow")})
    return (metrics, dict(_leaves(jax.tree.map(np.asarray,
                                               state.master_params))),
            dict(_leaves(jax.tree.map(np.asarray, stats))))


def _bitwise_across_ranks(ranks, name):
    keys = [k for k in ranks[0] if k.startswith(name + "/master/")
            or k.startswith(name + "/stat/")]
    assert keys
    for k in keys:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


def _losses(ranks, name):
    # each rank's loss is its half's mean: their mean is the batch's
    return np.mean([rk[f"{name}/loss"] for rk in ranks], axis=0)


def test_o0_steps_match_jaxs_whole_batch(ranks):
    ranks, jax_runs = ranks
    jm, jmasters, jstats = jax_runs["O0"]
    losses = _losses(ranks, "O0")
    for j, t in zip(jm, losses):
        assert abs(j["loss"] - t) <= 1e-5, (jm, losses)
    for rk in ranks:
        assert (rk["O0/loss_scale"] == 1.0).all()
        assert not rk["O0/overflow"].any()
    beyond = total = 0
    for path, w in jmasters.items():
        got = ranks[0]["O0/master/" + path]
        np.testing.assert_allclose(got, w, atol=LR, rtol=0, err_msg=path)
        beyond += int((np.abs(got - w) > 1e-5).sum())
        total += w.size
    assert beyond <= 0.01 * total, (beyond, total)
    for path, v in jstats.items():
        d = np.abs(ranks[0]["O0/stat/" + path] - v)
        assert (d <= 1e-4 * np.maximum(1.0, np.abs(v))).all(), path
    _bitwise_across_ranks(ranks, "O0")


@pytest.mark.parametrize("name", ["O2", "O2_accum2"])
def test_o2_steps_match_jaxs_whole_batch(ranks, name):
    ranks, jax_runs = ranks
    jm, _, _ = jax_runs[name]
    losses = _losses(ranks, name)
    if name == "O2":
        assert abs(losses[0] - jax_runs["O0"][0][0]["loss"]) <= 1e-2
    for i, j in enumerate(jm):
        assert abs(j["loss"] - losses[i]) <= 3e-2, (jm, losses)
        for rk in ranks:
            assert rk[f"{name}/loss_scale"][i] == j["loss_scale"]
            assert float(rk[f"{name}/overflow"][i]) == j["overflow"] == 0.0
    assert losses[-1] < losses[0]
    _bitwise_across_ranks(ranks, name)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_an_inf_on_one_rank_skips_the_step_on_both(ranks, name):
    ranks, _ = ranks
    for rk in ranks:
        assert bool(rk[f"{name}/inf_overflow"]), name
        assert bool(rk[f"{name}/inf_kept"]), name
        want = 1.0 if name == "O0" else rk[f"{name}/loss_scale"][-1] / 2
        assert float(rk[f"{name}/inf_scale"]) == want, name
