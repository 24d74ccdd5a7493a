"""The port's data-parallel reduction (``apex_tpu_torch.parallel.
distributed``) across 4 gloo processes on the CPU, against the JAX
package's ``reduce_gradients`` / ``broadcast`` under ``shard_map`` on a
4-device CPU mesh (the matrix of ``tests/distributed/test_ddp.py``).

The ranks are spawned once (``run_ranks``, a 120 s deadline); each runs
every case and writes its results, which the tests hold against JAX
here.  Every case reduces with a small ``message_size`` (24 elements),
so leaves straddle bucket edges and one leaf fills a bucket alone.

Tolerances: fp32 within ``1e-6`` relative (gloo and XLA sum four
values in other orders); bf16 leaves on the fp32 wire within one bf16
ulp of JAX's sum and of the exact one (one rounding); on a bf16 wire,
where each of the ``WORLD - 1`` adds rounds (gloo's and XLA's in other
orders) by at most ``2**-8`` of its partial sum, each element within
``2 * (WORLD - 1) * 2**-8 * sum(|g_r|)`` of JAX's; the ranks' results
equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import ReduceConfig as JaxReduceConfig
from apex_tpu.parallel import broadcast as jax_broadcast
from apex_tpu.parallel import data_parallel_mesh
from apex_tpu.parallel import reduce_gradients as jax_reduce
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch.parallel import (DistributedDataParallel, ReduceConfig,
                                     Reducer, plan_buckets)
from apex_tpu_torch.parallel import distributed as tdist
from apex_tpu_torch.testing import bf16_ulp_distance, run_ranks

WORLD = 4
MESSAGE = 24
SHAPES = [(3, 5), (7,), (2, 2, 3), (40,), (1,), (6, 4)]
CONFIGS = {f"f{f:g}_avg{int(avg)}": dict(gradient_predivide_factor=f,
                                         gradient_average=avg)
           for f in (1.0, 2.0) for avg in (True, False)}


def _leaves(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((WORLD,) + s).astype(dtype) for s in SHAPES]


RANK = r'''
import sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
from apex_tpu_torch.parallel import (DistributedDataParallel, ReduceConfig,
                                     ReduceOp, all_gather, all_reduce,
                                     broadcast, collective_counts,
                                     multiproc, reduce_gradients,
                                     reset_collective_counts)
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r, w = dist.get_rank(), dist.get_world_size()
SHAPES = %(shapes)r
MESSAGE = %(message)d
CONFIGS = %(configs)r

def leaves(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((w,) + s).astype(dtype)[r])
            for s in SHAPES]

res = {}
g = reduce_gradients([torch.tensor(float(r + 1))])
res["closed_form"] = g[0].numpy()
reset_collective_counts()
for name, kw in CONFIGS.items():
    got = reduce_gradients(leaves(1), config=ReduceConfig(**kw),
                           message_size=MESSAGE)
    for i, t in enumerate(got):
        res[f"{name}/{i}"] = t.numpy()
res["buckets"] = np.asarray(collective_counts()["all_reduce"])
for wire in (True, False):
    got = reduce_gradients(
        [t.to(torch.bfloat16) for t in leaves(2)],
        config=ReduceConfig(allreduce_always_fp32=wire,
                            gradient_average=False), message_size=MESSAGE)
    assert all(t.dtype == torch.bfloat16 for t in got)
    for i, t in enumerate(got):
        res[f"bf16_wire{int(wire)}/{i}"] = t.float().numpy()
ddp = DistributedDataParallel(compression="sign", message_size=MESSAGE)
for i, t in enumerate(ddp.reduce(leaves(3))):
    res[f"sign/{i}"] = t.numpy()
for i, t in enumerate(broadcast(leaves(4), root=3)):
    res[f"broadcast/{i}"] = t.numpy()
x = torch.tensor([float(r), -float(r)])
res["max"] = all_reduce(x, op=ReduceOp.MAX).numpy()
res["min"] = all_reduce(x, op=ReduceOp.MIN).numpy()
res["gather"] = all_gather({"a": x})["a"].numpy()
try:
    all_reduce(x, op=ReduceOp.PRODUCT)
    res["product_raises"] = np.asarray(False)
except NotImplementedError:
    res["product_raises"] = np.asarray(True)
model = torch.nn.Linear(3, 2)
with torch.no_grad():
    model.weight.fill_(float(r))
    model.bias.fill_(float(r) + 0.5)
ddp.broadcast_params(model, root=1)
res["module_weight"] = model.weight.detach().numpy()
res["module_bias"] = model.bias.detach().numpy()
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ddp")
    run_ranks(RANK % dict(shapes=SHAPES, message=MESSAGE, configs=CONFIGS),
              WORLD, work)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh():
    return data_parallel_mesh(num_devices=WORLD)


def _jax(mesh, fn, leaves):
    out = jax.jit(shard_map(lambda *ls: fn([l[0] for l in ls]), mesh=mesh,
                            in_specs=(P("data"),) * len(leaves),
                            out_specs=P()))(*[jnp.asarray(l) for l in leaves])
    return [np.asarray(o, np.float32) for o in out]


def _same_on_every_rank(ranks, key):
    for r in range(1, WORLD):
        assert np.array_equal(ranks[r][key], ranks[0][key]), (key, r)
    return ranks[0][key]


def test_closed_form_mean(ranks):
    # rank r's gradient is r + 1: the mean over 4 ranks is 2.5
    np.testing.assert_allclose(_same_on_every_rank(ranks, "closed_form"),
                               2.5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predivide_and_average_match_jax(ranks, mesh, name):
    kw = CONFIGS[name]
    leaves = _leaves(1)
    want = _jax(mesh, lambda ls: jax_reduce(ls, "data",
                                            JaxReduceConfig(**kw)), leaves)
    f = kw["gradient_predivide_factor"]
    for i, w in enumerate(want):
        got = _same_on_every_rank(ranks, f"{name}/{i}")
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7)
        # average: the mean; off: sum / f, the predivide not cancelled
        closed = leaves[i].sum(0) / (WORLD if kw["gradient_average"] else f)
        np.testing.assert_allclose(got, closed, rtol=1e-5, atol=1e-6)


def test_the_leaves_went_in_buckets(ranks):
    ids = plan_buckets([int(np.prod(s)) for s in SHAPES], MESSAGE)
    assert list(ids) == [0, 0, 0, 1, 2, 2]
    # one all_reduce a bucket, 3 buckets a config
    assert int(ranks[0]["buckets"]) == 3 * len(CONFIGS)


@pytest.mark.parametrize("wire", [1, 0])
def test_bf16_leaves_within_an_ulp_of_jax(ranks, mesh, wire):
    leaves = [l.astype(jnp.bfloat16) for l in _leaves(2)]
    cfg = JaxReduceConfig(allreduce_always_fp32=bool(wire),
                          gradient_average=False)
    want = _jax(mesh, lambda ls: jax_reduce(ls, "data", cfg), leaves)
    for i, w in enumerate(want):
        got = _same_on_every_rank(ranks, f"bf16_wire{wire}/{i}")
        if wire:
            assert bf16_ulp_distance(
                torch.from_numpy(got).to(torch.bfloat16),
                torch.from_numpy(w).to(torch.bfloat16)) <= 1, i
        else:
            mag = np.abs(np.asarray(leaves[i], np.float32)).sum(0)
            assert (np.abs(got - w)
                    <= 2 * (WORLD - 1) * 2.0 ** -8 * mag).all(), i
    if wire:
        # the fp32 wire rounds once: within an ulp of the exact sum
        for i, l in enumerate(leaves):
            exact = torch.from_numpy(np.asarray(l, np.float32).sum(0))
            got = torch.from_numpy(ranks[0][f"bf16_wire1/{i}"]).to(
                torch.bfloat16)
            assert bf16_ulp_distance(got, exact.to(torch.bfloat16)) <= 1


def test_sign_compression_matches_jax(ranks, mesh):
    leaves = _leaves(3)
    cfg = JaxReduceConfig(compression="sign")
    want = _jax(mesh, lambda ls: jax_reduce(ls, "data", cfg), leaves)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(_same_on_every_rank(ranks, f"sign/{i}"),
                                      w)


def test_broadcast_from_root_matches_jax(ranks, mesh):
    leaves = _leaves(4)
    want = _jax(mesh, lambda ls: jax_broadcast(ls, "data", root=3), leaves)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(
            _same_on_every_rank(ranks, f"broadcast/{i}"), w)
        np.testing.assert_array_equal(w, leaves[i][3])


def test_ops_gather_and_module_broadcast(ranks):
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "max"),
                                  [3.0, 0.0])
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "min"),
                                  [0.0, -3.0])
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "gather"),
        [[float(r), -float(r)] for r in range(WORLD)])
    assert bool(ranks[0]["product_raises"])
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "module_weight"), np.ones((2, 3)))
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "module_bias"), np.full(2, 1.5))


def test_plan_buckets_is_the_jax_packages():
    from apex_tpu import _native
    rng = np.random.RandomState(5)
    numels = [int(n) for n in rng.randint(1, 50, 40)]
    trig = [bool(t) for t in rng.randint(0, 2, 40) * (rng.rand(40) < 0.2)]
    for message in (1, 30, 100, 10_000):
        np.testing.assert_array_equal(
            plan_buckets(numels, message, trig),
            _native.plan_buckets(numels, message, trig))
    with pytest.raises(ValueError, match="triggers"):
        plan_buckets([1, 2], 4, [True])


def test_the_wrappers_fold_the_knobs_as_jax_does():
    ddp = DistributedDataParallel(gradient_average=False,
                                  gradient_predivide_factor=4.0)
    assert ddp.config == ReduceConfig(gradient_average=False,
                                      gradient_predivide_factor=4.0)
    assert Reducer().config == ReduceConfig()
    with pytest.raises(ValueError, match="not both"):
        Reducer(config=ReduceConfig(), gradient_average=True)
    assert ddp.reduce_fn.__self__ is ddp
    ids = DistributedDataParallel(message_size=10).plan_buckets(
        {"a": torch.zeros(6), "b": torch.zeros(6), "c": torch.zeros(3)})
    assert list(ids) == [0, 0, 1]


def test_axis_names_and_a_missing_group_are_refused():
    with pytest.raises(ValueError, match="ProcessGroup"):
        tdist.process_group("model")
    with pytest.raises(ValueError, match="ProcessGroup"):
        tdist.process_group(3)
    with pytest.raises(RuntimeError, match="initialize"):
        tdist.reduce_gradients([torch.zeros(2)])
