"""The port's SyncBatchNorm across 4 gloo processes on the CPU, against
the JAX package's ``SyncBatchNorm(axis_name="data", process_group=...)``
under ``shard_map`` on a 4-device CPU mesh: the output, the running mean
and var, the input gradient and the rank-summed scale / bias gradients.

Cases: the whole group (``axis_name="data"``, W 4: two sum rounds); two
groups of 2 as rank lists (``create_syncbn_process_group(2, 4)``: a
gather and Chan's merge); each pair's ``ProcessGroup`` passed as
``axis_name`` (the whole-group form at W 2, against JAX's groups of 2);
NCHW (``channel_axis=1``); fp16 input; and ``fused_backward=False``
(plain autograd through ``torch.distributed.nn``'s sums).  The scale and
bias gradients stay per rank in the port (DDP reduces them), where JAX's
backward sums them over the axis: the port's sum over the ranks is held
against JAX's.  Eval makes no collective.

The ranks are spawned once (``run_ranks``, a 120 s deadline).
Tolerances: fp32 ``rtol = atol = 1e-5`` (SyncBN's, ``BASELINE.md:19``);
fp16 input ``1e-3`` (the same line's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import data_parallel_mesh
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxBN
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch.parallel import create_syncbn_process_group
from apex_tpu_torch.testing import run_ranks

WORLD = 4
GROUPS = [[0, 1], [2, 3]]
#: case -> (global input shape, dtype, channel axis, JAX process_group)
CASES = {"whole": ((8, 3, 3, 5), "float32", -1, None),
         "groups": ((8, 3, 3, 5), "float32", -1, GROUPS),
         "pair_group": ((8, 3, 3, 5), "float32", -1, GROUPS),
         "nchw": ((8, 5, 3, 2), "float32", 1, None),
         "fp16": ((8, 3, 3, 5), "float16", -1, None),
         "unfused": ((8, 3, 3, 5), "float32", -1, None)}
TOL = {"float32": 1e-5, "float16": 1e-3}


def _inputs(case):
    shape, dtype, ch, _ = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    c = shape[ch]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(dtype)
    dy = rng.standard_normal(shape).astype(dtype)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, dy, scale, bias


RANK = r'''
import sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
from apex_tpu_torch.parallel import (SyncBatchNorm, collective_counts,
                                     multiproc)
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r, w = dist.get_rank(), dist.get_world_size()
CASES = %(cases)r
GROUPS = %(groups)r
pair, _ = dist.new_subgroups_by_enumeration(GROUPS)

def inputs(case):
    shape, dtype, ch, _ = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    c = shape[ch]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(dtype)
    dy = rng.standard_normal(shape).astype(dtype)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    n = shape[0] // w
    return (torch.from_numpy(x[r * n:(r + 1) * n]),
            torch.from_numpy(dy[r * n:(r + 1) * n]),
            torch.from_numpy(scale), torch.from_numpy(bias))

res = {}
for case, (shape, dtype, ch, groups) in CASES.items():
    x, dy, scale, bias = inputs(case)
    kw = dict(axis_name="data", process_group=groups)
    if case == "pair_group":
        kw = dict(axis_name=pair)
    bn = SyncBatchNorm(shape[ch], channel_axis=ch, device="cpu",
                       fused_backward=case != "unfused", **kw)
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    x.requires_grad_(True)
    y = bn(x)
    (y.float() * dy.float()).sum().backward()
    res[case + "/y"] = y.detach().float().numpy()
    res[case + "/dx"] = x.grad.float().numpy()
    res[case + "/dscale"] = bn.scale.grad.numpy()
    res[case + "/dbias"] = bn.bias.grad.numpy()
    res[case + "/mean"] = bn.mean.numpy()
    res[case + "/var"] = bn.var.numpy()
    before = collective_counts()
    with torch.no_grad():
        bn.eval()(x)
    res[case + "/eval_collectives"] = np.asarray(
        sum(collective_counts().values()) - sum(before.values()))
try:
    SyncBatchNorm(5, axis_name="data", process_group=GROUPS,
                  fused_backward=False, device="cpu")(torch.zeros(2, 5))
    res["unfused_groups_raises"] = np.asarray(False)
except ValueError:
    res["unfused_groups_raises"] = np.asarray(True)
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("syncbn")
    run_ranks(RANK % dict(cases=CASES, groups=GROUPS), WORLD, work)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh():
    return data_parallel_mesh(num_devices=WORLD)


_JITTED = {}


def _jax_case(mesh, case):
    """JAX's output, running stats (every rank's), input gradient and
    total scale / bias gradients under ``shard_map`` (jitted once per
    configuration)."""
    shape, dtype, ch, groups = CASES[case]
    x, dy, scale, bias = _inputs(case)
    key = (shape, dtype, ch, str(groups))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(_jax_fn(mesh, shape, ch, groups))
    (y, mean, var), (gp, gx) = _JITTED[key](
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), jnp.asarray(dy))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(y=f32(y), dx=f32(gx), mean=f32(mean), var=f32(var),
                dscale=f32(gp["scale"]), dbias=f32(gp["bias"]))


def _jax_fn(mesh, shape, ch, groups):
    bn = JaxBN(axis_name="data", process_group=groups, channel_axis=ch,
               use_running_average=False)
    c = shape[ch]
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def fwd(p, xx, dyy):
        def inner(p, xb, db):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xb,
                              mutable=["batch_stats"])
            loss = jax.lax.psum(
                jnp.sum(y.astype(jnp.float32) * db.astype(jnp.float32)),
                "data")
            m = upd["batch_stats"]
            return loss, (y, m["mean"][None], m["var"][None])
        return shard_map(inner, mesh=mesh, in_specs=(P(), P("data"),
                                                     P("data")),
                         out_specs=(P(), (P("data"), P("data"),
                                          P("data"))))(p, xx, dyy)

    def run(p, xx, dyy):
        (_, aux), grads = jax.value_and_grad(fwd, argnums=(0, 1),
                                             has_aux=True)(p, xx, dyy)
        return aux, grads
    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_synced_batchnorm_matches_jax(ranks, mesh, case):
    want = _jax_case(mesh, case)
    tol = TOL[CASES[case][1]]
    n = CASES[case][0][0] // WORLD
    for r, got in enumerate(ranks):
        rows = slice(r * n, (r + 1) * n)
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[f"{case}/{k}"], want[k][rows],
                                       rtol=tol, atol=tol,
                                       err_msg=f"{case} {k} rank {r}")
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[f"{case}/{k}"], want[k][r],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {k} rank {r}")
        assert int(got[f"{case}/eval_collectives"]) == 0
    for k in ("dscale", "dbias"):
        total = sum(got[f"{case}/{k}"] for got in ranks)
        np.testing.assert_allclose(total, want[k], rtol=tol, atol=tol,
                                   err_msg=f"{case} {k}")


def test_a_group_shares_its_statistics_bitwise(ranks):
    for case, (_, _, _, groups) in CASES.items():
        for members in (groups or [list(range(WORLD))]):
            for r in members[1:]:
                for k in ("mean", "var"):
                    np.testing.assert_array_equal(
                        ranks[r][f"{case}/{k}"],
                        ranks[members[0]][f"{case}/{k}"])
    # the two groups normalize with their own statistics
    assert not np.array_equal(ranks[0]["groups/mean"],
                              ranks[2]["groups/mean"])


def test_rank_lists_refuse_the_unfused_backward(ranks):
    assert all(bool(r["unfused_groups_raises"]) for r in ranks)


def test_group_validation_is_jaxs():
    assert create_syncbn_process_group(2, 4) == GROUPS
    assert create_syncbn_process_group(0, 4) is None
    with pytest.raises(ValueError, match="divisible"):
        create_syncbn_process_group(3, 4)
    with pytest.raises(ValueError, match="exceeds"):
        create_syncbn_process_group(8, 4)
