"""The port's expert parallelism (``apex_tpu_torch.parallel.moe``) against
the JAX package's on the CPU.

- ``top1_routing`` on seeded logits with a router tie (two experts at one
  row's maximum: the lower index wins on both sides): dispatch and
  combine equal, aux within 1e-6.
- ``moe_apply`` across 4 gloo processes (2 experts a rank, 8 in all, D 8,
  hidden 16, 32 tokens a rank), against JAX's under ``shard_map`` on 4
  virtual CPU devices, at capacity factor 8.0 (nothing dropped) and 1.0
  (tokens dropped): y, aux and the gradients of every expert weight, the
  router (summed over the ranks, as JAX sums a replicated input's) and
  the tokens, of the global loss ``mean(y ** 2) + 0.01 · aux`` (each rank
  taking its share: ``sum(y_r ** 2) / y.numel() + 0.01 · aux / W``),
  within 1e-5.
- The example's expert mode (``examples/pipeline_moe.py --mode ep``: 4
  ranks, 8 experts of 32 -> 128 -> 32 with gelu, cf 2.0, batch 32, amp
  O2, FusedAdam 3e-3, the router's gradient averaged over the group by
  ``reduce_fn``, ``finite_axes=("expert",)``) for 5 steps: losses within
  2**-8 relative of JAX's ``make_train_step`` (run without the example's
  ``axis_name=``, which raises on jax 0.9, and with XLA rounding every
  bf16 op as the port does; see ``JAX_EP``); then an inf
  in rank 1's loss skips the step on every rank (masters kept, scale
  halved).

The ranks are started once (``start_ranks``, a 120 s deadline) and run
while the JAX references compute.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jax_amp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel.moe import moe_apply as jax_moe
from apex_tpu.parallel.moe import top1_routing as jax_routing
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch.parallel import top1_routing
from apex_tpu_torch.testing import start_ranks

RANKS, E_LOCAL, D, HIDDEN, T_LOCAL = 4, 2, 8, 16, 32
TOL = 1e-5
CFS = (8.0, 1.0)
EP_D, EP_BATCH, EP_STEPS = 32, 32, 5
EP_REL = 2.0 ** -8


def _moe_data():
    rng = np.random.RandomState(0)
    e = RANKS * E_LOCAL
    return (rng.randn(e, D, HIDDEN).astype(np.float32) * 0.3,
            rng.randn(e, HIDDEN, D).astype(np.float32) * 0.3,
            rng.randn(D, e).astype(np.float32),
            rng.randn(RANKS * T_LOCAL, D).astype(np.float32))


def _ep_data():
    rng = np.random.RandomState(9)
    e, hidden = RANKS * E_LOCAL, 4 * EP_D
    x = rng.randn(EP_BATCH, EP_D).astype(np.float32)
    target = np.tanh(x @ rng.randn(EP_D, EP_D).astype(np.float32))
    return (x, target.astype(np.float32),
            rng.randn(e, EP_D, hidden).astype(np.float32) * 0.3,
            rng.randn(e, hidden, EP_D).astype(np.float32) * 0.3,
            rng.randn(EP_D, e).astype(np.float32))


RANK = r'''
import sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (all_reduce, collective_counts,
                                     make_mesh, moe_apply, multiproc,
                                     reset_collective_counts)
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r, w = dist.get_rank(), dist.get_world_size()
make_mesh((w,), ("expert",))
EL = %(e_local)d
res = {}


def ffn(p, h):
    return F.gelu(h @ p["wi"], approximate="tanh") @ p["wo"]


wi, wo, router, x = (torch.from_numpy(np.load(out / f"moe_{k}.npy"))
                     for k in ("wi", "wo", "router", "x"))
t = x.shape[0] // w
for cf in %(cfs)r:
    ps = [wi[r * EL:(r + 1) * EL].clone().requires_grad_(True),
          wo[r * EL:(r + 1) * EL].clone().requires_grad_(True),
          router.clone().requires_grad_(True),
          x[r * t:(r + 1) * t].clone().requires_grad_(True)]
    reset_collective_counts()
    y, aux = moe_apply(ffn, {"wi": ps[0], "wo": ps[1]}, ps[2], ps[3],
                       "expert", capacity_factor=cf)
    loss = (y ** 2).sum() / (x.numel()) + 0.01 * aux / w
    grads = torch.autograd.grad(loss, ps)
    key = f"cf{cf}"
    res[key + "/y"], res[key + "/aux"] = y.detach().numpy(), float(aux)
    for n, g in zip(("wi", "wo", "router", "x"), grads):
        res[f"{key}/d{n}"] = g.numpy()
    res[key + "/counts"] = np.asarray([collective_counts().get(k, 0) for k
                                       in ("all_to_all", "all_reduce")])
    res[key + "/zero_rows"] = np.asarray(
        int((y.detach().abs().sum(-1) == 0).sum()))

# the example's expert mode at O2
xe, target, ewi, ewo, erouter = (np.load(out / f"ep_{k}.npy") for k in
                                 ("x", "t", "wi", "wo", "router"))
m = torch.nn.Module()
m.wi = torch.nn.Parameter(torch.from_numpy(ewi[r * EL:(r + 1) * EL].copy()))
m.wo = torch.nn.Parameter(torch.from_numpy(ewo[r * EL:(r + 1) * EL].copy()))
m.router = torch.nn.Parameter(torch.from_numpy(erouter))
a = amp.initialize(m, FusedAdam(m.parameters(), lr=3e-3, device="cpu"),
                   opt_level="O2", device="cpu")
t = xe.shape[0] // w
xb = torch.from_numpy(xe[r * t:(r + 1) * t].copy())
tgt = torch.from_numpy(target[r * t:(r + 1) * t].copy())
names = [n for n, _ in m.named_parameters()]


def ep_loss(mod, xb, poison):
    y, aux = moe_apply(ffn, {"wi": mod.wi, "wo": mod.wo}, mod.router, xb,
                       "expert")
    y = xb + y
    loss = ((y - tgt).float() ** 2).mean() + 0.01 * aux.float()
    return loss * (1 + poison.sum())


def reduce_fn(grads):
    grads = list(grads)
    i = names.index("router")
    grads[i] = all_reduce(grads[i], "expert") / w
    return grads


step = amp.make_train_step(a, m, ep_loss, reduce_fn=reduce_fn,
                           finite_axes=("expert",))
clean = torch.zeros(t)
res["ep/losses"] = np.asarray([float(step(xb, clean)["loss"])
                               for _ in range(%(ep_steps)d)])
before = {n: v.clone() for n, v in a.masters.items()}
scale = float(a.scaler_state.loss_scale)
poison = clean.clone()
if r == 1:
    poison[0] = float("inf")
info = step(xb, poison)
res["ep/inf_overflow"] = np.asarray(bool(info["overflow"]))
res["ep/inf_kept"] = np.asarray(all(bool(torch.equal(before[n], v))
                                    for n, v in a.masters.items()))
res["ep/inf_scale"] = np.asarray([scale, float(info["loss_scale"])])
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("moe")


@pytest.fixture(scope="module")
def ranks(work, jax_ep_proc):
    for k, v in zip(("wi", "wo", "router", "x"), _moe_data()):
        np.save(work / f"moe_{k}.npy", v)
    for k, v in zip(("x", "t", "wi", "wo", "router"), _ep_data()):
        np.save(work / f"ep_{k}.npy", v)
    return start_ranks(RANK % dict(e_local=E_LOCAL, cfs=CFS,
                                   ep_steps=EP_STEPS), RANKS, work)


@pytest.fixture(scope="module")
def results(ranks, work, jax_moe_runs, jax_ep):
    ranks()
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(RANKS)]


def _mesh():
    return Mesh(np.array(jax.devices()[:RANKS]), ("expert",))


def _jax_ffn(p, h):
    return jax.nn.gelu(h @ p["wi"]) @ p["wo"]


@pytest.fixture(scope="module")
def jax_moe_runs(ranks):
    wi, wo, router, x = (jnp.asarray(a) for a in _moe_data())
    out = {}
    for cf in CFS:
        f = shard_map(
            lambda ep, rw, x, cf=cf: jax_moe(_jax_ffn, ep, rw, x, "expert",
                                             capacity_factor=cf),
            mesh=_mesh(), in_specs=(P("expert"), P(), P("expert")),
            out_specs=(P("expert"), P()))

        def loss(wi, wo, rw, x):
            y, aux = f({"wi": wi, "wo": wo}, rw, x)
            return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(wi, wo, router, x)
        key = f"cf{cf}"
        out[key + "/y"], out[key + "/aux"] = np.asarray(y), float(aux)
        for n, g in zip(("wi", "wo", "router", "x"), grads):
            out[f"{key}/d{n}"] = np.asarray(g)
    return out


def _jax_ep_losses():
    """The example's expert mode at O2 on 4 virtual devices: its losses.
    Run by :func:`jax_ep` in a process of its own."""
    x, target, wi, wo, router = _ep_data()
    params = {"experts": {"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
              "router": jnp.asarray(router)}
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3), opt_level="O2",
                           verbosity=0)
    axis = "expert"

    def loss_fn(p, xb):
        y, aux = jax_moe(_jax_ffn, p["experts"], p["router"], xb, axis)
        y = xb + y
        i = jax.lax.axis_index(axis)
        tgt = jax.lax.dynamic_slice_in_dim(jnp.asarray(target),
                                           i * xb.shape[0], xb.shape[0])
        return (jnp.mean(jnp.square((y - tgt).astype(jnp.float32)))
                + 0.01 * aux.astype(jnp.float32))

    # the example passes axis_name=, whose pvary of the already
    # expert-varying weights raises on jax 0.9: without it JAX's autodiff
    # sums the replicated router's gradient over the ranks, and dividing
    # by W gives the example's pmean
    def reduce_grads(g):
        return {"experts": g["experts"], "router": g["router"] / RANKS}

    state = a.init(params)
    train = jax_amp.make_train_step(a, loss_fn, reduce_fn=reduce_grads,
                                    finite_axes=(axis,))

    def train_step(state, xb):
        new_state, metrics = train(state, xb)
        return new_state, jax.lax.pmean(metrics["loss"], axis)

    specs = jtu.tree_map_with_path(
        lambda path, leaf: P(axis) if "experts" in jtu.keystr(path)
        and getattr(leaf, "ndim", 0) >= 1 else P(), state)
    step = jax.jit(shard_map(train_step, mesh=_mesh(),
                             in_specs=(specs, P(axis)),
                             out_specs=(specs, P())))
    losses = []
    for _ in range(EP_STEPS):
        state, loss = step(state, jnp.asarray(x))
        losses.append(float(loss))
    return np.asarray(losses)


#: XLA rounds each bf16 op as the program writes it, as the port does:
#: by default it computes fused bf16 chains in fp32 (the first loss
#: 13.0528, against 13.1004 rounded op by op and 13.0706 in fp32), and
#: the expert outputs, summed into a mean square of values near 3.6,
#: carry that 0.4% into the loss.  The flag must be set before JAX's
#: backend starts, hence a process of its own.
JAX_EP = r'''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_moe as t
np.save(sys.argv[2], t._jax_ep_losses())
'''


@pytest.fixture(scope="module")
def jax_ep_proc(work):
    import os
    import pathlib
    import subprocess
    import sys
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(here.parent) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-c", JAX_EP, str(here), str(work / "jax_ep.npy")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def jax_ep(jax_ep_proc, work):
    _, err = jax_ep_proc.communicate(timeout=300)
    assert jax_ep_proc.returncode == 0, err[-3000:]
    return list(np.load(work / "jax_ep.npy"))


def test_top1_routing_matches_jax_with_a_tie():
    rng = np.random.RandomState(3)
    logits = rng.randn(32, 8).astype(np.float32)
    logits[5, 2] = logits[5, 6] = logits[5].max() + 1.0   # a router tie
    for capacity in (2, 8):
        jd, jc, ja = jax_routing(jnp.asarray(logits), capacity)
        d, c, a = top1_routing(torch.from_numpy(logits), capacity)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
        assert d[5, 2].sum() == 1 and d[5, 6].sum() == 0


@pytest.mark.parametrize("cf", CFS)
def test_moe_apply_matches_jax(results, jax_moe_runs, cf):
    key = f"cf{cf}"
    want = jax_moe_runs
    y = np.concatenate([rk[key + "/y"] for rk in results])
    np.testing.assert_allclose(y, want[key + "/y"], rtol=TOL, atol=TOL)
    for rk in results:
        np.testing.assert_allclose(float(rk[key + "/aux"]),
                                   want[key + "/aux"], rtol=TOL)
    for n in ("wi", "wo", "x"):
        got = np.concatenate([rk[f"{key}/d{n}"] for rk in results])
        np.testing.assert_allclose(got, want[f"{key}/d{n}"], rtol=TOL,
                                   atol=TOL, err_msg=n)
    router = sum(rk[f"{key}/drouter"] for rk in results)
    np.testing.assert_allclose(router, want[f"{key}/drouter"], rtol=TOL,
                               atol=TOL)
    # every expert's weights receive gradient
    assert (np.abs(np.concatenate([rk[f"{key}/dwi"] for rk in results]))
            .reshape(RANKS * E_LOCAL, -1).max(-1) > 0).all()


def test_capacity_one_drops_tokens_and_nothing_at_eight(results):
    dropped = {cf: sum(int(rk[f"cf{cf}/zero_rows"]) for rk in results)
               for cf in CFS}
    assert dropped[8.0] == 0 and dropped[1.0] > 0, dropped


def test_exchanges_a_call(results):
    """Two all-to-alls forward and their two inverses backward, and the
    aux mean's all-reduce forward and backward."""
    for rk in results:
        for cf in CFS:
            assert list(rk[f"cf{cf}/counts"]) == [4, 2]


def test_example_expert_mode_o2_matches_jax(results, jax_ep):
    """Each rank's loss covers its tokens; the example prints their mean
    over the group."""
    mean = np.mean([rk["ep/losses"] for rk in results], axis=0)
    np.testing.assert_allclose(mean, jax_ep, rtol=EP_REL)
    assert jax_ep[-1] < jax_ep[0]


def test_one_ranks_inf_skips_every_expert_rank(results):
    for rk in results:
        assert bool(rk["ep/inf_overflow"]) and bool(rk["ep/inf_kept"])
        before, after = rk["ep/inf_scale"]
        assert after == before / 2


def test_jax_fails_on_the_example_expert_mode_with_axis_name():
    """The reference caveat: the example's ``make_train_step(...,
    axis_name="expert")`` pvaries parameters that ``shard_map`` already
    made expert-varying, which jax 0.9 refuses."""
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3), opt_level="O2",
                           verbosity=0)
    params = {"w": jnp.ones((RANKS, 4))}
    state = a.init(params)
    train = jax_amp.make_train_step(
        a, lambda p, xb: jnp.mean(xb @ p["w"].T), axis_name="expert")
    specs = jtu.tree_map_with_path(
        lambda path, leaf: P("expert") if "'w'" in jtu.keystr(path)
        and getattr(leaf, "ndim", 0) >= 1 else P(), state)
    f = shard_map(lambda st, xb: train(st, xb)[1]["loss"], mesh=_mesh(),
                  in_specs=(specs, P("expert")), out_specs=P("expert"))
    with pytest.raises(ValueError, match="pvary"):
        jax.eval_shape(f, state, jnp.ones((RANKS, 4)))
