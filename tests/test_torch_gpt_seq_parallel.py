"""The port's sequence-parallel GPT (``GPTConfig.seq_axis_name``, ring
attention over a group, ``lm_loss(..., seq_axis_name=)``) across 2 gloo
processes on the CPU, each rank holding 16 of the 32 positions of a
2-layer ``gpt_tiny`` (fp32), against the JAX package:

- the forward of each rank's block at its global positions against
  JAX's ``shard_map`` forward over a 2-device ``("seq",)`` mesh (within
  1e-5) and its whole-sequence forward (within 1e-4), and with
  ``seq_impl="ulysses"`` against the whole-sequence forward (within
  1e-4);
- 3 amp O0 ``FusedAdam`` steps, the ranks' gradients summed by
  ``Reducer(gradient_average=False)``, against JAX's whole-sequence
  ``make_train_step``: the summed rank losses within 1e-5, the masters
  within 1e-4, equal bit for bit across the ranks;
- the first step's gradients: summed over the ranks they are JAX's
  whole-sequence gradients (within 1e-5 of each leaf's largest
  element); the default, averaging ``Reducer`` gives half of them,
  which the test shows is wrong.

The ranks are spawned once (``run_ranks``, a 120 s deadline).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.models.gpt import GPTModel as JaxGPTModel
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch.testing import run_ranks

WORLD = 2
B, L = 2, 32
STEPS = 3
LR = 1e-3
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _ids():
    return np.random.RandomState(0).randint(0, TINY["vocab_size"],
                                            (B, L)).astype(np.int64)


RANK = r'''
import dataclasses, sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
from apex_tpu_torch import amp
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import GPTConfig, lm_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (Reducer, all_reduce,
                                     collective_counts, multiproc,
                                     reset_collective_counts)
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r, w = dist.get_rank(), dist.get_world_size()
cfg = GPTConfig(seq_axis_name="data", **%(tiny)r)
flat = dict(np.load(out / "params.npz"))
tree = {}
for name, a in flat.items():
    node = tree
    *path, leaf = name.split(".")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = a
ids = np.load(out / "ids.npy")
b, l = ids.shape
n = l // w
lo, hi = r * n, (r + 1) * n
ids_l = torch.from_numpy(ids[:, lo:hi].copy())
pos_l = torch.arange(lo, hi)[None].expand(b, n)
# the next token of each position; the global last one has none
nxt = np.concatenate([ids[:, 1:], np.zeros((b, 1), np.int64)], axis=1)
tgt_l = torch.from_numpy(nxt[:, lo:hi].copy())
mask_l = torch.ones(b, n)
if r == w - 1:
    mask_l[:, -1] = 0
res = {}

def model():
    return params_from_jax(tree, cfg, device="cpu", trainable=True)

def loss_fn(m, ids_, pos_, tgt_, mask_):
    return lm_loss(m(ids_, pos_), tgt_, mask_, seq_axis_name="data")

m = model()
with torch.no_grad():
    res["logits"] = m(ids_l, pos_l).numpy()
    u = params_from_jax(tree, dataclasses.replace(cfg, seq_impl="ulysses"),
                        device="cpu")
    res["logits_ulysses"] = u(ids_l, pos_l).numpy()
m.requires_grad_(True)
names = [n_ for n_, _ in m.named_parameters()]
loss = loss_fn(m, ids_l, pos_l, tgt_l, mask_l)
grads = torch.autograd.grad(loss, list(m.parameters()))
for kind, red in (("summed", Reducer(gradient_average=False)),
                  ("averaged", Reducer())):
    for name, g in zip(names, red.reduce(list(grads))):
        res[f"{kind}/{name}"] = g.numpy()
m = model()
a = amp.initialize(m, FusedAdam(m.parameters(), lr=%(lr)r, device="cpu"),
                   opt_level="O0", device="cpu")
step = amp.make_train_step(a, m, loss_fn,
                           reduce_fn=Reducer(gradient_average=False).reduce)
losses = []
reset_collective_counts()
for _ in range(%(steps)d):
    info = step(ids_l, pos_l, tgt_l, mask_l)
    losses.append(float(all_reduce(info["loss"])))
res["counts"] = np.asarray([collective_counts().get(k, 0) for k in
                            ("ring_hop", "all_reduce")])
res["losses"] = np.asarray(losses)
for name, t in a.masters.items():
    res[f"master/{name}"] = t.detach().numpy()
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def params():
    cfg = JaxGPTConfig(**TINY)
    return JaxGPTModel(cfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params):
    work = tmp_path_factory.mktemp("gpt_sp")
    np.savez(work / "params.npz", **dict(_flat(params)))
    np.save(work / "ids.npy", _ids())
    run_ranks(RANK % dict(tiny=TINY, lr=LR, steps=STEPS), WORLD, work)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_loss(model):
    def loss_fn(p, ids):
        return jax_lm_loss(model.apply({"params": p}, ids)[:, :-1],
                           ids[:, 1:])
    return loss_fn


def test_forward_matches_jax_shard_map_and_whole_sequence(ranks, params):
    ids = jnp.asarray(_ids())
    local = JaxGPTModel(JaxGPTConfig(**TINY)).apply({"params": params}, ids)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
    model_sp = JaxGPTModel(JaxGPTConfig(seq_axis_name="seq", **TINY))
    positions = jnp.broadcast_to(jnp.arange(L)[None, :], (B, L))
    sharded = jax.jit(shard_map(
        lambda v, i, p: model_sp.apply(v, i, positions=p), mesh=mesh,
        in_specs=(P(), P(None, "seq"), P(None, "seq")),
        out_specs=P(None, "seq")))({"params": params}, ids, positions)
    got = np.concatenate([rk["logits"] for rk in ranks], axis=1)
    np.testing.assert_allclose(got, np.asarray(sharded), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(local), rtol=0, atol=1e-4)
    uly = np.concatenate([rk["logits_ulysses"] for rk in ranks], axis=1)
    np.testing.assert_allclose(uly, np.asarray(local), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def jax_train(params):
    model = JaxGPTModel(JaxGPTConfig(**TINY))
    a = jamp.initialize(optimizer=JaxFusedAdam(lr=LR), opt_level="O0",
                        verbosity=0)
    state = a.init(params)
    step = jax.jit(jamp.make_train_step(a, _jax_loss(model)))
    ids = jnp.asarray(_ids())
    losses = []
    for _ in range(STEPS):
        state, m = step(state, ids)
        losses.append(float(m["loss"]))
    grads = jax.grad(_jax_loss(model))(params, ids)
    return losses, dict(_flat(state.master_params)), dict(_flat(grads))


def test_train_steps_match_jax_whole_sequence(ranks, jax_train):
    losses, masters, _ = jax_train
    for rk in ranks:
        np.testing.assert_allclose(rk["losses"], losses, rtol=0, atol=1e-5)
        for name, want in masters.items():
            np.testing.assert_allclose(rk[f"master/{name}"], want, rtol=0,
                                       atol=1e-4, err_msg=name)
    for key in ranks[0]:
        if key.startswith("master/"):
            assert np.array_equal(ranks[0][key], ranks[1][key]), key


def test_collectives_a_step(ranks):
    """Per step: 2 layers x (W - 1) hops forward and back; one
    all_reduce for the loss's token count and one a gradient bucket (the
    146 K fp32 elements of gpt_tiny: one bucket)."""
    hops, reduces = (int(c) for c in ranks[0]["counts"])
    assert hops == STEPS * TINY["num_layers"] * 2 * (WORLD - 1)
    assert reduces == STEPS * (1 + 1) + STEPS   # + the reported loss


def test_the_gradients_must_be_summed_not_averaged(ranks, jax_train):
    _, _, grads = jax_train
    for rk in ranks:
        for name, want in grads.items():
            scale = np.abs(want).max()
            summed = rk[f"summed/{name}"]
            averaged = rk[f"averaged/{name}"]
            np.testing.assert_allclose(summed, want, rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
            np.testing.assert_allclose(averaged * WORLD, want, rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
            assert np.abs(averaged - want).max() > 0.25 * scale, name
