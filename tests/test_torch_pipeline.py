"""The port's pipeline parallelism (``apex_tpu_torch.parallel.pipeline``)
and mesh axes across 4 gloo processes on the CPU, against the JAX
package's ``pipeline_apply`` under ``shard_map`` on the conftest's
virtual CPU devices.

- ``pipeline_apply`` with JAX's test stages (``relu(x @ w + b)``, D 8,
  batch 16): 4 stages over a ``("pipe",)`` mesh of the 4 ranks and 2
  stages over each ``"pipe"`` line of a ``(2, 2)`` ``("data", "pipe")``
  mesh, at 4 and 8 microbatches: the output on every rank, the stage
  parameters' gradients of ``mean(y ** 2)`` (each rank computing that
  loss) and the input's (summed over the ranks, as JAX sums a replicated
  input's) within 1e-5; the hops a call counted; the divisibility and
  stacked-leaf errors with JAX's messages.
- gpt_tiny at O0 (FusedAdam 3e-3, 3 steps) with its 2 blocks as the 2
  stages of each ``"pipe"`` line (2 microbatches; the embedding, ``ln_f``
  and the head outside the pipeline on every rank, the embedding's
  gradient summed over the line), against JAX's unpipelined step from
  the same parameters: losses within 1e-5, each rank's block and the
  shared leaves within 1e-4 of JAX's masters.
- ``finite_axes``: an inf in one rank's gradients skips the step on
  every rank of the ``"pipe"`` group (masters kept, scale halved) and on
  that rank alone without it, also through ``apply_gradients_multi`` and
  an accumulated step; the expert-free example mode
  (``examples/pipeline_moe.py --mode pp``: 4 tanh stages of 32, batch
  32, FusedAdam 3e-3, amp O2, ``finite_axes=("pipe",)``) for 5 steps,
  losses within 2**-8 relative of JAX's ``make_train_step``.

The ranks are started once (``start_ranks``, a 120 s deadline) and run
while the JAX references compute.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jax_amp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from apex_tpu.parallel.pipeline import stack_stage_params as jax_stack
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch.testing import start_ranks

WORLD = 4
D, BATCH = 8, 16
TOL = 1e-5
GPT_STEPS, GPT_MICRO = 3, 2
GPT_KW = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128)
PP_D, PP_BATCH, PP_STEPS = 32, 32, 5
PP_REL = 2.0 ** -8


def _stages(n):
    rng = np.random.RandomState(0)
    return [{"w": rng.randn(D, D).astype(np.float32) * 0.5,
             "b": rng.randn(D).astype(np.float32) * 0.1} for _ in range(n)]


def _x():
    return np.random.RandomState(1).randn(BATCH, D).astype(np.float32)


def _gpt_ids():
    rng = np.random.RandomState(0)
    base = rng.randint(0, GPT_KW["vocab_size"], (4, 1))
    return ((base + np.arange(32)[None, :]) % GPT_KW["vocab_size"]) \
        .astype(np.int32)


def _pp_data():
    rng = np.random.RandomState(7)
    x = rng.randn(PP_BATCH, PP_D).astype(np.float32)
    target = np.tanh(x @ rng.randn(PP_D, PP_D).astype(np.float32))
    ws = [rng.randn(PP_D, PP_D).astype(np.float32) * 0.4
          for _ in range(WORLD)]
    return x, target.astype(np.float32), ws


RANK = r'''
import sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
from apex_tpu_torch import amp
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import GPTConfig, lm_loss
from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (all_reduce, batch_sharding,
                                     collective_counts, data_parallel_mesh,
                                     make_mesh, multiproc, pipeline_apply,
                                     reset_collective_counts,
                                     stack_stage_params, world_size)
from apex_tpu_torch.parallel.distributed import process_group
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r = dist.get_rank()
res = {}
D, BATCH = %(shape)r
rng = np.random.RandomState(0)
stages = [{"w": rng.randn(D, D).astype(np.float32) * 0.5,
           "b": rng.randn(D).astype(np.float32) * 0.1} for _ in range(4)]
x = np.random.RandomState(1).randn(BATCH, D).astype(np.float32)

def stage_fn(p, h):
    return torch.relu(h @ p["w"] + p["b"])

for S, shape, names in ((4, (4,), ("pipe",)), (2, (2, 2), ("data", "pipe"))):
    mesh = make_mesh(shape, names)
    s = mesh.coords["pipe"]
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                   st.items()} for st in stages[:S]])
    mine = {k: v[s:s + 1].clone().requires_grad_(True)
            for k, v in stacked.items()}
    for M in (4, 8):
        xt = torch.from_numpy(x).requires_grad_(True)
        reset_collective_counts()
        y = pipeline_apply(stage_fn, mine, xt, "pipe", n_microbatches=M)
        gw, gb, gx = torch.autograd.grad((y ** 2).mean(),
                                         [mine["w"], mine["b"], xt])
        key = f"S{S}/M{M}"
        res[key + "/y"] = y.detach().numpy()
        res[key + "/dw"], res[key + "/db"] = gw[0].numpy(), gb[0].numpy()
        res[key + "/dx"] = gx.numpy()
        res[key + "/counts"] = np.asarray(
            [collective_counts().get(k, 0) for k in
             ("pipe_hop", "send_recv", "broadcast")])
    errs = []
    for kw in (dict(n_microbatches=3), dict(stacked=True)):
        try:
            pipeline_apply(stage_fn, stacked if "stacked" in kw else mine,
                           torch.from_numpy(x), "pipe", **kw)
        except ValueError as e:
            errs.append(str(e))
    res[f"S{S}/errors"] = np.asarray(errs)

# the (2, 2) mesh's axes: "data" lines (0, 2), (1, 3); "pipe" (0, 1), (2, 3)
pg = {a: process_group(a) for a in ("data", "pipe")}
res["mesh/data"] = np.asarray([dist.get_global_rank(pg["data"], i)
                               for i in range(2)])
res["mesh/pipe"] = np.asarray([dist.get_global_rank(pg["pipe"], i)
                               for i in range(2)])
res["mesh/shape"] = np.asarray([mesh.shape["data"], mesh.shape["pipe"]])
res["mesh/shard"] = batch_sharding(mesh, "data")(
    torch.arange(8)).numpy()
res["mesh/world_size"] = np.asarray(world_size(mesh, "pipe"))
dp = data_parallel_mesh()
res["mesh/dp"] = np.asarray([dp.shape["data"],
                             process_group("data") is dist.group.WORLD])

# gpt_tiny, its 2 blocks as the stages of each "pipe" line, O0
tree = {}
for k, v in np.load(out / "gpt_tree.npz").items():
    node = tree
    *path, leaf = k.split(".")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v
cfg = GPTConfig(**%(gpt_kw)r)
full = params_from_jax(tree, cfg, device="cpu", trainable=True)


class Piped(torch.nn.Module):
    """gpt_tiny with this rank's block as its pipeline stage."""

    def __init__(self, full, s):
        super().__init__()
        self.cfg = full.cfg
        self.tok_emb, self.ln_f = full.tok_emb, full.ln_f
        self.lm_head = full.lm_head
        self.stage = full.blocks[s]

    def forward(self, ids, m):
        c = self.cfg
        b, l = ids.shape
        x = self.tok_emb(ids)
        pos = torch.arange(l)[None].expand(b // m, l)
        rope = rope_kernel_tables(*rope_tables(pos, c.head_dim,
                                               c.rope_theta),
                                  b // m, l, c.head_dim, x.dtype)
        y = pipeline_apply(lambda blk, h: blk(h, rope), self.stage, x,
                           "pipe", n_microbatches=m, stacked=False)
        return self.lm_head(self.ln_f(y))


s = mesh.coords["pipe"]
model = Piped(full, s)
a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                    device="cpu"),
                   opt_level="O0", device="cpu")
names = [n for n, _ in model.named_parameters()]
emb = names.index("tok_emb.embedding")


def reduce_fn(grads):
    # the embedding feeds stage 0 alone: its gradient lives there
    grads = list(grads)
    grads[emb] = all_reduce(grads[emb], "pipe")
    return grads


step = amp.make_train_step(
    a, model, lambda m, ids: lm_loss(m(ids, %(micro)d)[:, :-1], ids[:, 1:]),
    reduce_fn=reduce_fn)
ids = torch.from_numpy(np.load(out / "gpt_ids.npy")).long()
res["gpt/losses"] = np.asarray([float(step(ids)["loss"])
                                for _ in range(%(gpt_steps)d)])
res["gpt/stage"] = np.asarray(s)
for n, t in a.masters.items():
    res["gpt/master/" + n] = t.detach().numpy()

# finite_axes over the 4-rank "pipe" group
mesh = make_mesh((4,), ("pipe",))
for axes in (("pipe",), None):
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.ones(1, D))
    a = amp.initialize(m, FusedAdam(m.parameters(), lr=0.1, device="cpu"),
                       opt_level="O2", device="cpu")
    g = torch.ones(1, D, dtype=torch.bfloat16)
    if r == 2:
        g[0, 0] = float("inf")
    before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients([g], finite_axes=axes)
    key = "skip/" + ("pipe" if axes else "none")
    res[key + "/overflow"] = np.asarray(bool(info["overflow"]))
    res[key + "/kept"] = np.asarray(bool(
        (a.masters["w"] == 1).all()))
    res[key + "/scale"] = np.asarray([before,
                                      float(info["loss_scale"])])

# finite_axes in the multi-loss pieces and the accumulated step
m = torch.nn.Module()
m.w = torch.nn.Parameter(torch.ones(1, D))
a = amp.initialize(m, FusedAdam(m.parameters(), lr=0.1, device="cpu"),
                   opt_level="O2", num_losses=2, device="cpu")
ok = torch.ones(1, D, dtype=torch.bfloat16)
bad = ok.clone()
if r == 2:
    bad[0, 0] = float("inf")
info = a.apply_gradients_multi([[ok], [bad]], finite_axes=("pipe",))
res["skip/multi"] = np.asarray([bool(info["overflow"]),
                                bool((a.masters["w"] == 1).all())])
m = torch.nn.Module()
m.w = torch.nn.Parameter(torch.ones(1, D))
a = amp.initialize(m, FusedAdam(m.parameters(), lr=0.1, device="cpu"),
                   opt_level="O2", device="cpu")
step = amp.make_train_step(
    a, m, lambda mod, xb, p: (mod.w.float() * xb).sum() * (1 + p.sum()),
    accum_steps=2, finite_axes=("pipe",))
poison = torch.zeros(4)
if r == 2:
    poison[3] = float("inf")          # rank 2's second micro-batch
info = step(torch.ones(4, D), poison)
res["skip/accum"] = np.asarray([bool(info["overflow"]),
                                bool((a.masters["w"] == 1).all())])

# the example's pipeline mode at O2
xe, target, ws = [np.load(out / f"pp_{k}.npy") for k in ("x", "t", "w")]
m = torch.nn.Module()
m.w = torch.nn.Parameter(torch.from_numpy(ws[r:r + 1].copy()))
a = amp.initialize(m, FusedAdam(m.parameters(), lr=3e-3, device="cpu"),
                   opt_level="O2", device="cpu")
tgt = torch.from_numpy(target)


def pp_loss(mod, xb):
    y = pipeline_apply(lambda sp, h: torch.tanh(h @ sp["w"]),
                       {"w": mod.w}, xb, "pipe")
    return ((y - tgt).float() ** 2).mean()


step = amp.make_train_step(a, m, pp_loss, finite_axes=("pipe",))
res["pp/losses"] = np.asarray([float(step(torch.from_numpy(xe))["loss"])
                               for _ in range(%(pp_steps)d)])
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("pipe")


@pytest.fixture(scope="module")
def gpt_tree():
    ids = _gpt_ids()
    model = JaxGPT(JaxConfig(**GPT_KW))
    return model.init(jax.random.PRNGKey(0),
                      jnp.asarray(ids[:, :16]))["params"]


@pytest.fixture(scope="module")
def ranks(work, gpt_tree):
    np.savez(work / "gpt_tree.npz", **_flat_tree(gpt_tree))
    np.save(work / "gpt_ids.npy", _gpt_ids())
    x, t, ws = _pp_data()
    np.save(work / "pp_x.npy", x)
    np.save(work / "pp_t.npy", t)
    np.save(work / "pp_w.npy", np.stack(ws))
    wait = start_ranks(RANK % dict(shape=(D, BATCH), gpt_kw=GPT_KW,
                                   micro=GPT_MICRO, gpt_steps=GPT_STEPS,
                                   pp_steps=PP_STEPS), WORLD, work)
    return wait


@pytest.fixture(scope="module")
def results(ranks, work, jax_pipe, jax_gpt, jax_pp):
    ranks()
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


def _mesh(n, name):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _jax_stage(p, x):
    return jax.nn.relu(x @ p["w"] + p["b"])


@pytest.fixture(scope="module")
def jax_pipe(ranks):
    """JAX's pipeline forward and gradients for every (S, M) case."""
    out = {}
    x = jnp.asarray(_x())
    for S in (4, 2):
        stacked = jax_stack([jax.tree.map(jnp.asarray, st)
                             for st in _stages(S)])
        mesh = _mesh(S, "pipe")
        for M in (4, 8):
            f = shard_map(
                lambda sp, x, M=M: jax_pipeline(_jax_stage, sp, x, "pipe",
                                                n_microbatches=M),
                mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P())
            y = jax.jit(f)(stacked, x)
            g, gx = jax.jit(jax.grad(lambda sp, x: jnp.mean(f(sp, x) ** 2),
                                     argnums=(0, 1)))(stacked, x)
            key = f"S{S}/M{M}"
            out[key + "/y"] = np.asarray(y)
            out[key + "/dw"], out[key + "/db"] = (np.asarray(g["w"]),
                                                  np.asarray(g["b"]))
            out[key + "/dx"] = np.asarray(gx)
        with pytest.raises(ValueError) as e:
            jax.eval_shape(shard_map(
                lambda sp, x: jax_pipeline(_jax_stage, sp, x, "pipe",
                                           n_microbatches=3),
                mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P()),
                stacked, x)
        out[f"S{S}/div_error"] = str(e.value)
    return out


@pytest.fixture(scope="module")
def jax_gpt(ranks, gpt_tree):
    """JAX's unpipelined gpt_tiny O0 steps from the same parameters."""
    model = JaxGPT(JaxConfig(**GPT_KW))
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3),
                           opt_level="O0", verbosity=0)
    state = a.init(gpt_tree)

    def loss_fn(p, x):
        return jax_lm_loss(model.apply({"params": p}, x)[:, :-1], x[:, 1:])

    step = jax.jit(jax_amp.make_train_step(a, loss_fn))
    losses = []
    for _ in range(GPT_STEPS):
        state, m = step(state, jnp.asarray(_gpt_ids()))
        losses.append(float(m["loss"]))
    return losses, _flat_tree(jax.tree.map(np.asarray, state.master_params))


@pytest.fixture(scope="module")
def jax_pp(ranks):
    """The example's pipeline mode at O2 (``make_train_step`` with
    ``finite_axes``) on 4 virtual devices."""
    x, target, ws = _pp_data()
    mesh = _mesh(WORLD, "pipe")
    params = {"w": jnp.asarray(np.stack(ws))}
    a = jax_amp.initialize(optimizer=JaxFusedAdam(lr=3e-3), opt_level="O2",
                           verbosity=0)

    def loss_fn(p, xb):
        y = jax_pipeline(lambda sp, h: jnp.tanh(h @ sp["w"]), p, xb, "pipe")
        return jnp.mean(jnp.square((y - target).astype(jnp.float32)))

    state = a.init(params)
    train = jax_amp.make_train_step(a, loss_fn, finite_axes=("pipe",))

    def train_step(state, xb):
        new_state, metrics = train(state, xb)
        return new_state, jax.lax.pmean(metrics["loss"], "pipe")

    specs = jtu.tree_map_with_path(
        lambda path, leaf: P("pipe") if getattr(leaf, "ndim", 0) >= 1
        else P(), state)
    step = jax.jit(shard_map(train_step, mesh=mesh, in_specs=(specs, P()),
                             out_specs=(specs, P())))
    losses = []
    for _ in range(PP_STEPS):
        state, loss = step(state, jnp.asarray(x))
        losses.append(float(loss))
    return losses


CASES = [(S, M) for S in (4, 2) for M in (4, 8)]


@pytest.mark.parametrize("S,M", CASES)
def test_forward_and_gradients_match_jax(results, jax_pipe, S, M):
    key = f"S{S}/M{M}"
    for rk in results:
        np.testing.assert_allclose(rk[key + "/y"], jax_pipe[key + "/y"],
                                   rtol=TOL, atol=TOL)
    # rank r holds stage r of its "pipe" line (ranks 2, 3 the second line
    # of the (2, 2) mesh)
    for r, rk in enumerate(results):
        s = r % S
        for part in ("dw", "db"):
            np.testing.assert_allclose(rk[f"{key}/{part}"],
                                       jax_pipe[f"{key}/{part}"][s],
                                       rtol=TOL, atol=TOL, err_msg=part)
    for line in range(WORLD // S):
        dx = sum(results[line * S + s][key + "/dx"] for s in range(S))
        np.testing.assert_allclose(dx, jax_pipe[key + "/dx"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("S,M", CASES)
def test_hops_a_call(results, S, M):
    """``M + S - 2`` forward hops and as many backward ones, one tensor
    each, and the one broadcast of the result."""
    hops = M + S - 2
    for rk in results:
        assert list(rk[f"S{S}/M{M}/counts"]) == [2 * hops, 2 * hops, 1]


@pytest.mark.parametrize("S", (4, 2))
def test_errors_keep_jax_messages(results, jax_pipe, S):
    for rk in results:
        div, stacked = (str(e) for e in rk[f"S{S}/errors"])
        assert div == jax_pipe[f"S{S}/div_error"]
        assert "microbatch" in div
        assert "expected size 1" in stacked and "stacked=False" in stacked


def test_mesh_axes_resolve_to_their_groups(results):
    for r, rk in enumerate(results):
        assert list(rk["mesh/data"]) == [r % 2, r % 2 + 2]
        assert list(rk["mesh/pipe"]) == [r // 2 * 2, r // 2 * 2 + 1]
        assert list(rk["mesh/shape"]) == [2, 2]
        assert list(rk["mesh/shard"]) == ([0, 1, 2, 3] if r // 2 == 0
                                          else [4, 5, 6, 7])
        assert int(rk["mesh/world_size"]) == 2
        # a mesh over every rank on "data": the default group itself
        assert list(rk["mesh/dp"]) == [WORLD, 1]


def test_pipelined_gpt_tiny_matches_jax_unpipelined(results, jax_gpt):
    losses, masters = jax_gpt
    for rk in results:
        np.testing.assert_allclose(rk["gpt/losses"], losses, rtol=0,
                                   atol=TOL)
        s = int(rk["gpt/stage"])
        for name in [k for k in rk if k.startswith("gpt/master/")]:
            port = name[len("gpt/master/"):]
            if port.startswith("stage."):
                want = masters[f"block_{s}." + port[len("stage."):]]
            else:
                want = masters[port]
            np.testing.assert_allclose(rk[name], want, rtol=0, atol=1e-4,
                                       err_msg=port)


def test_one_ranks_inf_skips_every_rank_of_the_group(results):
    for r, rk in enumerate(results):
        assert bool(rk["skip/pipe/overflow"])
        assert bool(rk["skip/pipe/kept"])
        before, after = rk["skip/pipe/scale"]
        assert after == before / 2
        # without finite_axes only the rank that saw the inf skips
        assert bool(rk["skip/none/overflow"]) == (r == 2)
        assert bool(rk["skip/none/kept"]) == (r == 2)


def test_finite_axes_in_the_multi_loss_and_accumulated_steps(results):
    """An inf in one backward of ``apply_gradients_multi``, or in one
    micro-batch of an accumulated step, on rank 2 alone skips the step on
    every rank of the group."""
    for rk in results:
        assert list(rk["skip/multi"]) == [True, True]
        assert list(rk["skip/accum"]) == [True, True]


def test_example_pipeline_mode_o2_matches_jax(results, jax_pp):
    for rk in results:
        np.testing.assert_allclose(rk["pp/losses"], jax_pp, rtol=PP_REL)
    assert jax_pp[-1] < jax_pp[0]
