"""The port's sequence-parallel attention (``apex_tpu_torch.attention.
ring``) across 4 gloo processes on the CPU, against the JAX package's
``ring_attention`` / ``ulysses_attention`` under ``shard_map`` on a
4-device CPU mesh, each engine against JAX's engine of the same name
(``impl="flash"``: on this mesh JAX's flash blocks run its kernel's
plain conventions, a row that sees no key giving zeros; ``impl="jnp"``:
the materializing online softmax, such a row averaging the values), and
every output against JAX's local ``attention(impl="jnp")`` on the rows
that see a key.

Cases, fp32, B 2 x L 32 (8 a rank) x H 4 x D 16: causal, non-causal, a
key mask whose batch 1 sees no key at all, and a causal key mask that
hides batch 0's first three keys (its first three rows see none).
Outputs and the gradients of q, k and v under a random cotangent within
1e-5; the hops and all-to-alls a call counted.  The ranks are spawned
once (``run_ranks``, a 120 s deadline).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from apex_tpu.attention import attention as jax_attention
from apex_tpu.attention import ring_attention as jax_ring
from apex_tpu.attention import ulysses_attention as jax_ulysses
from apex_tpu.parallel import data_parallel_mesh
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch.testing import run_ranks

WORLD = 4
B, L, H, D = 2, 32, 4, 16
TOL = 1e-5
CASES = ("causal", "full", "mask", "causal_mask")
RUNS = [(fn, impl) for fn in ("ring", "ulysses") for impl in ("flash", "jnp")]


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.standard_normal((B, L, H, D)).astype(np.float32)
                   for _ in range(4))
    masks = {"mask": rng.rand(B, L) > 0.3,
             "causal_mask": rng.rand(B, L) > 0.3}
    masks["mask"][1] = False
    masks["causal_mask"][0, :3] = False
    return q, k, v, do, masks


def _case(name):
    return dict(causal=name.startswith("causal"),
                masked=name.endswith("mask"))


RANK = r'''
import sys, pathlib
import numpy as np
import torch
import torch.distributed as dist
from apex_tpu_torch.attention import (attention, local_attention,
                                      ring_attention, ulysses_attention)
from apex_tpu_torch.parallel import (collective_counts, multiproc,
                                     reset_collective_counts)
out = pathlib.Path(sys.argv[1])
multiproc.initialize(device="cpu")
r, w = dist.get_rank(), dist.get_world_size()
B, L, H, D = %(shape)r
rng = np.random.RandomState(0)
q, k, v, do = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(4))
masks = {"mask": rng.rand(B, L) > 0.3, "causal_mask": rng.rand(B, L) > 0.3}
masks["mask"][1] = False
masks["causal_mask"][0, :3] = False
n = L // w
shard = lambda a: torch.from_numpy(a[:, r * n:(r + 1) * n].copy())
fns = {"ring": ring_attention, "ulysses": ulysses_attention}
res = {}
for case in %(cases)r:
    causal = case.startswith("causal")
    mask = shard(masks[case]) if case.endswith("mask") else None
    for fn in ("ring", "ulysses"):
        for impl in ("flash", "jnp"):
            ts = [shard(a).requires_grad_(True) for a in (q, k, v)]
            reset_collective_counts()
            o = fns[fn](*ts, "data", causal=causal, kv_mask=mask, impl=impl)
            grads = torch.autograd.grad(o, ts, shard(do))
            key = f"{case}/{fn}/{impl}"
            res[key + "/o"] = o.detach().numpy()
            for name, g in zip("qkv", grads):
                res[f"{key}/d{name}"] = g.numpy()
            for kind, c in collective_counts().items():
                res[f"{key}/count/{kind}"] = np.asarray(c)
# the dispatcher forwards every impl, and refuses local-only options
ts = [shard(a) for a in (q, k, v)]
for impl in ("ring", "ulysses", "flash", "jnp"):
    res[f"dispatch/{impl}"] = attention(*ts, axis_name="data", impl=impl,
                                        causal=True).numpy()
refused = 0
for kw in (dict(rope=(ts[0], ts[0])), dict(layout="bhld")):
    try:
        attention(*ts, axis_name="data", **kw)
    except ValueError:
        refused += 1
try:
    ulysses_attention(ts[0][:, :, :3], ts[1][:, :, :3], ts[2][:, :, :3])
except ValueError:
    refused += 1
res["refused"] = np.asarray(refused)
# a group of one rank: the identity hop, nothing sent
singles = [dist.new_group([i]) for i in range(w)]
reset_collective_counts()
for fn in (ring_attention, ulysses_attention):
    for impl in ("flash", "jnp"):
        got = fn(*ts, singles[r], causal=True, impl=impl)
        want = attention(*ts, causal=True, impl="ring" if impl == "flash"
                         else "jnp")
        res[f"single/{fn.__name__}/{impl}"] = np.asarray(
            float((got - want).abs().max()))
res["single/collectives"] = np.asarray(sum(collective_counts().values()))
np.savez(out / f"rank{r}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ring")
    run_ranks(RANK % dict(shape=(B, L, H, D), cases=CASES), WORLD, work)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


def _gather(ranks, key):
    return np.concatenate([rk[key] for rk in ranks], axis=1)


def _jax_engines(causal):
    """One jitted function: every run's sharded output and its VJP of the
    cotangent, for a key mask given as an argument (all True where a case
    has none: the same function)."""
    mesh = data_parallel_mesh(num_devices=WORLD)
    fns = {"ring": jax_ring, "ulysses": jax_ulysses}

    def run(q, k, v, do, mask):
        out = {}
        for fn, impl in RUNS:
            def sharded(q, k, v, fn=fn, impl=impl):
                return shard_map(
                    lambda q, k, v, m: fns[fn](q, k, v, "data",
                                               causal=causal, kv_mask=m,
                                               impl=impl),
                    mesh=mesh, in_specs=(P(None, "data"),) * 4,
                    out_specs=P(None, "data"), check_rep=False)(
                        q, k, v, mask)

            o, vjp = jax.vjp(sharded, q, k, v)
            out[f"{fn}/{impl}/o"] = o
            for name, g in zip("qkv", vjp(do)):
                out[f"{fn}/{impl}/d{name}"] = g
        out["local"] = jax_attention(q, k, v, axis_name=None, impl="jnp",
                                     causal=causal, kv_mask=mask)
        return out

    return jax.jit(run)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's sharded engines: outputs and gradients of every case."""
    q, k, v, do, masks = _inputs()
    engines = {c: _jax_engines(c) for c in (False, True)}
    out = {}
    for case in CASES:
        c = _case(case)
        mask = masks[case] if c["masked"] else np.ones((B, L), bool)
        got = engines[c["causal"]](*(jnp.asarray(a) for a in
                                     (q, k, v, do, mask)))
        out.update({f"{case}/{k_}": np.asarray(a) for k_, a in got.items()})
    return out


def _sees_a_key(case):
    """(B, L) bool: the query rows that see at least one key."""
    c = _case(case)
    vis = np.ones((B, L, L), bool)
    if c["masked"]:
        vis &= _inputs()[4][case][:, None, :]
    if c["causal"]:
        vis &= np.tril(np.ones((L, L), bool))[None]
    return vis.any(-1)


@pytest.mark.parametrize("run", [f"{fn}/{impl}" for fn, impl in RUNS])
@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax(ranks, jax_results, case, run):
    key = f"{case}/{run}"
    for part in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(_gather(ranks, f"{key}/{part}"),
                                   jax_results[f"{key}/{part}"],
                                   rtol=TOL, atol=TOL, err_msg=part)
    seen = _sees_a_key(case)
    np.testing.assert_allclose(_gather(ranks, f"{key}/o")[seen],
                               jax_results[f"{case}/local"][seen],
                               rtol=TOL, atol=TOL)
    if not seen.all() and run.endswith("flash"):
        assert not _gather(ranks, f"{key}/o")[~seen].any()


@pytest.mark.parametrize("case", CASES)
def test_collectives_a_call(ranks, case):
    """A ring call hops W - 1 times forward and W - 1 back (k and v in
    one hop, the mask beside them); under causality the flash engine
    still hops every block on; Ulysses makes 4 all-to-alls forward (q, k,
    v, then the output back) and 4 back, and gathers the mask once."""
    masked = _case(case)["masked"]
    for rk in ranks:
        for impl in ("flash", "jnp"):
            ring = f"{case}/ring/{impl}/count/"
            hops = 2 * (WORLD - 1) + (WORLD - 1 if masked else 0)
            assert int(rk[ring + "ring_hop"]) == hops
            assert int(rk[ring + "send_recv"]) == 4 * (WORLD - 1) + (
                WORLD - 1 if masked else 0)
            uly = f"{case}/ulysses/{impl}/count/"
            assert int(rk[uly + "all_to_all"]) == 4 + 4
            assert int(rk.get(uly + "all_gather", 0)) == int(masked)
            assert f"{case}/ring/{impl}/count/via_host" not in rk


def test_dispatcher_and_refusals(ranks, jax_results):
    want = jax_results["causal/ring/jnp/o"]
    for impl in ("ring", "ulysses", "flash", "jnp"):
        np.testing.assert_allclose(_gather(ranks, f"dispatch/{impl}"), want,
                                   rtol=TOL, atol=TOL)
    for rk in ranks:
        assert int(rk["refused"]) == 3


def test_a_group_of_one_is_the_local_call(ranks):
    """A group of one rank sends nothing and gives the local call's
    output (within 1e-6: the plain ring divides by the softmax's sum after
    the product, the local path before it)."""
    for rk in ranks:
        for fn in ("ring_attention", "ulysses_attention"):
            for impl in ("flash", "jnp"):
                assert float(rk[f"single/{fn}/{impl}"]) <= 1e-6
        assert int(rk["single/collectives"]) == 0


def test_refusals_without_a_group():
    import torch
    from apex_tpu_torch.attention import attention, ring_attention
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q, q, impl="flsah")
    with pytest.raises(ValueError, match="unknown impl"):
        ring_attention(q, q, q, impl="pallas")
    with pytest.raises(RuntimeError, match="no process group"):
        ring_attention(q, q, q)
