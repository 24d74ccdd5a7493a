"""The port's cross-rank SPMD lint (``apex_tpu_torch.analysis.spmd``) and
runtime preflight (``apex_tpu_torch.parallel.multiproc.spmd_preflight``)
held against the JAX package's, as ``tests/l0/test_spmd.py`` holds
JAX's.

Each bug class JAX's tests seed is seeded in the port's dry captures
(a declared world of 8 for JAX's 8-device lowerings) and must give JAX's
finding id at JAX's op index; unseeded captures stay quiet.  Verdicts are
compared, not text: JAX's entries carry channel ids that torch has not.
The fingerprint functions must give JAX's digests on the same schedule
lists.  Then 4 gloo ranks on a 2 x 2 mesh run the preflight over the
group's store in separate rounds: a clean one, rank 3's bucket at f32,
a collective only rank 0 issues (the eager form of JAX's
conditional-collective class), and the same seeded rounds over the
store-less all-gather exchange.
"""

import hashlib
import itertools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import analysis as janalysis
from apex_tpu.analysis import spmd as jspmd
from apex_tpu.parallel.distributed import ReduceConfig as JaxReduceConfig
from apex_tpu.parallel.distributed import reduce_gradients as jax_reduce
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch import analysis
from apex_tpu_torch.analysis import spmd
from apex_tpu_torch.parallel import (ReduceConfig, ReduceOp, all_reduce,
                                     multiproc, reduce_gradients)
from apex_tpu_torch.testing import run_ranks

WORLD = 8


def _jax_psum(extra=False, n=WORLD):
    def f(x):
        g = jax.lax.psum(x, "data")
        if extra:
            g = g + jax.lax.pmax(x, "data")
        return g

    sm = shard_map(f, mesh=Mesh(np.array(jax.devices()[:n]), ("data",)),
                   in_specs=P("data"), out_specs=P())
    return janalysis.lower_quiet(jax.jit(sm),
                                 jnp.ones((n, 4), jnp.float32)).as_text()


def _port_psum(extra=False, n=WORLD):
    def f(x):
        g = all_reduce(x)
        if extra:
            g = g + all_reduce(x, op=ReduceOp.MAX)
        return g

    return analysis.capture(f, torch.ones(1, 4), world=n)


def _jax_reduce(cfg):
    sm = shard_map(lambda g: jax_reduce(g, "data", cfg),
                   mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)),
                   in_specs=P(), out_specs=P())
    return janalysis.lower_quiet(jax.jit(sm),
                                 jnp.ones((16,), jnp.bfloat16)).as_text()


def _port_reduce(cfg):
    return analysis.capture(reduce_gradients,
                            [torch.zeros(16, dtype=torch.bfloat16)],
                            config=cfg, world=WORLD)


def _verdicts(findings):
    return [(f.op, f.severity, f.count) for f in findings]


def test_schedule_entries_agree_with_jaxs_lowering():
    (mine,), (theirs,) = (spmd.collective_schedule(_port_psum()),
                          jspmd.collective_schedule(_jax_psum()))
    for k in ("kind", "variant", "replica_groups", "dtypes", "bytes",
              "region"):
        assert mine[k] == theirs[k], k


def test_seeded_schedule_mismatch_equals_jaxs():
    """One rank issues an extra ``all_reduce(MAX)``: the static
    deadlock, at JAX's op index, naming the end of the schedule."""
    mine = spmd.compare_lowerings({"rank 0": _port_psum(),
                                   "rank 7": _port_psum(extra=True)})
    theirs = jspmd.compare_lowerings({"rank 0": _jax_psum(),
                                      "rank 7": _jax_psum(extra=True)})
    assert _verdicts(mine) == _verdicts(theirs) == [
        ("spmd-schedule-mismatch", "error", 1)]
    assert "<end of schedule>" in mine[0].example
    assert "deadlock" in mine[0].message


def test_identical_captures_are_quiet():
    assert spmd.compare_lowerings({"rank 0": _port_psum(),
                                   "rank 1": _port_psum()}) == []
    assert jspmd.compare_lowerings({"rank 0": _jax_psum(),
                                    "rank 1": _jax_psum()}) == []
    assert spmd.compare_lowerings({"only": _port_psum()}) == []


def test_seeded_signsgd_bytes_mismatch_equals_jaxs():
    """The fork's signSGD hack: one rank's bucket sign-compressed on the
    fp32 wire while its peers send bf16."""
    sign = dict(allreduce_always_fp32=True, compression="sign")
    mine = spmd.diff_schedules(
        "rank 0", spmd.collective_schedule(_port_reduce(ReduceConfig())),
        "rank 7", spmd.collective_schedule(_port_reduce(ReduceConfig(
            **sign))))
    theirs = jspmd.diff_schedules(
        "rank 0", jspmd.collective_schedule(_jax_reduce(JaxReduceConfig())),
        "rank 7", jspmd.collective_schedule(_jax_reduce(JaxReduceConfig(
            **sign))))
    assert _verdicts(mine) == _verdicts(theirs) == [
        ("spmd-bytes-mismatch", "error", 0)]
    assert "signSGD" in mine[0].message
    assert "all-reduce(bf16, 32B" in mine[0].example
    assert "all-reduce(f32, 64B" in mine[0].example


def test_seeded_group_mismatch_equals_jaxs():
    """Same op sequence, other replica_groups (JAX's HLO fixture)."""
    hlo_a = ("ENTRY %main.1 (p: f32[4]) -> f32[4] {\n  %ar = f32[4]{0} "
             "all-reduce(f32[4]{0} %p), channel_id=1, replica_groups="
             "{{0,1,2,3,4,5,6,7}}, use_global_device_ids=true, "
             "to_apply=%add\n}\n")
    hlo_b = hlo_a.replace("{{0,1,2,3,4,5,6,7}}", "{{0,1,2,3},{4,5,6,7}}")
    theirs = jspmd.diff_schedules("rank 0", jspmd.collective_schedule(hlo_a),
                                  "rank 5", jspmd.collective_schedule(hlo_b))
    (e,) = _port_psum().schedule
    split = dict(e, replica_groups="{{0,1,2,3},{4,5,6,7}}")
    mine = spmd.diff_schedules("rank 0", [e], "rank 5", [split])
    assert _verdicts(mine) == _verdicts(theirs) == [
        ("spmd-group-mismatch", "error", 0)]
    assert "groups={{0,1,2,3},{4,5,6,7}}" in mine[0].example


@pytest.mark.parametrize("extra", [False, True], ids=["same", "extra"])
def test_reshape_pairs_equal_jaxs(extra):
    """World 2 -> world 1: opcode-consistent is ``info``; an extra
    collective after the reshape is the ``error``."""
    mine = spmd.reshape_pair_findings(
        "mesh2", _port_psum(n=2), "mesh1", _port_psum(extra=extra, n=1))
    theirs = jspmd.reshape_pair_findings(
        "mesh2", _jax_psum(n=2), "mesh1", _jax_psum(extra=extra, n=1))
    assert _verdicts(mine) == _verdicts(theirs)
    assert mine[0].severity == ("error" if extra else "info")
    if not extra:
        assert mine[0].message == theirs[0].message


def test_fingerprints_equal_jaxs_on_the_same_schedule_lists():
    lists = [spmd.collective_schedule(_port_psum(extra=True)),
             spmd.collective_schedule(_port_reduce(ReduceConfig())),
             jspmd.collective_schedule(_jax_psum(extra=True)),
             jspmd.collective_schedule(_jax_reduce(JaxReduceConfig())), []]
    for sched in lists:
        assert spmd.serialize_schedule(sched) == \
            jspmd.serialize_schedule(sched)
        for opcodes_only in (False, True):
            assert spmd.schedule_fingerprint(sched, opcodes_only) == \
                jspmd.schedule_fingerprint(sched, opcodes_only)
        assert spmd.format_entry(sched[0] if sched else None) == \
            jspmd.format_entry(sched[0] if sched else None)
    # the full digest sees the payload; the opcode digest does not
    a, b = (spmd.collective_schedule(_port_reduce(ReduceConfig(**kw)))
            for kw in ({}, {"allreduce_always_fp32": True}))
    assert spmd.schedule_fingerprint(a) != spmd.schedule_fingerprint(b)
    assert spmd.schedule_fingerprint(a, opcodes_only=True) == \
        spmd.schedule_fingerprint(b, opcodes_only=True)


def test_spmd_pass_reports_the_schedule_and_diffs_peers():
    rep = analysis.analyze(lambda x: all_reduce(x), torch.ones(1, 4),
                           world=WORLD, passes=("spmd-consistency",))
    assert rep.ok and rep.passes == ("spmd-consistency",)
    (info,) = [f for f in rep.findings if f.op == "schedule"]
    assert info.count == 1
    rep = analysis.analyze(
        lambda x: all_reduce(x), torch.ones(1, 4), world=WORLD,
        passes=("spmd-consistency",),
        options={"spmd-consistency": {
            "peers": {"rank 7": _port_psum(extra=True)}}})
    assert not rep.ok
    assert "spmd-schedule-mismatch" in [f.op for f in rep.findings]


def test_spmd_preflight_single_process_records_hashes():
    cap = _port_psum()
    rec = multiproc.spmd_preflight(cap, label="unit")
    assert rec["ok"] and rec["label"] == "unit" and rec["exchange"] == "none"
    assert (rec["rank"], rec["n_ranks"], rec["n_collectives"]) == (0, 1, 1)
    assert rec["schedule_hash"] == spmd.schedule_fingerprint(
        spmd.collective_schedule(cap))
    assert rec["module_hash"] == cap.module_hash
    # the zero-arg callable form (what initialize() defers) and a list
    x = torch.ones(1, 4)
    with pytest.raises(RuntimeError, match="no process group"):
        multiproc.spmd_preflight(lambda: all_reduce(x))
    rec2 = multiproc.spmd_preflight(list(cap.schedule), label="unit")
    assert rec2["schedule_hash"] == rec["schedule_hash"]
    rec3 = multiproc.spmd_preflight(lambda: x * 2)
    assert rec3["n_collectives"] == 0 and rec3["label"] == "train_step"


def test_spmd_preflight_rejects_garbage():
    with pytest.raises(TypeError, match="Capture"):
        multiproc.spmd_preflight(42)
    with pytest.raises(TypeError, match="Capture"):
        multiproc.spmd_preflight("module text")


@pytest.fixture
def rank0_of_two(monkeypatch):
    """This process as rank 0 of a 2-rank group whose store is a
    ``HashStore`` the test plays rank 1 through; rounds count from 0."""
    store = dist.HashStore()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(multiproc, "_default_store", lambda: store)
    monkeypatch.setattr(multiproc, "_PREFLIGHT_SEQ", itertools.count())
    monkeypatch.setenv("APEX_TPU_PREFLIGHT_TIMEOUT_S", "1")
    return store


def test_spmd_preflight_names_a_peer_that_never_publishes(rank0_of_two):
    t0 = time.perf_counter()
    with pytest.raises(multiproc.ClusterInitError,
                       match="never published") as info:
        multiproc.spmd_preflight(_port_psum(), label="lone")
    assert not isinstance(info.value, multiproc.SpmdPreflightError)
    assert time.perf_counter() - t0 < 30
    assert rank0_of_two.get("apex_tpu/spmd_preflight/lone/0/digest/0")


def test_spmd_preflight_names_compute_only_divergence(rank0_of_two):
    """Rank 1 issues the same collectives after other compute: the
    schedules agree and the module hashes do not (JAX's message)."""
    mine = _port_psum()
    theirs = analysis.capture(lambda x: all_reduce(x * 2), torch.ones(1, 4),
                              world=WORLD)
    sched = spmd.serialize_schedule(spmd.collective_schedule(theirs))
    shash = hashlib.sha256(sched.encode()).hexdigest()
    prefix = "apex_tpu/spmd_preflight/compute/0"
    rank0_of_two.set(f"{prefix}/digest/1", hashlib.sha256(
        (theirs.module_hash + shash).encode()).hexdigest())
    rank0_of_two.set(f"{prefix}/sched/1", sched)
    with pytest.raises(multiproc.SpmdPreflightError,
                       match=r"rank\(s\) \[1\]") as info:
        multiproc.spmd_preflight(mine, label="compute")
    msg = str(info.value)
    assert "collective schedules agree (1 op(s)) but module hashes " \
        "differ" in msg
    assert mine.module_hash[:12] in msg and "rank 1 differs" in msg


RANKS = r'''
import json, pathlib, sys
import torch
import torch.distributed as dist
from apex_tpu_torch.analysis import capture
from apex_tpu_torch.parallel import (ReduceConfig, Reducer, all_reduce,
                                     make_mesh, multiproc)
out = pathlib.Path(sys.argv[1])
grads = [torch.zeros(16, dtype=torch.bfloat16),
         torch.zeros(3, 5, dtype=torch.bfloat16)]


def step(fp32=False, extra=False):
    def run():
        Reducer(config=ReduceConfig(allreduce_always_fp32=fp32)).reduce(
            grads)
        if "model" in mesh_axes:
            all_reduce(torch.zeros(()), axis_name="model")
        if extra:
            all_reduce(torch.zeros(2))
    return run


mesh_axes = ()
res = {"init": multiproc.initialize(device="cpu", preflight=step(),
                                    preflight_label="init")}
r = dist.get_rank()
mesh_axes = make_mesh((2, 2), ("model", "data")).axis_names
clean = capture(step())
res["groups"] = [e["replica_groups"] for e in clean.schedule]


def round_(name, program):
    try:
        res[name] = multiproc.spmd_preflight(program, label=name)
    except multiproc.SpmdPreflightError as e:
        res[name] = {"error": str(e)}


round_("clean", clean)
round_("f32_bucket", step(fp32=(r == 3)))
round_("conditional", step(extra=(r == 0)))
multiproc._default_store = lambda: None
round_("clean_gather", clean)
round_("f32_bucket_gather", step(fp32=(r == 3)))
(out / f"rank{r}.json").write_text(json.dumps(res))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("spmd")
    run_ranks(RANKS, 4, work)
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(4)]


def test_four_ranks_clean_rounds_agree(ranks):
    for r, res in enumerate(ranks):
        assert res["init"]["ok"] and res["init"]["label"] == "init"
        assert (res["init"]["rank"], res["init"]["n_ranks"]) == (r, 4)
        assert res["init"]["exchange"] == "store"
        # the partition of each axis, the same on every rank
        assert res["groups"] == ["{{0,1},{2,3}}", "{{0,2},{1,3}}"]
        assert res["clean"]["ok"] and res["clean"]["exchange"] == "store"
        assert res["clean_gather"]["ok"]
        assert res["clean_gather"]["exchange"] == "all_gather"
    for name in ("init", "clean", "clean_gather"):
        assert len({res[name]["schedule_hash"] for res in ranks}) == 1
        assert len({res[name]["module_hash"] for res in ranks}) == 1
    assert ranks[0]["clean"]["n_collectives"] == 2


@pytest.mark.parametrize("name", ["f32_bucket", "f32_bucket_gather"])
def test_four_ranks_raise_on_rank_3s_f32_bucket(ranks, name):
    for r, res in enumerate(ranks):
        msg = res[name]["error"]
        assert "rank(s) [3]" in msg
        assert "op #0" in msg
        assert "all-reduce(bf16, 62B, groups={{0,1},{2,3}})" in msg
        assert "all-reduce(f32, 124B, groups={{0,1},{2,3}})" in msg
        other = 0 if r == 3 else 3
        assert f"rank {r} issues" in msg and f"rank {other} issues" in msg


def test_four_ranks_raise_on_a_collective_only_rank_0_issues(ranks):
    for r, res in enumerate(ranks):
        msg = res["conditional"]["error"]
        assert "rank(s) [1, 2, 3]" in msg
        assert "op #2" in msg and "<end of schedule>" in msg
        assert "all-reduce(f32, 8B, groups={{0,1},{2,3}})" in msg
