"""The port's lint harness (``apex_tpu_torch.analysis``: ``report``,
``core``, ``capture``, ``collectives``) held against the JAX package's
(``apex_tpu.analysis``), as ``tests/l0/test_graph_lint.py`` holds JAX's.

The port's subject is a capture of one call: a dry capture with a
declared world of 8 stands for what one rank of an 8-device
``shard_map`` lowers.  The JAX side lowers the same function on the
8-device CPU mesh.  Verdicts, kinds, dtypes and bytes are compared, not
text: JAX's entries carry channel ids and global device ids that torch
has not.  The reduction's table is held against JAX's *lowered*
schedule, the program the user asked for: XLA's CPU compiler widens a
bf16 all-reduce to f32, which no card's NCCL does.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import analysis as janalysis
from apex_tpu.analysis import core as jcore
from apex_tpu.analysis import report as jreport
from apex_tpu.analysis import spmd as jspmd
from apex_tpu.parallel.distributed import ReduceConfig as JaxReduceConfig
from apex_tpu.parallel.distributed import reduce_gradients as jax_reduce
from apex_tpu.utils.jax_compat import shard_map
from apex_tpu_torch import analysis
from apex_tpu_torch.parallel import (ReduceConfig, all_gather, all_reduce,
                                     collective_counts, reduce_gradients,
                                     reset_collective_counts)
from apex_tpu_torch.parallel import distributed as tdist
from apex_tpu_torch.parallel.p2p import shift

WORLD = 8


def _mesh(n=WORLD):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _jax_lowered(fn, x, in_specs, n=WORLD):
    sm = shard_map(fn, mesh=_mesh(n), in_specs=in_specs, out_specs=P())
    return janalysis.lower_quiet(jax.jit(sm), x)


def _kinds_table(schedule):
    """Per-kind count, bytes and dtypes of a schedule list (JAX's
    ``collective_table`` parses compiled HLO text only, so its lowered
    schedule is tallied here as the port's is)."""
    out = {}
    for e in schedule:
        slot = out.setdefault(e["kind"], {"count": 0, "bytes": 0,
                                          "dtypes": []})
        slot["count"] += 1
        slot["bytes"] += e["bytes"]
        slot["dtypes"] += e["dtypes"]
    return out


# -- report -------------------------------------------------------------------

FINDINGS = [
    dict(pass_name="collectives", severity="info",
         message="all-reduce: 1 op(s), 32 bytes (0 async / 1 sync)",
         op="all-reduce", bytes=32),
    dict(pass_name="collectives", severity="error",
         message="total collective volume 32 bytes exceeds budget 0",
         op="total", bytes=32, count=3),
    dict(pass_name="spmd-consistency", severity="warning", message="w",
         dtype="bf16", lineno=7, example="x"),
]


def test_report_wire_shape_and_format_equal_jaxs():
    mine = analysis.Report(tuple(analysis.Finding(**f) for f in FINDINGS),
                           ("collectives", "spmd-consistency"))
    theirs = jreport.Report(tuple(jreport.Finding(**f) for f in FINDINGS),
                            ("collectives", "spmd-consistency"))
    assert mine.to_dict() == theirs.to_dict()
    assert mine.format() == theirs.format()
    assert mine.format(max_findings=1) == theirs.format(max_findings=1)
    assert mine.ok is theirs.ok is False
    assert mine.merged(mine).to_dict() == theirs.merged(theirs).to_dict()
    assert analysis.SEVERITIES == jreport.SEVERITIES
    with pytest.raises(ValueError, match="severity"):
        analysis.Finding("x", "fatal", "m")


# -- core -----------------------------------------------------------------------

def test_harness_registry_matches_jaxs_contract():
    assert analysis.DEFAULT_PASSES == tuple(
        p for p in jcore.DEFAULT_PASSES if p in analysis.PASSES)
    assert "spmd-consistency" in analysis.PASSES
    assert "spmd-consistency" not in analysis.DEFAULT_PASSES
    with pytest.raises(ValueError, match="already registered"):
        analysis.register_pass("collectives", lambda ctx: [])
    cap = analysis.capture(lambda: None)
    with pytest.raises(KeyError, match="unknown lint pass"):
        analysis.run_passes(analysis.build_context(cap), passes=("donation",))
    ctx = analysis.build_context(cap)
    calls = []
    assert ctx.memo("k", lambda: calls.append(1)) is None
    assert ctx.memo("k", lambda: calls.append(1)) is None
    assert calls == [1]
    for mine, theirs in ((analysis.ArgInfo, jcore.ArgInfo),
                         (analysis.OutInfo, jcore.OutInfo)):
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(theirs)]


def test_capture_records_inputs_outputs_and_ops():
    g = {"w": torch.zeros(3, 5, dtype=torch.bfloat16), "b": torch.zeros(5)}
    cap = analysis.capture(reduce_gradients, g, world=WORLD)
    assert [(a.path, a.shape, a.dtype, a.nbytes, a.donated, a.kept)
            for a in cap.args] == [
        ("[0][0]['w']", (3, 5), "bfloat16", 30, False, True),
        ("[0][0]['b']", (5,), "float32", 20, False, True)]
    assert [(o.path, o.shape, o.dtype) for o in cap.outputs] == [
        ("['w']", (3, 5), "bfloat16"), ("['b']", (5,), "float32")]
    assert cap.dry and cap.world == WORLD
    assert all(not n.startswith("c10d.") for n, _, _ in cap.ops)
    again = analysis.capture(reduce_gradients, g, world=WORLD)
    assert again.module_hash == cap.module_hash
    other = analysis.capture(reduce_gradients, g, world=WORLD,
                             config=ReduceConfig(allreduce_always_fp32=True))
    assert other.module_hash != cap.module_hash


def test_a_dry_capture_issues_nothing_and_keeps_the_counts():
    reset_collective_counts()
    x = torch.arange(4.0)
    cap = analysis.capture(lambda: (all_reduce(x), all_gather(x)),
                           world=WORLD)
    assert collective_counts() == {}
    assert [e["kind"] for e in cap.schedule] == ["all-reduce", "all-gather"]
    assert [e["bytes"] for e in cap.schedule] == [16, 16 * WORLD]
    reduced, gathered = cap.value
    assert reduced.shape == (4,) and gathered.shape == (WORLD, 4)
    # a declared world has the one axis "data", and only dry
    with pytest.raises(ValueError, match="one axis"):
        analysis.capture(lambda: all_reduce(x, axis_name="pipe"), world=2)
    with pytest.raises(ValueError, match="dry"):
        analysis.capture(lambda: None, dry=False, world=2)
    with pytest.raises(RuntimeError, match="no process group"):
        analysis.capture(lambda: all_reduce(x))


def test_entries_carry_jaxs_identity_keys_and_hlo_dtypes():
    t = torch.zeros(2, 3, dtype=torch.bfloat16)
    cap = analysis.capture(
        lambda: shift([t, torch.zeros(4, dtype=torch.bool)],
                      tdist.process_group("data"), 1), world=WORLD)
    (e,) = cap.schedule
    assert tuple(e) == jspmd._IDENTITY_KEYS
    assert e == {"kind": "collective-permute", "variant": "async",
                 "channel_id": None,
                 "replica_groups": "{{0,1,2,3,4,5,6,7}}",
                 "use_global_device_ids": False, "dtypes": ["bf16", "pred"],
                 "bytes": 16, "region": None}


# -- collectives -----------------------------------------------------------------

@pytest.mark.parametrize("kw, jax_kw", [
    ({}, {}),
    ({"allreduce_always_fp32": True, "compression": "sign"},
     {"allreduce_always_fp32": True, "compression": "sign"}),
], ids=["bf16_wire", "fp32_sign_wire"])
def test_reduction_table_equals_jaxs(kw, jax_kw):
    """``reduce_gradients`` over one (16,) bf16 leaf: the port's dry
    capture and JAX's lowering under ``shard_map`` give the same kinds,
    bytes and dtypes; the fp32 wire doubles the bytes."""
    cap = analysis.capture(reduce_gradients,
                           [torch.zeros(16, dtype=torch.bfloat16)],
                           config=ReduceConfig(**kw), world=WORLD)
    low = _jax_lowered(lambda g: jax_reduce(g, "data",
                                            JaxReduceConfig(**jax_kw)),
                       jnp.ones((16,), jnp.bfloat16), P())
    theirs = _kinds_table(jspmd.collective_schedule(low.as_text()))
    assert _kinds_table(cap.schedule) == theirs
    table = analysis.collective_table(cap)
    want = {"count": 1, "bytes": 64 if kw else 32, "sync": 1, "async": 0,
            "channels": [], "replica_groups": ["{{0,1,2,3,4,5,6,7}}"],
            "global_ids": 0}
    assert table == {"all-reduce": want}
    assert analysis.collective_audit(cap) == {
        "all-reduce": {"count": 1, "bytes": want["bytes"]}}


@pytest.mark.parametrize("budget", [{"total": 0}, {"total": 1 << 20},
                                    {"all-reduce": 4}],
                         ids=["total_0", "total_1MiB", "all_reduce_4"])
def test_budget_verdicts_equal_jaxs(budget):
    """``psum(x.sum(0))`` of an (8, 128) f32 batch, one row a rank, as
    ``tests/l0/test_graph_lint.py`` builds it."""
    def step(x):
        return jax.lax.psum(x.sum(axis=0), "data")

    sm = jax.jit(shard_map(step, mesh=_mesh(), in_specs=(P("data"),),
                           out_specs=P()))
    theirs = janalysis.analyze(sm, jnp.ones((8, 128), jnp.float32),
                               passes=("collectives",),
                               options={"collectives": {"budget": budget}})
    mine = analysis.analyze(lambda x: all_reduce(x.sum(dim=0)),
                            torch.ones(1, 128), world=WORLD,
                            passes=("collectives",),
                            options={"collectives": {"budget": budget}})
    assert mine.ok == theirs.ok
    assert [(f.severity, f.op, f.bytes, f.count) for f in mine.findings] \
        == [(f.severity, f.op, f.bytes, f.count) for f in theirs.findings]
    assert mine.passes == theirs.passes == ("collectives",)


def test_no_collective_passes_the_single_chip_budget():
    rep = analysis.analyze(lambda x: x * 2, torch.ones(3),
                           options={"collectives": {"budget": {"total": 0}}})
    assert rep.ok and rep.findings == ()


def test_canon_groups_spellings_equal_jaxs():
    from apex_tpu.analysis.collectives import canon_groups as jcanon
    for s in ("{{0,1},{2,3}}", "[[0, 1], [2, 3]]", "[2,4]<=[8]", "{}"):
        assert analysis.collectives.canon_groups(s) == jcanon(s)


# -- the escape check -------------------------------------------------------------

@pytest.fixture
def gloo_world_one():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_raw_collective_escapes_a_real_capture(gloo_world_one):
    g = [torch.ones(4)]
    real = analysis.capture(reduce_gradients, g, dry=False)
    dry = analysis.capture(reduce_gradients, g)
    assert real.schedule == dry.schedule and len(real.schedule) == 1
    assert real.schedule[0]["replica_groups"] == "{{0}}"
    assert real.module_hash == dry.module_hash
    assert torch.equal(real.value[0], g[0])

    def raw(t):
        out = reduce_gradients([t])
        dist.all_reduce(t)
        return out

    with pytest.raises(RuntimeError, match="escaped"):
        analysis.capture(raw, torch.ones(4), dry=False)
    assert tdist._RECORDING is None
