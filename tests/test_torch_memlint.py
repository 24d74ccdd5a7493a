"""The port's ``syncs``, ``memory`` and ``cost`` passes
(``apex_tpu_torch.analysis.syncs``, ``.memory``, ``.cost``) and the
capture they read, held against the JAX package's as
``tests/l0/test_memlint_passes.py`` holds JAX's.

Each pass fires on a small seeded program with JAX's finding code and
severity, beside the JAX program that seeds the same bug class, and
stays quiet on clean programs in both.  The artifact audits run on
documents the tests write; no test reads a committed benchmark file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from apex_tpu import amp as jamp
from apex_tpu import analysis as janalysis
from apex_tpu.analysis import cost as jcost
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_tpu.models.gpt import lm_loss as jax_lm_loss
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp, analysis
from apex_tpu_torch.analysis import cost
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.fp16_utils import FP16_Optimizer
from apex_tpu_torch.models import gpt_tiny, lm_loss
from apex_tpu_torch.optimizers import FusedAdam


def _codes(report, pass_name, severity=None):
    return [f.op for f in report.by_pass(pass_name)
            if severity is None or f.severity == severity]


def _verdicts(report, pass_name):
    return sorted((f.severity, f.op) for f in report.by_pass(pass_name)
                  if f.severity != "info")


# -- the capture ------------------------------------------------------------------

def test_records_keep_the_ops_and_add_results_storages_and_launches():
    """``ops`` keep their 3-tuples; ``records`` add what the passes read,
    one record an op; the kernels' launches are 0 on the CPU."""
    w = torch.ones(8, 4, requires_grad=True)

    def f(x):
        y = (x @ w).to(torch.bfloat16)
        (g,) = torch.autograd.grad(y.float().sum(), w)
        return y, g

    cap = analysis.capture(f, torch.ones(2, 8))
    assert len(cap.records) == len(cap.ops) > 0
    assert all(len(op) == 3 for op in cap.ops)
    assert [(r.name, r.in_dtypes, r.in_shapes) for r in cap.records] == \
        [tuple(op) for op in cap.ops]
    mm = [r for r in cap.records if r.name == "aten.mm.default"]
    assert len(mm) == 2            # the forward's and the backward's
    assert mm[0].out_dtypes == ("float32",) and mm[0].out_shapes == ((2, 4),)
    assert mm[0].flops == 2 * 2 * 4 * 8
    copy = next(r for r in cap.records if r.name == "aten._to_copy.default")
    assert copy.non_blocking is False and copy.out_dtypes == ("bfloat16",)
    # the product's output storage is the copy's input storage
    assert mm[0].out_storages[0] == copy.in_storages[0]
    assert cap.launches == {} and cap.device == "cpu"
    # w is a closure cell: free, read first by the forward's product
    assert [(ft.index, ft.nbytes) for ft in cap.free] == [(mm[0].index,
                                                           8 * 4 * 4)]
    # a tensor made inside the call is not
    assert analysis.capture(lambda x: x @ torch.ones(8, 4), torch.ones(
        2, 8)).free == ()


def test_free_tensors_are_closed_over_reads_only():
    big = torch.randn(64, 64)
    cap = analysis.capture(lambda x: x @ big, torch.ones(2, 64))
    ft, = cap.free
    assert (ft.shape, ft.dtype, ft.nbytes, ft.op) == (
        (64, 64), "float32", 64 * 64 * 4, "aten.mm.default")
    assert ft.splat is None        # under 1 MiB: not checked
    zeros = torch.zeros(512, 512)
    ft, = analysis.capture(lambda x: x @ zeros, torch.ones(2, 512)).free
    assert ft.splat is True and ft.nbytes == 1 << 20


# -- syncs ---------------------------------------------------------------------

def test_a_host_read_inside_the_step_is_an_error_as_jaxs_io_callback():
    def jstep(x):
        y = io_callback(lambda v: np.asarray(v),
                        jax.ShapeDtypeStruct(x.shape, x.dtype), x)
        return y * 2.0

    def tstep(x):
        y = x * 2.0
        return y * float(y.sum())      # .item() in a metrics helper

    theirs = janalysis.analyze(jstep, jnp.ones((4,)), passes=("syncs",))
    mine = analysis.analyze(tstep, torch.ones(4), passes=("syncs",))
    assert _verdicts(mine, "syncs") == _verdicts(theirs, "syncs") == \
        [("error", "host-callback")]
    err, = mine.errors
    assert err.example.startswith("tests/test_torch_memlint.py:")


def test_size_reads_and_clean_programs():
    """A mask index reads its output size on the host; an arrays-only
    program has nothing to say, in both packages."""
    rep = analysis.analyze(lambda x: x[x > 0].sum() + x.nonzero().sum(),
                           torch.ones(4), passes=("syncs",))
    assert _codes(rep, "syncs", "error") == ["host-callback"] * 2
    theirs = janalysis.analyze(lambda x: x * 2.0, jnp.ones((8,)),
                               passes=("syncs",))
    mine = analysis.analyze(lambda x: x * 2.0, torch.ones(8),
                            passes=("syncs",))
    assert mine.ok and theirs.ok and not mine.findings and \
        not theirs.findings


def test_classify_names_reads_and_uploads_by_the_subjects_device():
    """On a card subject a blocking copy to the CPU is a read and one
    from the CPU an upload; a ``non_blocking`` copy is neither; a CPU
    tensor's ``.item()`` is no read of the card."""
    from apex_tpu_torch.analysis.capture import Record
    from apex_tpu_torch.analysis.syncs import classify

    def rec(name, ins, outs, nb=None):
        return Record(0, name, ("float32",) * len(ins), ((4,),) * len(ins),
                      ins, ("float32",) * len(outs), ((4,),) * len(outs),
                      outs, (0,) * len(ins), (1,) * len(outs), nb)

    card = "cuda:0"
    assert classify(rec("aten._to_copy.default", ("cuda:0",), ("cpu",),
                        False), card) == "read"
    assert classify(rec("aten._to_copy.default", ("cpu",), ("cuda:0",),
                        False), card) == "upload"
    assert classify(rec("aten.copy_.default", ("cuda:0", "cpu"),
                        ("cuda:0",), False), card) == "upload"
    assert classify(rec("aten._to_copy.default", ("cuda:0",), ("cpu",),
                        True), card) is None
    assert classify(rec("aten._local_scalar_dense.default", ("cpu",), ()),
                    card) is None
    assert classify(rec("aten._local_scalar_dense.default", ("cuda:0",),
                        ()), card) == "read"
    assert classify(rec("aten._local_scalar_dense.default", ("cpu",), ()),
                    "cpu") == "read"


@pytest.fixture(scope="module")
def gpt_tiny_jax():
    model = JaxGPT(jax_gpt_tiny())
    ids = np.random.default_rng(0).integers(0, 128, (2, 32)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    return model, params, ids


def test_the_o2_train_step_is_free_of_syncs_in_both(gpt_tiny_jax):
    """The O2 step with FusedAdam on gpt_tiny: JAX's jitted step and the
    port's ``make_train_step`` (forward, backward, unscale, the skip flag
    and the update, on the device) read nothing on the host; and every
    tensor the port's step reads is an argument, the model's, the
    optimizer's or the amp state's."""
    jmodel, params, ids = gpt_tiny_jax
    ja = jamp.initialize(optimizer=JaxFusedAdam(lr=1e-3), opt_level="O2",
                         verbosity=0)

    def jloss(p, x):
        return jax_lm_loss(jmodel.apply({"params": p}, x)[:, :-1], x[:, 1:])

    jstep = jax.jit(jamp.make_train_step(ja, jloss))
    theirs = janalysis.analyze(jstep, ja.init(params), jnp.asarray(ids),
                               passes=("syncs",))
    model = params_from_jax(jax.tree.map(np.asarray, params), gpt_tiny(),
                            device="cpu", trainable=True)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-3,
                                        device="cpu"),
                       opt_level="O2", device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    x = torch.from_numpy(ids).long()
    step(x)                             # the first step makes the buffers
    mine = analysis.analyze(step, x, passes=("syncs", "constant-capture"),
                            options={"constant-capture": {"min_bytes": 1}})
    assert theirs.ok and not theirs.by_pass("syncs")
    assert mine.ok and not mine.findings, mine.format()


def test_fp16_optimizer_with_a_generic_optimizer_reads_one_flag():
    """``torch.optim.SGD`` cannot take a device flag, so the legacy
    optimizer reads the overflow flag on the host once a step
    (ROADMAP Queue 3 Standing); with FusedAdam nothing is read."""
    def run(kind):
        model = torch.nn.Linear(16, 4)
        inner = (torch.optim.SGD(model.parameters(), lr=0.1)
                 if kind == "sgd"
                 else FusedAdam(model.parameters(), lr=0.1, device="cpu"))
        opt = FP16_Optimizer(inner, dynamic_loss_scale=True)
        x = torch.ones(8, 16)
        return analysis.analyze(
            opt.step_with_closure, lambda: model(x).float().square().mean(),
            passes=("syncs",))
    rep = run("sgd")
    err, = rep.errors
    assert err.op == "host-callback"
    assert err.example == "apex_tpu_torch/fp16_utils/fp16_optimizer.py:170"
    assert run("fused_adam").ok


# -- memory ---------------------------------------------------------------------

def test_an_oversized_temp_fires_the_budget_as_in_jax():
    """``(x @ x.T).sum()`` over a (256, 256) batch against a 1 KiB budget:
    ``hbm-budget`` with the peak's bytes in both; a 1 GiB budget passes."""
    x = np.ones((256, 256), np.float32)
    for budget, ok in ((1024, False), (1 << 30, True)):
        opts = {"memory": {"budget_bytes": budget}}
        theirs = janalysis.analyze(lambda t: (t @ t.T).sum(),
                                   jnp.asarray(x), passes=("memory",),
                                   options=opts)
        mine = analysis.analyze(lambda t: (t @ t.T).sum(),
                                torch.from_numpy(x), passes=("memory",),
                                options=opts)
        assert mine.ok is theirs.ok is ok
        assert _verdicts(mine, "memory") == _verdicts(theirs, "memory")
        if not ok:
            assert mine.errors[0].op == "hbm-budget"
            assert mine.errors[0].bytes > budget
    with pytest.raises(ValueError, match="CUDA subject"):
        analysis.analyze(lambda t: t * 2, torch.ones(4), passes=("memory",),
                         options={"memory": {"budget_bytes": "device"}})


def test_the_peak_is_the_arguments_plus_the_live_peak():
    """Two n-byte temps alive together, then one freed before an 8-byte
    result: the live peak is 2n, the peak n + 2n."""
    n = 64 * 64 * 4

    def f(x):
        a = x * 2
        b = a + 1
        del a
        return b.sum(dtype=torch.float64)

    cap = analysis.capture(f, torch.ones(64, 64))
    mem = cap.memory
    assert (mem["argument_bytes"], mem["allocated_peak_bytes"],
            mem["peak_bytes"], mem["output_bytes"]) == (n, 2 * n, 3 * n, 8)
    assert mem["allocator_peak_bytes"] is None
    rep = analysis.run_passes(analysis.build_context(cap), ("memory",))
    peak, = [f for f in rep.findings if f.op == "peak-hbm"]
    assert peak.bytes == 3 * n


def test_large_buffer_names_the_largest():
    w = torch.ones(256, 64)
    rep = analysis.analyze(lambda a, b: a.sum() + b.sum(), torch.ones(4),
                           w, passes=("memory",))
    big = [f for f in rep.findings if f.op == "large-buffer"]
    assert big[0].bytes == 256 * 64 * 4 and "[0][1]" in big[0].message
    assert [f.bytes for f in big] == sorted((f.bytes for f in big),
                                            reverse=True)


def test_module_state_counts_as_an_argument_not_as_free():
    lin = torch.nn.Linear(256, 256)
    cap = analysis.capture(lin, torch.ones(2, 256))
    assert cap.free == ()
    assert cap.memory["argument_bytes"] == (256 * 256 + 256 + 2 * 256) * 4
    roles = {r[0] for r in cap.memory["largest"]}
    assert roles == {"argument", "state", "output"}


# -- cost -----------------------------------------------------------------------

def test_a_product_counts_2mnk_flops_as_jaxs_cost_model():
    m, k, n = 64, 128, 256
    compiled = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((m, k)), jnp.ones((k, n))).compile()
    theirs = jcost.cost_table(compiled)
    rep = analysis.analyze(lambda a, b: a @ b, torch.ones(m, k),
                           torch.ones(k, n), passes=("cost",),
                           options={"cost": {"peak_flops": 989e12,
                                             "peak_hbm_bytes_per_s":
                                             3.35e12}})
    flops, = [f for f in rep.findings if f.op == "flops"]
    assert f"{2 * m * n * k:.4g}" in flops.message
    assert theirs["flops"] == 2 * m * n * k
    nbytes, = [f for f in rep.findings if f.op == "hbm-bytes"]
    assert nbytes.bytes == (m * k + k * n + m * n) * 4
    assert {f.op for f in rep.findings} == {"flops", "hbm-bytes", None,
                                            "roofline"}


@pytest.mark.parametrize("flops, nbytes", [(1e6, 1e6), (1e9, 1.0),
                                           (3.2e12, 0.0)])
def test_roofline_expectation_equals_jaxs(flops, nbytes):
    args = (flops, nbytes, 100e12, 1e12)
    assert cost.roofline_expectation(*args) == \
        jcost.roofline_expectation(*args)


def _findings(out):
    return [(f.severity, f.op, f.message) for f in out]


KERNEL_DOCS = [
    ({"hbm_gbps_peak": 819.0,
      "kernels": {"k": {"gbps": 400.0, "roofline_frac": 0.49}}},
     {"k": 1.2}),
    ({"hbm_gbps_peak": 819.0,
      "kernels": {"k": {"gbps": 400.0, "roofline_frac": 0.49}}},
     {"k": 0.5}),
    ({"hbm_gbps_peak": 819.0,
      "kernels": {"k": {"gbps": 900.0, "roofline_frac": 1.1}}}, None),
]


@pytest.mark.parametrize("case", range(len(KERNEL_DOCS)))
def test_kernel_artifact_audit_equals_jaxs(case):
    doc, floors = KERNEL_DOCS[case]
    assert _findings(cost.audit_kernel_artifact(doc, "KB.json", floors)) \
        == _findings(jcost.audit_kernel_artifact(doc, "KB.json", floors))


def test_bench_artifact_audit_equals_jaxs():
    doc = {"parsed": {"configs": {
        "good": {"mfu": 0.5, "hfu": 0.55},
        "bad_mfu": {"mfu": 1.3, "hfu": 1.3},
        "bad_hfu": {"mfu": 0.5, "hfu": 0.3},
        "zero_hfu": {"mfu": 0.5, "hfu": 0.0}}}}
    mine = cost.audit_bench_artifact(doc, "B.json", {"good": 0.45,
                                                     "c": 2.0})
    assert _findings(mine) == _findings(jcost.audit_bench_artifact(
        doc, "B.json", {"good": 0.45, "c": 2.0}))
    assert len(mine) == 4


def test_floor_artifacts_over_a_directory_equal_jaxs(tmp_path):
    (tmp_path / "KERNELBENCH_r03.json").write_text(json.dumps(
        {"hbm_gbps_peak": 819.0,
         "kernels": {"k": {"gbps": 1000.0, "roofline_frac": 1.2}}}))
    (tmp_path / "KERNELBENCH_r02.json").write_text(json.dumps(
        {"hbm_gbps_peak": 819.0,
         "kernels": {"k": {"gbps": 100.0, "roofline_frac": 0.1}}}))
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"configs": {"c": {"mfu": 0.4, "hfu": 0.5}}}))
    for d, kw in ((tmp_path, {}), (tmp_path / "nowhere", {}),
                  (tmp_path / "nowhere", {"kernel_floors": {"k": 1.5},
                                          "mfu_floors": {"c": 2.0}})):
        mine = cost.audit_floor_artifacts(str(d), **kw)
        assert _findings(mine) == _findings(
            jcost.audit_floor_artifacts(str(d), **kw))
    (tmp_path / "KERNELBENCH_r09.json").write_text("{truncated")
    (tmp_path / "BENCH_r09.json").write_text("not json")
    mine = cost.audit_floor_artifacts(str(tmp_path))
    assert _findings(mine) == _findings(
        jcost.audit_floor_artifacts(str(tmp_path)))
    assert [f.severity for f in mine].count("warning") == 1


# -- the harness -----------------------------------------------------------------

def test_one_context_serves_a_mixed_pass_list():
    """JAX's ``test_mixed_pass_list_shares_one_context``: one capture
    feeds the lowering-side passes and the measuring ones alike."""
    def fwd(w, x):
        h = torch.matmul(x, w).to(torch.bfloat16)
        return torch.softmax(h, dim=-1).float().sum()

    ctx = analysis.build_context(analysis.capture(fwd, torch.ones(8, 8),
                                                  torch.ones(4, 8)))
    rep = analysis.run_passes(ctx, passes=("constant-capture", "memory",
                                           "cost", "policy", "syncs"))
    assert any(f.pass_name == "policy" and f.severity == "error"
               for f in rep.findings)
    assert any(f.op == "peak-hbm" for f in rep.by_pass("memory"))
    assert any(f.op == "flops" for f in rep.by_pass("cost"))
    assert cost.cost_table(ctx) is cost.cost_table(ctx)
    assert ctx.capture.device == "cpu"
