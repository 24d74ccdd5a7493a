"""The step classifiers over the torch profiler's trace
(``apex_tpu_torch/obs/stepclass.py``) and the trace's per-event table
(``obs/xplane.keyed_times``), held against the JAX package's
vocabularies.

A synthetic chrome trace in the card's shape (launch records on two host
threads, kernels linked by ``correlation``) pins the attribution: one
kernel name launched from the forward and from the autograd thread splits
into ``fwd`` and ``bwd``.  Real CPU captures (an amp step, solo
``generate()``) run the host fallback the CPU tests rely on.
"""

import json

import numpy as np
import pytest
import torch

from apex_tpu.analysis import decode_profile
from apex_tpu.analysis import profile_drift as jax_pd
from apex_tpu.obs import stepclass as jax_stepclass
from apex_tpu_torch import amp
from apex_tpu_torch.analysis import profile_drift as pd
from apex_tpu_torch.models import GPTModel, gpt_tiny
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.models.mlp import MLP, cross_entropy_loss
from apex_tpu_torch.obs import stepclass, xplane
from apex_tpu_torch.obs.xplane import OpKey
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils import profiling

GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
ADD = ("void at::native::elementwise_kernel<128, 4, at::native::"
       "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16>"
       " >(at::TensorIteratorBase&, ...)::{lambda(int)#1}>(int, ...)")
ROOT = stepclass.window_scope("train")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny CPU ops here run faster on one intra-op thread than on a
    pool the test workers share; the setting is restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bucket_vocabularies_equal_jaxs():
    assert stepclass.DECODE_BUCKETS == jax_stepclass.DECODE_BUCKETS
    assert stepclass.DECODE_BUCKETS == decode_profile.BUCKETS
    assert stepclass.TRAIN_BUCKETS == jax_stepclass.TRAIN_BUCKETS
    assert stepclass.DECODE_BUCKETS == pd.DECODE_BUCKETS
    assert stepclass.TRAIN_BUCKETS == pd.TRAIN_BUCKETS
    assert pd.KINDS == jax_pd.KINDS
    assert set(stepclass.DECODE_RANGES) == \
        set(stepclass.DECODE_BUCKETS) - {"host_sync", "other"}


# ---------------------------------------------------------------------------
# a synthetic trace in the card's shape
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur, tid, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _launch(ts, corr, tid):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2.0, tid,
              correlation=corr)


def _kernel(name, ts, dur, corr=None, ext=None, cat="kernel"):
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if ext is not None:
        args["External id"] = ext
    return _x(cat, name, ts, dur, tid=7, pid=0, **args)


def _card_trace():
    """One train step's trace: the forward's GEMM on the loop's thread,
    the same GEMM and an NCCL kernel from the autograd thread, the
    update's kernels, a copy, a launch after the step's range, a kernel
    found by its External id and one found by nothing."""
    main, bwd = 11, 12
    ev = [
        _x("user_annotation", ROOT, 0.0, 1000.0, main),
        _x("user_annotation", stepclass.AMP_FORWARD, 10.0, 200.0, main),
        _x("cpu_op", "aten::matmul", 18.0, 60.0, main, **{"External id": 4}),
        _x("cpu_op", "aten::mm", 20.0, 50.0, main, **{"External id": 5}),
        _launch(30.0, 100, main),
        _x("cpu_op", "aten::add", 100.0, 20.0, main),
        _launch(105.0, 107, main),
        _x("user_annotation", stepclass.AMP_BACKWARD, 250.0, 300.0, main),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           300.0, 100.0, bwd),
        _x("cpu_op", "MmBackward0", 301.0, 90.0, bwd),
        _x("cpu_op", "aten::mm", 310.0, 50.0, bwd),
        _launch(320.0, 101, bwd),
        _launch(380.0, 104, bwd),
        _x("user_annotation", stepclass.AMP_APPLY, 600.0, 100.0, main),
        _launch(610.0, 103, main),
        _x("cpu_op", "Optimizer.step#FusedAdam.step", 640.0, 50.0, main),
        _launch(650.0, 102, main),
        _launch(900.0, 106, main),
        _launch(1500.0, 105, main),        # after the step's range
        _kernel(GEMM, 40.0, 20.0, corr=100, ext=5),
        _kernel(GEMM, 330.0, 40.0, corr=101),
        _kernel("adam_tree_kernel", 660.0, 30.0, corr=102),
        _kernel("scale_kernel", 615.0, 8.0, corr=103),
        _kernel("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 390.0, 12.0,
                corr=104),
        _kernel("Memcpy DtoH (Device -> Pinned)", 905.0, 3.0, corr=106,
                cat="gpu_memcpy"),
        _kernel(GEMM, 1510.0, 20.0, corr=105),
        # an elementwise kernel's name holds "lambda": no optimizer scope
        _kernel(ADD, 110.0, 6.0, corr=107),
        # no launch record: found by the External id of the forward's op
        _kernel("ln_fwd_warp_vec", 70.0, 5.0, corr=999, ext=5),
        # neither a launch nor an op: unattributed
        _kernel("orphan_kernel", 80.0, 4.0),
        # a range over device kernels (counted once, never as time)
        _x("gpu_user_annotation", ROOT, 40.0, 700.0, tid=7, pid=0),
    ]
    return {"traceEvents": ev}


@pytest.fixture
def card_trace(tmp_path):
    path = tmp_path / "card.pt.trace.json"
    path.write_text(json.dumps(_card_trace()))
    return str(path)


def test_keyed_times_attributes_each_kernel_to_its_launch(card_trace):
    got = xplane.keyed_times(card_trace)
    plain = xplane.op_times(card_trace)
    assert got.source == plain.source == "trace-device"
    assert got.total_ps == plain.total_ps == sum(got.by_key.values())
    assert got.unattributed_ps == 4_000_000
    fwd = OpKey(ROOT, (ROOT, stepclass.AMP_FORWARD, "aten::matmul",
                       "aten::mm"), GEMM)
    bwd = OpKey(ROOT, (
        "autograd::engine::evaluate_function: MmBackward0", "MmBackward0",
        "aten::mm"), GEMM)
    assert got.by_key[fwd] == 20_000_000
    assert got.by_key[bwd] == 40_000_000
    # the External id fallback lands on the op's own stack
    assert got.by_key[OpKey(ROOT, fwd.scopes, "ln_fwd_warp_vec")] \
        == 5_000_000
    assert got.by_key[OpKey("", (), "orphan_kernel")] == 4_000_000
    # a launch after the step's range has no root
    assert got.by_key[OpKey("", (), GEMM)] == 20_000_000


def test_one_kernel_name_splits_into_fwd_and_bwd(card_trace):
    """The forward's GEMM and the autograd thread's GEMM share a name;
    the launching ranges, not the name, decide the bucket."""
    got = xplane.keyed_times(card_trace)
    clf = stepclass.TrainStepClassifier(ROOT)
    ops = clf.step_ops()
    step = {k: ps for k, ps in got.by_key.items() if k in ops}
    by_name = {}
    for k, ps in step.items():
        by_name.setdefault(k.name, {})[clf(k) or "other"] = ps
    assert by_name[GEMM] == {"fwd": 20_000_000, "bwd": 40_000_000}
    assert by_name["adam_tree_kernel"] == {"optimizer": 30_000_000}
    assert by_name["scale_kernel"] == {"optimizer": 8_000_000}
    # a collective launched inside the backward is a collective
    assert by_name["ncclDevKernel_AllReduce_Sum_bf16_RING_LL"] == \
        {"collectives": 12_000_000}
    assert by_name["ln_fwd_warp_vec"] == {"fwd": 5_000_000}
    assert by_name[ADD] == {"fwd": 6_000_000}
    assert by_name["Memcpy DtoH (Device -> Pinned)"] == {"other": 3_000_000}
    assert "orphan_kernel" not in by_name      # no root: not the step's
    table = xplane.bucket_op_times(step, clf,
                                   buckets=["fwd", "bwd", "optimizer",
                                            "collectives"])
    assert table["bucket_ps"] == {"fwd": 31_000_000, "bwd": 40_000_000,
                                  "optimizer": 38_000_000,
                                  "collectives": 12_000_000,
                                  "other": 3_000_000}
    assert "host_gap" not in {clf(k) for k in step}


def test_decode_classifier_precedence():
    r = stepclass.DECODE_RANGES
    root = stepclass.window_scope("replica0")
    clf = stepclass.ServeStepClassifier(root)
    cases = {
        # the cache's fp32 read inside the attention range is kv_read
        (r["attention"], r["kv_read"], "aten::copy_"): "kv_read",
        (r["attention"], "aten::einsum", "aten::bmm"): "attention",
        (r["kv_write"], "aten::index_put_"): "kv_write",
        (r["sampling"], "aten::sort"): "sampling",
        (r["param_read"], "aten::matmul", "aten::mm"): "param_read",
        ("serve/decode_step", "aten::add"): None,
        # the speculative draft's launches are other, whatever the range
        ("serve/spec_draft", r["param_read"], "aten::mm"): None,
    }
    for scopes, want in cases.items():
        assert clf(OpKey(root, scopes, "k")) == want, scopes
    assert clf(OpKey(root, (r["sampling"],),
                     "Memcpy HtoD (Pageable -> Device)")) == "host_sync"
    ops = clf.step_ops()
    assert OpKey(root, (), "k") in ops
    assert OpKey(stepclass.window_scope("replica1"), (), "k") not in ops
    assert "not a key" not in ops
    dec = stepclass.DecodeStepClassifier()
    assert OpKey("", ("x", stepclass.GENERATE_STEP), "k") in dec.step_ops()
    assert OpKey("", ("x",), "k") not in dec.step_ops()


def test_kernel_groups_name_the_ports_kernels():
    g = stepclass.kernel_group
    assert g("void flash_bwd_dq_sm90<64, __nv_bfloat16>(...)") == \
        "flash_attn_bwd_dq (K13)"
    assert g("flash_bwd_dkv_sm90<64>") == "flash_attn_bwd_dkv (K14)"
    assert g("flash_fwd_sm90<64, bf16>") == "flash_attn_fwd (K2)"
    assert g("adam_tree_kernel<float>") == "adam_tree (K11)"
    assert g("ncclDevKernel_AllReduce") == "NCCL collectives"
    assert g(GEMM) == "matmuls (cuBLAS)"
    assert g("elementwise_kernel<add>") == stepclass.OTHER_GROUP
    names = [n for n, _ in stepclass.PROFILE_GROUPS]
    assert len(names) == len(set(names)) == 23


def test_profile_range_exists_only_inside_a_capture():
    assert not profiling.capturing()
    ctx = profiling.profile_range("decode/kv_read")
    assert not isinstance(ctx, torch.autograd.profiler.record_function)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert profiling.capturing()
        assert isinstance(profiling.profile_range("decode/kv_read"),
                          torch.autograd.profiler.record_function)
    finally:
        prof.stop()


# ---------------------------------------------------------------------------
# host captures on the CPU
# ---------------------------------------------------------------------------

def _capture(tmp_path, fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    path = str(tmp_path / "host.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def test_an_amp_steps_host_capture_splits_fwd_bwd_and_optimizer(tmp_path):
    torch.manual_seed(0)
    model = MLP((32, 32), in_features=16, device="cpu")
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=1e-2,
                                        device="cpu"),
                       opt_level="O2", device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, x, y: cross_entropy_loss(m(x), y))
    x, y = torch.randn(16, 16), torch.randint(0, 10, (16,))
    step(x, y)

    def run():
        with torch.profiler.record_function(ROOT):
            step(x, y)

    path = _capture(tmp_path, run)
    got = xplane.keyed_times(path)
    assert got.source == "trace-host"
    assert got.total_ps == xplane.op_times(path).total_ps
    clf = stepclass.TrainStepClassifier(ROOT)
    step_keys = {k: ps for k, ps in got.by_key.items()
                 if k in clf.step_ops()}
    mm = {clf(k) for k in step_keys if k.name == "aten::mm"}
    assert {"fwd", "bwd"} <= mm
    table = xplane.bucket_op_times(step_keys, clf,
                                   buckets=["fwd", "bwd", "optimizer"])
    assert all(table["bucket_ps"][b] > 0 for b in ("fwd", "bwd",
                                                   "optimizer"))
    assert table["matched_ps"] > 0.9 * table["total_ps"]


def test_decode_classifier_over_solo_generate(tmp_path):
    cfg = gpt_tiny()
    torch.manual_seed(0)
    model = GPTModel(cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    path = _capture(tmp_path, lambda: generate(model, cfg, prompt, 4,
                                               device="cpu"))
    got = xplane.keyed_times(path)
    clf = stepclass.DecodeStepClassifier()
    step_keys = [k for k in got.by_key if k in clf.step_ops()]
    assert step_keys and len(step_keys) < len(got.by_key)  # not prefill
    buckets = {clf(k) for k in step_keys}
    assert {"param_read", "kv_write", "kv_read", "attention",
            "sampling"} <= buckets
