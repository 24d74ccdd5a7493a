#!/usr/bin/env python3
"""Drive the apex_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device   the card's name and count, and ``nvidia-smi``'s name and power
            limit (also printed alone on a line);
2. build    ``nvcc`` builds every kernel from ``apex_tpu_torch/csrc`` for
            sm_90a: seconds, and registers / shared memory / spills per
            kernel from ``-Xptxas -v``;
3. kernels  each kernel against its plain PyTorch version at the serving
            path's shapes: max abs error within the stated tolerance,
            kernel / plain / library-call times (CUDA events) and the
            bound (bytes over 3.35 TB/s or operations over the peak rate,
            whichever is larger);
4. serve    gpt_small at full width (bf16 weights from a seed, through
            ``params_from_jax``): 16 greedy requests drained by
            ``ServeEngine.run()``; tokens/s, decode-step p50/p99, and the
            layer-norm kernel's launches (>= 25 per decode step);
5. solo     4 of those requests through ``generate()``: the flash kernel
            launches once per layer per call; token agreement with the
            engine under the near-tie rule;
6. reference  fp32 on a small input: the card's kernels against the plain
            versions on the CPU, tokens and logits;
7. train kernels  the training slice's kernels (layer-norm backward, flash
            backward with in-kernel rope, the flash forward with rope, Adam,
            the amp unscale) against their plain versions at the train
            step's shapes, with the same timings and bounds, and the two
            backward kernels run twice for equal bits;
8. train    gpt_small at full width and depth, amp O2 + FusedAdam
            (lr 3e-4), B 8 x L 2048 on the synthetic stream of
            ``examples/gpt_lm.py``, 10 steps from seeded weights: per-step
            loss (finite, falling), step ms p50 over steps 3-10, tokens/s,
            peak memory, launches per step of every kernel (the layer-norm
            backward launches twice a call: dx, then the dw/db sum); then
            one step with an injected non-finite gradient, which must be
            skipped on the card (masters and moments unchanged, scale
            halved);
9. train reference  a 2-layer, 2 x 64-head model, 3 steps on the card
            against the same on the CPU (plain versions): fp32 O0, and bf16
            O3 (no master weights: Adam steps the bf16 parameters);
10. bert kernels  the BERT slice's kernels against their plain versions:
            LAMB stage 1 and 2 and the global sum of squares over
            bert_large's 303 fp32 master leaves with bf16 copies (bitwise
            repeats, the noop flag), and the layer-norm and flash kernels
            at bert_large's shapes (16384 x 1024; (32, 512, 16, 64),
            non-causal, a key mask), with the same timings and bounds;
11. bert_train  bert_large at full width and depth, amp O2 + FusedLAMB
            (lr 1e-3, eps 1e-6, weight decay 0.01, max_grad_norm 1.0),
            B 32 x L 512 on the synthetic masked-LM batch of
            ``examples/bert_pretraining.py``, 10 steps from seeded weights:
            losses (finite, falling), step ms p50 over steps 3-10,
            sequences/s, tokens/s, peak memory, the exact launches per
            step, one profiled step, and one injected overflow skipped on
            the card;
12. bert_train reference  a 2-layer, 2 x 64-head BERT with a ragged key
            mask, 3 FusedLAMB steps on the card against the CPU: fp32 O0
            and bf16 O2.

Then one JSON line of per-kernel numbers (``{"kernels": [...]}``), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before the last line; with no card it exits 1 at
once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # dense tensor cores
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
NEAR_TIE_FP32 = 1e-3         # top-2 logit margin of a recorded near tie
NEAR_TIE_BF16 = 0.125        # bf16 logits: a few ulps at |logit| ~ 4


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, budget_s: float = 0.05) -> float:
    """Mean milliseconds per call over a run of calls timed with CUDA
    events, after a warm-up; the count is chosen to fill ~budget_s."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    n = int(min(max(budget_s / one, 3), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# -- phases ---------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", kind=name, count=count, nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
    print(line, flush=True)
    return name, count, line


def phase_build():
    from apex_tpu_torch.ops.cuda import build
    lib = build.library(rebuild=True)
    info = build.build_info()
    require(info.compiled, "the kernels were not built from source")
    kernels = {}
    for mangled, lines in info.ptxas.items():
        short = mangled.split("_cu_")[-1][8:] if "_cu_" in mangled \
            else mangled
        kernels[short] = "; ".join(
            l for l in lines if not l.startswith("Compile time"))
    emit("build", nvcc_seconds=round(info.seconds, 3), library=info.path,
         ptxas=kernels, flash_bf16_dynamic_smem_bytes={
             d: lib.apex_flash_attn_smem_bytes(d) for d in (64, 128)})


def _ln_case(n1, dtype, rng, n2=768):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import layer_norm_fwd, layer_norm_fwd_ref
    from apex_tpu_torch.testing import BF16_CANCEL_ATOL, bf16_ulp_distance
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((n1, n2), np.float32) * 2 + 0.3,
                        device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal(n2, np.float32),
                        device=dev).to(dtype)
    b = torch.as_tensor(rng.standard_normal(n2, np.float32),
                        device=dev).to(dtype)
    y, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    y_ref, mean_ref, inv_ref = layer_norm_fwd_ref(x, w, b, 1e-5)
    err = float((y.float() - y_ref.float()).abs().max())
    stat_err = max(float((mean - mean_ref).abs().max()),
                   float(((inv - inv_ref) / inv_ref).abs().max()))
    require(stat_err <= 1e-5, f"layer_norm_fwd stats off by {stat_err}")
    if dtype == torch.float32:
        tol = "atol=rtol=1e-5"
        require(torch.allclose(y, y_ref, atol=1e-5, rtol=1e-5),
                f"layer_norm_fwd fp32 n1={n1}: max err {err}")
        ulps = None
    else:
        tol = "<= 1 bf16 ulp, or 2**-16 abs where the sum cancels"
        ulps = bf16_ulp_distance(y, y_ref, BF16_CANCEL_ATOL)
        require(ulps <= 1, f"layer_norm_fwd bf16 n1={n1}: {ulps} ulps")
    ms = time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5))
    plain = time_ms(lambda: layer_norm_fwd_ref(x, w, b, 1e-5))
    lib = time_ms(lambda: F.layer_norm(x, (n2,), w, b, 1e-5))
    isz = x.element_size()
    nbytes = 2 * n1 * n2 * isz + 2 * n2 * w.element_size() + 8 * n1
    b_ms, b_by = bound(nbytes, 8.0 * n1 * n2, PEAK_FP32_FLOPS)
    rec = dict(kernel="layer_norm_fwd", n1=n1, n2=n2,
               dtype=str(dtype).split(".")[-1], max_abs_err=err, ulps=ulps,
               tolerance=tol, ms=ms, plain_ms=plain, library_ms=lib,
               bound_ms=b_ms, bound_by=b_by)
    emit("kernels", **rec)
    return rec


def _flash_case(shape, rng, masked=False, causal=True):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import flash_attn_fwd, flash_attn_fwd_ref
    bsz, l, h, d = shape
    dev = torch.device("cuda")
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(torch.bfloat16)
               for _ in range(3))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.random((bsz, l)) > 0.25, device=dev)
        mask[:, 0] = True
    o, lse = flash_attn_fwd(q, k, v, causal=causal, kv_mask=mask,
                            return_lse=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                        causal=causal, kv_mask=mask)
    err = float((o.float() - o_ref).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    require(err <= 2e-2 and lse_err <= 2e-2,
            f"flash_attn_fwd {shape} masked={masked}: o err {err}, "
            f"lse err {lse_err}")
    ms = time_ms(lambda: flash_attn_fwd(q, k, v, causal=causal,
                                        kv_mask=mask))
    plain = time_ms(lambda: flash_attn_fwd_ref(q, k, v, causal=causal,
                                               kv_mask=mask))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if masked:
        am = mask[:, None, None, :]
        if causal:
            am = am & torch.ones(l, l, dtype=torch.bool, device=dev).tril()
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am))
    else:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
    pairs = _flash_pairs(bsz, l, h, causal, mask)
    nbytes = 4 * bsz * l * h * d * 2 + (bsz * l if masked else 0)
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_FLOPS)
    rec = dict(kernel="flash_attn_fwd", shape=list(shape), causal=causal,
               kv_mask=masked, dtype="bfloat16", max_abs_err=err,
               lse_err=lse_err, tolerance="atol 2e-2 vs plain in fp32",
               ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
               bound_by=b_by)
    emit("kernels", **rec)
    return rec


def phase_kernels(solo_lengths):
    import torch
    rng = np.random.default_rng(0)
    ln = [_ln_case(n1, dt, rng) for dt in (torch.bfloat16, torch.float32)
          for n1 in (1, 8, 16, 64, 2048, 8192)]
    shapes = [(1, 512, 12, 64), (4, 1024, 12, 64), (1, 2048, 12, 64),
              (2, 1000, 6, 128)] + [(1, l, 12, 64) for l in solo_lengths]
    fl = [_flash_case(s, rng) for s in shapes]
    fl.append(_flash_case((2, 512, 12, 64), rng, masked=True))
    return ln, fl


def gpt_small_tree(cfg, seed: int):
    """A JAX-layout parameter tree of numpy fp32 arrays, initialised as
    the flax model initialises (kernels N(0, 1/fan_in), embedding
    N(0, 1/hidden), biases 0, layer-norm scales 1)."""
    rng = np.random.default_rng(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def dense(i, o, bias=True):
        d = {"kernel": rng.standard_normal((i, o), np.float32) * i ** -0.5}
        if bias:
            d["bias"] = np.zeros(o, np.float32)
        return d

    def ln():
        return {"scale": np.ones(e, np.float32),
                "bias": np.zeros(e, np.float32)}
    tree = {"tok_emb": {"embedding": rng.standard_normal(
        (v, e), np.float32) * e ** -0.5}}
    for i in range(cfg.num_layers):
        tree[f"block_{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attention": {"qkv": dense(e, 3 * e), "out": dense(e, e)},
            "ffn_in": dense(e, f), "ffn_out": dense(f, e)}
    tree["ln_f"] = ln()
    tree["lm_head"] = dense(e, v, bias=False)
    return tree


def margins_of(model, seq, lp):
    """Top-2 logit gap at each generated step of ``seq`` (full forward)."""
    import torch
    with torch.inference_mode():
        logits = model(torch.as_tensor(seq[None], device=model.device))
    top2 = logits[0, lp - 1:len(seq) - 1].float().topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def first_divergence(a, b):
    for t, (x, y) in enumerate(zip(a, b)):
        if int(x) != int(y):
            return t
    return None


def phase_serve(model, cfg, requests):
    import torch
    from apex_tpu_torch.obs import Registry
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    scfg = ServeConfig(num_slots=8, block_size=16, max_blocks_per_slot=64,
                       num_blocks=8 * 64 + 1, prefill_chunk=64)
    reg = Registry()
    eng = ServeEngine(model, cfg, scfg, registry=reg)
    for uid, prompt, n in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    chunks = int(reg.counter("serve_prefill_chunks_total").value)
    per_pass = 2 * cfg.num_layers + 1
    require(len(out) == len(requests), "not every request finished")
    for uid, prompt, n in requests:
        toks = out[uid]
        require(toks.shape == (n,) and toks.min() >= 0
                and toks.max() < cfg.vocab_size,
                f"{uid}: bad output {toks.shape}")
    require(counts["layer_norm_fwd"] >= per_pass * eng.steps,
            f"layer_norm_fwd launched {counts['layer_norm_fwd']} times in "
            f"{eng.steps} decode steps")
    require(counts["layer_norm_fwd"] == per_pass * (eng.steps + chunks),
            "layer_norm_fwd launches != (2 x layers + 1) x (decode steps "
            "+ prefill chunks)")
    h = reg.histogram("serve_decode_step_seconds")
    generated = int(reg.counter("serve_tokens_total").value)
    emit("serve", model="gpt_small", dtype="bfloat16", requests=len(out),
         generated_tokens=generated, wall_s=wall,
         tokens_per_s=generated / wall, decode_steps=eng.steps,
         prefill_chunks=chunks,
         decode_step_p50_ms=h.quantile(0.5) * 1e3,
         decode_step_p99_ms=h.quantile(0.99) * 1e3,
         launches=counts,
         layer_norm_launches_per_decode_step=per_pass,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out, counts


def phase_solo(model, cfg, requests, engine_out):
    import torch
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    total = {"layer_norm_fwd": 0, "flash_attn_fwd": 0}
    agree, compared, rows = 0, 0, []
    for uid, prompt, n in requests:
        reset_launch_counts()
        seq = generate(model, cfg, prompt[None], n)[0].cpu().numpy()
        torch.cuda.synchronize()
        counts = launch_counts()
        require(counts["flash_attn_fwd"] == cfg.num_layers,
                f"{uid}: flash_attn_fwd launched "
                f"{counts['flash_attn_fwd']} times, want {cfg.num_layers}")
        for k in total:
            total[k] += counts[k]
        solo, eng = seq[len(prompt):], engine_out[uid]
        t = first_divergence(solo, eng)
        margin = None
        if t is not None:
            margin = float(margins_of(model, seq, len(prompt))[t])
            require(margin <= NEAR_TIE_BF16,
                    f"{uid}: engine and solo differ at step {t} with "
                    f"top-2 margin {margin} > {NEAR_TIE_BF16}")
        same = n if t is None else t
        agree += same
        compared += n
        rows.append(dict(uid=uid, prompt_len=len(prompt), new=n,
                         equal_prefix=same, near_tie_margin=margin))
    emit("solo", calls=len(requests), launches=total,
         flash_launches_per_call=cfg.num_layers,
         tokens_equal_before_first_near_tie=agree, tokens_compared=compared,
         near_tie_rule=f"divergence only at top-2 margin <= "
                       f"{NEAR_TIE_BF16} (bf16 logits)", requests=rows)
    return total


def phase_reference(tree, cfg):
    """fp32, small input: the card (kernels) against the CPU (the plain
    versions) — greedy tokens under the 1e-3 near-tie rule, and the
    full-sequence logits."""
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.serve import Request, ServeConfig, ServeEngine
    from apex_tpu_torch.obs import Registry
    gpu = params_from_jax(tree, cfg)
    cpu = params_from_jax(tree, cfg, device="cpu")
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 48)
    n = 16
    ref = generate(cpu, cfg, prompt[None], n, device="cpu")[0].numpy()
    got = generate(gpu, cfg, prompt[None], n)[0].cpu().numpy()
    eng = ServeEngine(gpu, cfg, ServeConfig(num_slots=2, block_size=16,
                                            num_blocks=9,
                                            max_blocks_per_slot=4,
                                            prefill_chunk=32),
                      registry=Registry())
    eng.submit(Request(uid="ref", prompt=prompt, max_new_tokens=n))
    served = eng.run()["ref"]
    margins = margins_of(cpu, ref, len(prompt))
    for name, toks in (("solo", got[len(prompt):]), ("engine", served)):
        t = first_divergence(toks, ref[len(prompt):])
        require(t is None or margins[t] <= NEAR_TIE_FP32,
                f"fp32 {name} on the card differs from the CPU at step "
                f"{t} (margin {None if t is None else margins[t]})")
    with torch.inference_mode():
        lg = gpu(torch.as_tensor(ref[None], device="cuda")).cpu()
        lc = cpu(torch.as_tensor(ref[None]))
    err = float((lg - lc).abs().max())
    require(err <= 2e-3, f"fp32 logits card vs CPU differ by {err}")
    emit("reference", dtype="float32", prompt_len=len(prompt), new=n,
         solo_equal=bool((got == ref).all()),
         engine_equal=bool((served == ref[len(prompt):]).all()),
         logits_max_abs_err=err, logits_tolerance=2e-3)


# -- the training slice ---------------------------------------------------

#: bf16 results against their plain version in the same dtype: within 2
#: bf16 ulps of the largest element (both sides compute in fp32 and round
#: to bf16 at the end, but sum in another order)
def bf16_tol(ref) -> float:
    return 2 * 2.0 ** -8 * max(1.0, float(ref.float().abs().max()))


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _kernel_rec(**rec):
    emit("kernels", **rec)
    return rec


def _tables(b, l, d, dtype):
    import torch
    from apex_tpu_torch.ops.rope import rope_kernel_tables, rope_tables
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    cos, sin = rope_tables(pos, d, 10000.0)
    return tuple(rope_kernel_tables(cos, sin, b, l, d, dtype))


def _ln_bwd_case(n1, n2, dtype, rng):
    import torch
    from apex_tpu_torch.ops.cuda import (layer_norm_bwd, layer_norm_bwd_ref,
                                         layer_norm_fwd)
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((n1, n2), np.float32) * 2 + 0.3,
                        device=dev).to(dtype)
    dy = torch.as_tensor(rng.standard_normal((n1, n2), np.float32),
                         device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal(n2, np.float32),
                        device=dev).to(dtype)
    b = torch.zeros_like(w)
    _, mean, inv = layer_norm_fwd(x, w, b, 1e-5)
    got = layer_norm_bwd(dy, x, w, mean, inv)
    again = layer_norm_bwd(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"layer_norm_bwd {n1}x{n2} {dtype}: two runs differ")
    ref = layer_norm_bwd_ref(dy, x, w, mean, inv)
    errs = [_max_err(a, r) for a, r in zip(got, ref)]
    if dtype == torch.float32:
        tol = "dx atol 1e-5; dw, db rtol 1e-5 + atol 1e-4 (row sums)"
        ok = errs[0] <= 1e-5 and all(
            torch.allclose(a, r, rtol=1e-5, atol=1e-4)
            for a, r in zip(got[1:], ref[1:]))
    else:
        tol = "2 bf16 ulps of the largest element"
        ok = all(e <= bf16_tol(r) for e, r in zip(errs, ref))
    require(ok, f"layer_norm_bwd {n1}x{n2} {dtype}: errors {errs}")
    ms = time_ms(lambda: layer_norm_bwd(dy, x, w, mean, inv))
    plain = time_ms(lambda: layer_norm_bwd_ref(dy, x, w, mean, inv))
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n2], w, b, 1e-5)
    lib = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [n2], lmean, lrstd, w, b, [True, True, True]))
    isz, wsz = x.element_size(), w.element_size()
    nbytes = 3 * n1 * n2 * isz + 8 * n1 + 3 * n2 * wsz
    b_ms, b_by = bound(nbytes, 14.0 * n1 * n2, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="layer_norm_bwd", n1=n1, n2=n2,
                       dtype=str(dtype).split(".")[-1], max_abs_err=max(
                           errs), errs_dx_dw_db=errs, tolerance=tol,
                       bitwise_repeat=True, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _flash_pairs(b, l, h, causal, mask):
    if mask is not None:
        import torch
        vis = mask[:, None, :].expand(b, l, l)
        if causal:
            vis = vis & torch.ones(l, l, dtype=torch.bool,
                                   device=mask.device).tril()
        return float(vis.sum()) * h
    return b * h * (l * (l + 1) / 2 if causal else l * l)


def _flash_bwd_case(shape, rng, causal=True, masked=False, rope=True):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import (flash_attn_bwd, flash_attn_bwd_ref,
                                         flash_attn_fwd)
    bsz, l, h, d = shape
    dev = torch.device("cuda")
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device=dev).to(torch.bfloat16)
                   for _ in range(4))
    mask = None
    if masked:
        mask = torch.as_tensor(rng.random((bsz, l)) > 0.25, device=dev)
        mask[:, 0] = True
    tables = _tables(bsz, l, d, torch.bfloat16) if rope else None
    kw = dict(causal=causal, kv_mask=mask, rope=tables)
    o, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
    got = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attn_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    require(same, f"flash_attn_bwd {shape}: two runs differ")
    ref = flash_attn_bwd_ref(q, k, v, o, lse, do, **kw)
    errs = [_max_err(a, r) for a, r in zip(got, ref)]
    require(all(e <= bf16_tol(r) for e, r in zip(errs, ref)),
            f"flash_attn_bwd {shape} masked={masked}: errors {errs}")
    ms = time_ms(lambda: flash_attn_bwd(q, k, v, o, lse, do, **kw))
    plain = time_ms(lambda: flash_attn_bwd_ref(q, k, v, o, lse, do, **kw),
                    budget_s=0.2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if masked:
        am = torch.ones(l, l, dtype=torch.bool, device=dev).tril() \
            if causal else torch.ones(l, l, dtype=torch.bool, device=dev)
        am = am[None, None] & mask[:, None, None, :]
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    else:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                              retain_graph=True))
    pairs = _flash_pairs(bsz, l, h, causal, mask)
    nbytes = (8 * bsz * l * h * d * 2 + 4 * bsz * l * h
              + (2 * bsz * l * d * 2 if rope else 0)
              + (bsz * l if masked else 0))
    b_ms, b_by = bound(nbytes, 10.0 * d * pairs, PEAK_BF16_FLOPS)
    return _kernel_rec(kernel="flash_attn_bwd", shape=list(shape),
                       causal=causal, kv_mask=masked, rope=rope,
                       dtype="bfloat16", max_abs_err=max(errs),
                       errs_dq_dk_dv=errs,
                       tolerance="2 bf16 ulps of the largest gradient vs "
                                 "the plain version in bf16",
                       bitwise_repeat=same, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _flash_rope_case(shape, rng):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import flash_attn_fwd, flash_attn_fwd_ref
    bsz, l, h, d = shape
    dev = torch.device("cuda")
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(torch.bfloat16)
               for _ in range(3))
    tables = _tables(bsz, l, d, torch.bfloat16)
    o, lse = flash_attn_fwd(q, k, v, causal=True, return_lse=True,
                            rope=tables)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attn_fwd_ref(q, k, v, causal=True, rope=tables)
    err = _max_err(o, o_ref)
    lse_err = _max_err(lse, lse_ref)
    require(err <= 2e-2 and lse_err <= 2e-2,
            f"flash_attn_fwd rope {shape}: o err {err}, lse err {lse_err}")
    ms = time_ms(lambda: flash_attn_fwd(q, k, v, causal=True, rope=tables))
    plain = time_ms(lambda: flash_attn_fwd_ref(q, k, v, causal=True,
                                               rope=tables), budget_s=0.2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = bsz * h * l * (l + 1) / 2
    nbytes = 4 * bsz * l * h * d * 2 + 2 * bsz * l * d * 2
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_FLOPS)
    return _kernel_rec(kernel="flash_attn_fwd", shape=list(shape),
                       causal=True, rope=True, dtype="bfloat16",
                       max_abs_err=err, lse_err=lse_err,
                       tolerance="atol 2e-2 vs plain in bf16 (same rounded "
                                 "q, k, tables)",
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by)


def _leaf_shapes(cfg):
    """The parameter shapes of ``cfg``'s model (GPT or BERT), in order."""
    from apex_tpu_torch.models import BertConfig, BertForPreTraining, \
        GPTModel
    cls = BertForPreTraining if isinstance(cfg, BertConfig) else GPTModel
    return [tuple(p.shape) for p in cls(cfg, device="meta").parameters()]


def _adam_case(cfg, rng):
    import torch
    from apex_tpu_torch.ops.cuda import packed_adam, packed_adam_ref
    dev = torch.device("cuda")
    shapes = _leaf_shapes(cfg)
    n = sum(int(np.prod(s)) for s in shapes)

    def leaves(scale, absval=False):
        out = []
        for s in shapes:
            a = rng.standard_normal(s, np.float32) * scale
            out.append(torch.as_tensor(np.abs(a) if absval else a,
                                       device=dev))
        return out
    p, m, v, g = leaves(0.05), leaves(1e-3), leaves(1e-4, True), leaves(1e-2)
    copies = [torch.empty_like(t, dtype=torch.bfloat16) for t in p]
    sizes = torch.full((len(shapes),), 3e-4, device=dev)
    scale = torch.ones(1, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    twins = [[t.clone() for t in ts] for ts in (p, m, v, copies)]

    def run(fn, ps, ms_, vs, cs):
        for i in range(len(shapes)):
            fn(ps[i], ms_[i], vs[i], g[i], sizes[i:i + 1], scale, flag,
               p_copy=cs[i], **kw)
    run(packed_adam, p, m, v, copies)
    run(packed_adam_ref, *twins)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for xs, ys in zip((p, m, v, copies), twins)
                for a, b in zip(xs, ys))
    err = max(_max_err(a, b) for a, b in zip(p, twins[0]))
    require(equal, f"packed_adam differs from its plain version ({err})")
    flag.fill_(1)
    before = [t.clone() for t in p[:4]]
    run(packed_adam, p, m, v, copies)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(p, before)),
            "packed_adam wrote with the noop flag set")
    flag.zero_()
    ms = time_ms(lambda: run(packed_adam, p, m, v, copies))
    plain = time_ms(lambda: run(packed_adam_ref, p, m, v, copies))
    lp = [t.clone().requires_grad_() for t in p]
    for t, gg in zip(lp, g):
        t.grad = gg
    opt = torch.optim.Adam(lp, lr=3e-4, fused=True)
    lib = time_ms(opt.step)
    b_ms, b_by = bound(30.0 * n, 15.0 * n, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="packed_adam", leaves=len(shapes), elements=n,
                       p_copy="bfloat16", max_abs_err=err,
                       tolerance="bitwise equal to the plain version",
                       noop_flag_skips=True, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                       per="one optimizer step over every leaf")


def _scale_case(shapes, rng):
    """K6 over one bf16 gradient per shape of ``shapes`` (a model's
    leaves) against its plain version: bitwise, with and without one inf
    leaf; timings."""
    import torch
    from apex_tpu_torch.ops.cuda import packed_scale, packed_scale_ref
    dev = torch.device("cuda")
    n = sum(int(np.prod(s)) for s in shapes)
    grads = [torch.as_tensor(rng.standard_normal(s, np.float32) * 1e3,
                             device=dev).to(torch.bfloat16) for s in shapes]
    inv = torch.full((1,), 2.0 ** -16, device=dev)
    results = {}
    for bad in (False, True):
        if bad:
            grads[5].view(-1)[17] = float("inf")
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        flag_ref = torch.zeros_like(flag)
        outs = [packed_scale(g, inv, torch.float32, flag) for g in grads]
        refs = [packed_scale_ref(g, inv, torch.float32, flag_ref)
                for g in grads]
        torch.cuda.synchronize()
        require(int(flag) == int(flag_ref) == int(bad),
                f"packed_scale flag {int(flag)} (plain {int(flag_ref)}), "
                f"want {int(bad)}")
        require(all(torch.equal(a, b) for a, b in zip(outs, refs)),
                "packed_scale differs from its plain version")
        results[bad] = int(flag)
    grads[5].view(-1)[17] = 1.0
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: [packed_scale(g, inv, torch.float32, flag)
                          for g in grads])
    plain = time_ms(lambda: [packed_scale_ref(g, inv, torch.float32, flag)
                             for g in grads])
    # PyTorch's own unscale takes no bf16 gradients (it unscales float
    # tensors in place): no call computes this function on these inputs,
    # so library_ms is null and the fp32 in-place call is timed beside it
    found = torch.zeros(1, device=dev)
    one = torch.ones(1, device=dev)
    grads32 = [g.float() for g in grads]
    lib32 = time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
        grads32, found, one))
    del grads32
    b_ms, b_by = bound(6.0 * n, 2.0 * n, PEAK_FP32_FLOPS)
    return _kernel_rec(kernel="packed_scale", leaves=len(shapes), elements=n,
                       shape=f"{len(shapes)} leaves, {n} elements",
                       dtype="bfloat16 -> float32", max_abs_err=0.0,
                       tolerance="bitwise equal to the plain version; flag "
                                 "raised by the one inf leaf",
                       flag_clean=results[False], flag_with_inf=results[True],
                       ms=ms, plain_ms=plain, library_ms=None,
                       library_null_reason="no PyTorch call unscales bf16 "
                                           "gradients into fp32",
                       library_fp32_in_place_ms=lib32, bound_ms=b_ms,
                       bound_by=b_by, per="one unscale over every leaf")


def phase_train_kernels(cfg):
    import torch
    rng = np.random.default_rng(2)
    recs = {}
    recs["layer_norm_bwd"] = [_ln_bwd_case(16384, 768, dt, rng)
                              for dt in (torch.bfloat16, torch.float32)]
    recs["flash_attn_bwd"] = [
        _flash_bwd_case((8, 2048, 12, 64), rng),
        _flash_bwd_case((2, 1000, 6, 128), rng),
        _flash_bwd_case((2, 512, 12, 64), rng, masked=True, rope=False)]
    recs["flash_attn_fwd_rope"] = [_flash_rope_case((8, 2048, 12, 64), rng)]
    recs["packed_adam"] = [_adam_case(cfg, rng)]
    recs["packed_scale"] = [_scale_case(_leaf_shapes(cfg), rng)]
    torch.cuda.empty_cache()
    return recs


TRAIN_STEPS = 10
TRAIN_B, TRAIN_L = 8, 2048


def train_stream(vocab, b, l):
    """``examples/gpt_lm.py``'s synthetic stream: each row counts up by
    one from a random start (next token = token + 1)."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (b, 1))
    return (base + np.arange(l)[None, :]) % vocab


def _gpt_loss(model, ids):
    from apex_tpu_torch.models import lm_loss
    return lm_loss(model(ids)[:, :-1], ids[:, 1:])


#: kernel-name fragments of the step's device time, by group
PROFILE_GROUPS = (("flash_attn_bwd (K4)", ("flash_bwd",)),
                  ("flash_attn_fwd (K2)", ("flash_fwd",)),
                  ("layer_norm_bwd (K3)", ("ln_bwd",)),
                  ("layer_norm_fwd (K1)", ("ln_fwd",)),
                  ("packed_adam (K5)", ("adam_kernel",)),
                  ("packed_scale (K6)", ("scale_kernel",)),
                  ("lamb_stage1 (K7)", ("lamb_stage1",)),
                  ("lamb_stage2 (K8)", ("lamb_stage2",)),
                  ("packed_sumsq (K9)", ("sumsq_kernel",)),
                  ("matmuls (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                        "sm90_", "nvjet")))


def profile_step(step, *batch):
    """One train step under ``torch.profiler``: the device time of every
    kernel, summed by group (the port's kernels, cuBLAS matmuls, the rest
    of PyTorch's kernels), against the step's wall time; kernels on one
    stream do not overlap, so their sum over the wall time is the
    device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        # device events only, without the ranges that annotate a span of
        # them (the optimizer's ``Optimizer.step#...``): those would count
        # the same kernels twice
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA") \
                and not getattr(ev, "is_user_annotation", False):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    if busy == 0.0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other PyTorch kernels"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        g = next((g for g, frags in PROFILE_GROUPS
                  if any(f in low for f in frags)), "other PyTorch kernels")
        groups[g] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "device_busy_share": busy / wall_ms, "by_group_ms": groups,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_train(cfg, tree):
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    model = params_from_jax(tree, cfg, trainable=True)
    opt = FusedAdam(model.parameters(), lr=3e-4)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _gpt_loss)
    ids = torch.as_tensor(train_stream(cfg.vocab_size, TRAIN_B, TRAIN_L),
                          device="cuda")
    n_leaves = len(a.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, scales, overflows, times = [], [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = {"layer_norm_fwd": 2 * cfg.num_layers + 1,
            "flash_attn_fwd": cfg.num_layers,
            # two launches a call: dx with partials, then the dw/db sum
            "layer_norm_bwd": 2 * (2 * cfg.num_layers + 1),
            "flash_attn_bwd": cfg.num_layers,
            "packed_adam": n_leaves, "packed_scale": n_leaves,
            "lamb_stage1": 0, "lamb_stage2": 0, "packed_sumsq": 0}
    require(per_step == want, f"train launches per step {per_step}, want "
                              f"{want}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(not any(overflows), f"overflow in the train steps: {overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    tokens = TRAIN_B * TRAIN_L
    profile = profile_step(step, ids)
    # one step with a non-finite gradient: skipped on the card
    with torch.enable_grad():
        loss = a.run(_gpt_loss, model, ids)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[3].view(-1)[0] = float("inf")
    masters = {n: t.clone() for n, t in a.masters.items()}
    st = opt.state[a.masters["lm_head.kernel"]]
    moments = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
               int(st["step"]))
    compute = a.params[0].detach().clone()
    scale_before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the injected inf was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(all(torch.equal(masters[n], t) for n, t in a.masters.items()),
            "masters changed on a skipped step")
    require(torch.equal(st["exp_avg"], moments[0])
            and torch.equal(st["exp_avg_sq"], moments[1])
            and int(st["step"]) == moments[2],
            "moments or step counts changed on a skipped step")
    require(torch.equal(a.params[0], compute),
            "compute params changed on a skipped step")
    emit("train", model="gpt_small", opt_level="O2", optimizer="FusedAdam",
         lr=3e-4, batch=TRAIN_B, seq_len=TRAIN_L, steps=TRAIN_STEPS,
         losses=losses, loss_scales=scales, step_ms=[t * 1e3 for t in times],
         step_ms_p50_steps_3_to_10=p50, tokens_per_s=tokens / (p50 / 1e3),
         peak_memory_gb=peak, launches=counts, launches_per_step=per_step,
         leaves=n_leaves, profile=profile, injected_overflow={
             "skipped": True, "loss_scale": [scale_before,
                                             float(info["loss_scale"])]})
    del a, opt, model, grads, masters
    torch.cuda.empty_cache()
    return counts


def phase_train_reference():
    """A 2-layer 2 x 64-head model, 3 steps, the card (kernels) against the
    CPU (plain versions) from the same weights: fp32 O0, then bf16 O3 (no
    master weights, so K5 steps the bf16 parameters with bf16
    gradients)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import params_from_jax, params_to_numpy
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256)
    tree = gpt_small_tree(cfg, seed=3)
    ids = train_stream(cfg.vocab_size, 4, 128)

    def leaves(t, pre=()):
        for k, v in t.items():
            yield from (leaves(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), v)])

    out = {}
    for level in ("O0", "O3"):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = params_from_jax(tree, cfg, device=dev, trainable=True)
            a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                                device=dev),
                               opt_level=level, device=dev)
            step = amp.make_train_step(a, model, _gpt_loss)
            x = torch.as_tensor(ids, device=dev)
            losses = [float(step(x)["loss"]) for _ in range(3)]
            masters = {k: np.asarray(v, np.float32) for k, v in
                       leaves(params_to_numpy(a.masters))}
            runs[dev] = (losses, masters,
                         {str(t.dtype) for t in a.masters.values()})
        (lg, pg, dg), (lc, pc, _) = runs["cuda"], runs["cpu"]
        loss_err = max(abs(x - y) for x, y in zip(lg, lc))
        param_err = max(float(np.abs(v - pc[k]).max()) for k, v in pg.items())
        require(all(np.isfinite(lg)) and lg[-1] < lg[0],
                f"{level} train losses on the card: {lg}")
        out[level] = dict(losses_card=lg, losses_cpu=lc,
                          loss_max_abs_err=loss_err,
                          param_max_abs_err=param_err,
                          master_dtypes=sorted(dg))
    o0, o3 = out["O0"], out["O3"]
    require(o0["loss_max_abs_err"] <= 1e-4,
            f"fp32 train losses card vs CPU differ by "
            f"{o0['loss_max_abs_err']}")
    require(o0["param_max_abs_err"] <= TRAIN_REF_PARAM_TOL,
            f"fp32 train params card vs CPU differ by "
            f"{o0['param_max_abs_err']}")
    require(o3["master_dtypes"] == ["torch.bfloat16"],
            f"O3 stepped {o3['master_dtypes']}, not the bf16 parameters")
    require(o3["loss_max_abs_err"] <= TRAIN_REF_O3_LOSS_TOL,
            f"O3 train losses card vs CPU differ by "
            f"{o3['loss_max_abs_err']}")
    emit("train_reference", steps=3,
         O0=dict(o0, dtype="float32", loss_tolerance=1e-4,
                 param_tolerance=TRAIN_REF_PARAM_TOL),
         O3=dict(o3, dtype="bfloat16",
                 loss_tolerance=TRAIN_REF_O3_LOSS_TOL))


#: fp32 masters after 3 Adam steps at lr 3e-3, card vs CPU: cuBLAS and
#: the CPU sum matmuls in other orders, and Adam's m / sqrt(v) turns
#: last-bit gradient differences into parameter differences of a small
#: fraction of lr
TRAIN_REF_PARAM_TOL = 1e-4
#: bf16 O3 losses, card vs CPU: the two round bf16 activations and
#: gradients at other places (the bound of the CPU O2 test against JAX);
#: the bf16 parameters themselves are reported, not gated: a gradient
#: near zero whose sign differs moves an element by up to 2 x lr a step
TRAIN_REF_O3_LOSS_TOL = 2e-2


# -- the BERT slice -------------------------------------------------------

BERT_STEPS = 10
BERT_B, BERT_L = 32, 512
#: fp32 masters after 3 LAMB steps at lr 1e-3, card vs CPU (the CPU
#: test against JAX measures 1.2e-6 after 5 steps at this lr)
BERT_REF_PARAM_TOL = 1e-5
#: bf16 O2 losses, card vs CPU: other roundings in cuBLAS and on the CPU
BERT_REF_O2_LOSS_TOL = 2e-2


def bert_tree(cfg, seed: int):
    """A JAX-layout ``BertForPreTraining`` parameter tree of numpy fp32
    arrays, initialised as :func:`gpt_small_tree` does (kernels
    N(0, 1/fan_in), embeddings N(0, 1/hidden), biases 0, layer-norm
    scales 1)."""
    rng = np.random.default_rng(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def dense(i, o):
        return {"kernel": rng.standard_normal((i, o), np.float32) * i ** -0.5,
                "bias": np.zeros(o, np.float32)}

    def emb(n):
        return {"embedding": rng.standard_normal((n, e), np.float32)
                * e ** -0.5}

    def ln():
        return {"scale": np.ones(e, np.float32),
                "bias": np.zeros(e, np.float32)}
    bert = {"tok_emb": emb(v), "pos_emb": emb(cfg.max_position_embeddings),
            "seg_emb": emb(cfg.type_vocab_size), "emb_ln": ln()}
    for i in range(cfg.num_layers):
        bert[f"layer_{i}"] = {
            "attention": {"qkv": dense(e, 3 * e), "out": dense(e, e)},
            "attention_ln": ln(), "ffn_in": dense(e, f),
            "ffn_out": dense(f, e), "ffn_ln": ln()}
    return {"bert": bert, "mlm_transform": dense(e, e), "mlm_ln": ln(),
            "mlm_decoder": dense(e, v), "pooler": dense(e, e),
            "nsp": dense(e, 2)}


def mlm_batch(vocab, b, l, seed, ragged=False):
    """``examples/bert_pretraining.py``'s synthetic masked-LM batch, drawn
    with numpy: ``(input ids with 15% of positions set to 103, attention
    mask, labels = the original ids, mlm_mask, nsp labels)``.  The mask
    is all ones, or with ``ragged`` row i keeps its first ``l - 9 i``
    positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, l))
    pos = rng.random((b, l)) < 0.15
    attn = np.ones((b, l), np.int32)
    if ragged:
        attn = (np.arange(l)[None] < (l - 9 * np.arange(b))[:, None]) \
            .astype(np.int32)
    return (np.where(pos, 103, ids), attn, ids, pos.astype(np.float32),
            rng.integers(0, 2, b))


def _bert_loss(model, ids, attn, labels, mlm_mask, nsp):
    from apex_tpu_torch.models import pretraining_loss
    mlm, nspl = model(ids, None, attn)
    return pretraining_loss(mlm, nspl, labels, nsp, mlm_mask)


def _bert_batch(arrays, dev):
    import torch
    ids, attn, labels, mlm_mask, nsp = arrays
    return [torch.as_tensor(ids, device=dev), torch.as_tensor(attn,
                                                              device=dev),
            torch.as_tensor(labels, device=dev),
            torch.as_tensor(mlm_mask, device=dev),
            torch.as_tensor(nsp, device=dev)]


def _lamb_case(cfg):
    """K7, K8 and K9 over bert_large's fp32 master leaves (with bf16
    copies) against their plain versions: bitwise where the arithmetic is
    the same, the sums within rtol; repeats; the noop flag; timings."""
    import torch
    from apex_tpu_torch.ops.cuda import (lamb_stage1, lamb_stage1_ref,
                                         lamb_stage2, lamb_stage2_ref,
                                         packed_sumsq, packed_sumsq_ref)
    from apex_tpu_torch.ops.multi_tensor import ChunkTable
    from apex_tpu_torch.optimizers.fused_lamb import bias_corrections
    dev = torch.device("cuda")
    shapes = _leaf_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)

    def leaves(scale):
        return [torch.randn(s, generator=gen, device=dev) * scale
                for s in shapes]
    p, g, m = leaves(0.05), leaves(1e-2), leaves(1e-3)
    v = [t.abs() for t in leaves(1e-5)]
    copies = [torch.empty_like(t, dtype=torch.bfloat16) for t in p]
    table = ChunkTable.of(p)
    _, u = table.flat_views(shapes)
    n = sum(t.numel() for t in p)
    bc1, bc2 = bias_corrections(0.9, 0.999, torch.full(
        (len(shapes),), 3, dtype=torch.int32, device=dev))
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              max_grad_norm=1.0)
    recs = {}
    # K9
    s = packed_sumsq(table, g)
    s_again = packed_sumsq(table, g)
    s_ref = packed_sumsq_ref(table, g)
    torch.cuda.synchronize()
    require(torch.equal(s, s_again), "packed_sumsq: two runs differ")
    s_err = float((s - s_ref).abs()) / float(s_ref)
    require(s_err <= 1e-5, f"packed_sumsq off by {s_err} (relative)")
    # K7: twice from the same state for equal bits, and the plain version
    m0, v0 = [t.clone() for t in m], [t.clone() for t in v]
    parts = lamb_stage1(table, p, g, m, v, u, bc1, bc2, s, None, **kw)
    m1, v1 = [t.clone() for t in m0], [t.clone() for t in v0]
    _, u1 = table.flat_views(shapes)
    parts1 = lamb_stage1(table, p, g, m1, v1, u1, bc1, bc2, s, None, **kw)
    torch.cuda.synchronize()
    same1 = all(torch.equal(a, b) for xs, ys in
                zip((m, v, u) + parts, (m1, v1, u1) + parts1)
                for a, b in zip(xs, ys))
    require(same1, "lamb_stage1: two runs differ")
    del m1, v1, u1
    _, u_ref = table.flat_views(shapes)
    parts_ref = lamb_stage1_ref(table, p, g, m0, v0, u_ref, bc1, bc2, s,
                                None, **kw)
    torch.cuda.synchronize()
    equal1 = all(torch.equal(a, b) for xs, ys in
                 zip((m, v, u), (m0, v0, u_ref)) for a, b in zip(xs, ys))
    require(equal1, "lamb_stage1: m, v or u differ from the plain version")
    part_err = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                   for a, b in zip(parts, parts_ref))
    require(part_err <= 1e-5, f"lamb_stage1 partials off by {part_err}")
    del m0, v0, u_ref
    # K8: twice from the same p for equal bits, and the plain version
    p0 = [t.clone() for t in p]
    lamb_stage2(table, p, u, *parts, None, lr=1e-3, p_copy=copies)
    p1 = [t.clone() for t in p0]
    c1 = [torch.empty_like(t) for t in copies]
    lamb_stage2(table, p1, u, *parts, None, lr=1e-3, p_copy=c1)
    torch.cuda.synchronize()
    same2 = all(torch.equal(a, b) for xs, ys in ((p, p1), (copies, c1))
                for a, b in zip(xs, ys))
    require(same2, "lamb_stage2: two runs differ")
    del p1, c1
    lamb_stage2_ref(table, p0, u, *parts, None, lr=1e-3)
    torch.cuda.synchronize()
    p_err = max(_max_err(a, b) for a, b in zip(p, p0))
    require(all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
                for a, b in zip(p, p0)),
            f"lamb_stage2 differs from its plain version by {p_err}")
    require(all(torch.equal(c, t.to(torch.bfloat16))
                for c, t in zip(copies, p)), "lamb_stage2: bad bf16 copy")
    del p0
    # the noop flag: neither stage writes
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    kept = [[t.clone() for t in ts[:12]] for ts in (p, m, v, u, copies)]
    parts_n = lamb_stage1(table, p, g, m, v, u, bc1, bc2, s, flag, **kw)
    lamb_stage2(table, p, u, *parts_n, flag, lr=1e-3, p_copy=copies)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for xs, ys in zip((p, m, v, u, copies),
                                                    kept)
                for a, b in zip(xs, ys)), "a LAMB stage wrote under noop")
    del kept
    flag.zero_()
    # timings (every call of a stage updates its state in place)
    ms9 = time_ms(lambda: packed_sumsq(table, g))
    plain9 = time_ms(lambda: packed_sumsq_ref(table, g), budget_s=0.2)
    lib9 = time_ms(lambda: torch._foreach_norm(g))
    ms7 = time_ms(lambda: lamb_stage1(table, p, g, m, v, u, bc1, bc2, s,
                                      flag, **kw))
    plain7 = time_ms(lambda: lamb_stage1_ref(table, p, g, m, v, u, bc1,
                                             bc2, s, flag, **kw),
                     budget_s=0.5)
    ms8 = time_ms(lambda: lamb_stage2(table, p, u, *parts, flag, lr=1e-3,
                                      p_copy=copies))
    plain8 = time_ms(lambda: lamb_stage2_ref(table, p, u, *parts, flag,
                                             lr=1e-3, p_copy=copies),
                     budget_s=0.5)
    common = dict(shape=f"{len(shapes)} leaves, {n} elements",
                  leaves=len(shapes), elements=n, chunks=table.n_chunks,
                  chunk_size=table.chunk_size, bitwise_repeat=True)
    no_lib = ("no single PyTorch call computes a LAMB stage (torch.optim "
              "has no LAMB)")
    b9 = bound(4.0 * n, 2.0 * n, PEAK_FP32_FLOPS)
    recs["packed_sumsq"] = _kernel_rec(
        kernel="packed_sumsq", dtype="float32", max_abs_err=float(
            (s - s_ref).abs()), rel_err=s_err,
        tolerance="rtol 1e-5 vs the plain sum (another order)", ms=ms9,
        plain_ms=plain9, library_ms=lib9,
        library_call="torch._foreach_norm (per-leaf norms)",
        bound_ms=b9[0], bound_by=b9[1], **common)
    b7 = bound(28.0 * n, 20.0 * n, PEAK_FP32_FLOPS)
    recs["lamb_stage1"] = _kernel_rec(
        kernel="lamb_stage1", dtype="float32 p, g, m, v, u",
        max_abs_err=0.0, partials_rel_err=part_err,
        tolerance="m, v, u bitwise equal to the plain version; norm "
                  "partials rtol 1e-5", noop_flag_skips=True, ms=ms7,
        plain_ms=plain7, library_ms=None, library_null_reason=no_lib,
        bound_ms=b7[0], bound_by=b7[1], **common)
    b8 = bound(14.0 * n, 3.0 * n, PEAK_FP32_FLOPS)
    recs["lamb_stage2"] = _kernel_rec(
        kernel="lamb_stage2", dtype="float32 p, u; bfloat16 copy",
        max_abs_err=p_err,
        tolerance="p rtol 1e-6 + atol 1e-7 vs the plain version (per-leaf "
                  "norm sums in another order); copy = bf16(p)",
        noop_flag_skips=True, ms=ms8, plain_ms=plain8, library_ms=None,
        library_null_reason=no_lib, bound_ms=b8[0], bound_by=b8[1],
        **common)
    del p, g, m, v, u, copies, parts
    torch.cuda.empty_cache()
    return recs


def phase_bert_kernels(cfg):
    import torch
    rng = np.random.default_rng(3)
    recs = _lamb_case(cfg)
    # K6 on bert_large's 303 leaves (the NSP bias and kernel and the
    # 30522-row embedding among them), as the bert_train path runs it
    recs["packed_scale"] = _scale_case(_leaf_shapes(cfg), rng)
    n1 = BERT_B * BERT_L
    recs["layer_norm_fwd"] = _ln_case(n1, torch.bfloat16, rng,
                                      n2=cfg.hidden_size)
    recs["layer_norm_bwd"] = _ln_bwd_case(n1, cfg.hidden_size,
                                          torch.bfloat16, rng)
    shape = (BERT_B, BERT_L, cfg.num_heads, cfg.head_dim)
    recs["flash_attn_fwd"] = _flash_case(shape, rng, masked=True,
                                         causal=False)
    recs["flash_attn_bwd"] = _flash_bwd_case(shape, rng, causal=False,
                                             masked=True, rope=False)
    torch.cuda.empty_cache()
    return recs


def phase_bert_train(cfg):
    """bert_large at full width and depth, amp O2 + FusedLAMB (the
    example's defaults), B 32 x L 512 on one synthetic masked-LM batch."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import bert_params_from_jax
    from apex_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedLAMB
    t0 = time.perf_counter()
    model = bert_params_from_jax(bert_tree(cfg, seed=5), cfg,
                                 trainable=True)
    setup_s = time.perf_counter() - t0
    opt = FusedLAMB(model.parameters(), lr=1e-3)
    a = amp.initialize(model, opt, opt_level="O2")
    step = amp.make_train_step(a, model, _bert_loss)
    batch = _bert_batch(mlm_batch(cfg.vocab_size, BERT_B, BERT_L, seed=8),
                        "cuda")
    n_leaves = len(a.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, scales, overflows, times = [], [], [], []
    for i in range(BERT_STEPS):
        t0 = time.perf_counter()
        out = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
        scales.append(float(out["loss_scale"]))
        overflows.append(bool(out["overflow"]))
        if i == 0:
            rows_first = (opt.table.lookups, opt.table.uploads)
    counts = launch_counts()
    # the chunk table's pointer rows: amp's gradient buffers keep their
    # storage, so every row is uploaded in the first step and none after
    rows = dict(lookups_step_1=rows_first[0], uploads_step_1=rows_first[1],
                lookups_later=opt.table.lookups - rows_first[0],
                uploads_later=opt.table.uploads - rows_first[1])
    require(rows["uploads_later"] == 0,
            f"pointer rows uploaded after the first step: {rows}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: c / BERT_STEPS for k, c in counts.items()}
    lnc = 2 * cfg.num_layers + 2
    want = {"layer_norm_fwd": lnc, "flash_attn_fwd": cfg.num_layers,
            # two launches a call: dx with partials, then the dw/db sum
            "layer_norm_bwd": 2 * lnc, "flash_attn_bwd": cfg.num_layers,
            "packed_adam": 0, "packed_scale": n_leaves, "lamb_stage1": 1,
            "lamb_stage2": 1, "packed_sumsq": 1}
    require(per_step == want, f"bert launches per step {per_step}, want "
                              f"{want}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(not any(overflows), f"overflow in the bert steps: {overflows}")
    p50 = float(np.median(times[2:])) * 1e3
    profile = profile_step(step, *batch)
    # one step with a non-finite gradient: skipped on the card
    with torch.enable_grad():
        loss = a.run(_bert_loss, model, *batch)
        grads = list(torch.autograd.grad(a.scale_loss(loss), a.params))
    grads[11].view(-1)[5] = float("inf")
    masters = {n: t.clone() for n, t in a.masters.items()}
    moments = [(opt.state[t]["exp_avg"].clone(),
                opt.state[t]["exp_avg_sq"].clone())
               for t in a.masters.values()]
    steps = opt.param_groups[0]["leaf_steps"].clone()
    compute = a.params[0].detach().clone()
    scale_before = float(a.scaler_state.loss_scale)
    info = a.apply_gradients(grads)
    torch.cuda.synchronize()
    require(bool(info["overflow"]), "the injected inf was not seen")
    require(float(info["loss_scale"]) == scale_before / 2,
            "the scale did not halve on overflow")
    require(all(torch.equal(masters[n], t) for n, t in a.masters.items()),
            "masters changed on a skipped step")
    require(all(torch.equal(opt.state[t]["exp_avg"], m0)
                and torch.equal(opt.state[t]["exp_avg_sq"], v0)
                for (m0, v0), t in zip(moments, a.masters.values())),
            "moments changed on a skipped step")
    # the timed steps and the profiled one
    require(torch.equal(opt.param_groups[0]["leaf_steps"], steps)
            and int(steps[0]) == BERT_STEPS + 1,
            "leaf step counts changed on a skipped step")
    require(torch.equal(a.params[0], compute),
            "compute params changed on a skipped step")
    emit("bert_train", model="bert_large", opt_level="O2",
         optimizer="FusedLAMB", lr=1e-3, eps=1e-6, weight_decay=0.01,
         max_grad_norm=1.0, batch=BERT_B, seq_len=BERT_L,
         steps=BERT_STEPS, parameters=sum(t.numel() for t in
                                          a.masters.values()),
         leaves=n_leaves, weights_from_seed_s=setup_s, losses=losses,
         loss_scales=scales, step_ms=[t * 1e3 for t in times],
         step_ms_p50_steps_3_to_10=p50,
         sequences_per_s=BERT_B / (p50 / 1e3),
         tokens_per_s=BERT_B * BERT_L / (p50 / 1e3), peak_memory_gb=peak,
         launches=counts, launches_per_step=per_step, pointer_rows=rows,
         profile=profile,
         injected_overflow={"skipped": True, "loss_scale": [
             scale_before, float(info["loss_scale"])]})
    del a, opt, model, grads, masters, moments, step, batch
    torch.cuda.empty_cache()
    return counts


def phase_bert_train_reference():
    """A 2-layer 2 x 64-head BERT, 3 FusedLAMB steps on the card (kernels)
    against the same on the CPU (plain versions) from the same weights,
    with a ragged key mask: fp32 O0, then bf16 O2."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import bert_params_from_jax, params_to_numpy
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256,
                     max_position_embeddings=128)
    tree = bert_tree(cfg, seed=6)
    arrays = mlm_batch(cfg.vocab_size, 4, 128, seed=7, ragged=True)

    def leaves(t, pre=()):
        for k, v in t.items():
            yield from (leaves(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), v)])

    out = {}
    for level in ("O0", "O2"):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = bert_params_from_jax(tree, cfg, device=dev,
                                         trainable=True)
            a = amp.initialize(model, FusedLAMB(model.parameters(),
                                                lr=1e-3, device=dev),
                               opt_level=level, device=dev)
            step = amp.make_train_step(a, model, _bert_loss)
            batch = _bert_batch(arrays, dev)
            losses = [float(step(*batch)["loss"]) for _ in range(3)]
            masters = {k: np.asarray(v, np.float32) for k, v in
                       leaves(params_to_numpy(a.masters))}
            runs[dev] = (losses, masters)
        (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
        require(all(np.isfinite(lg)) and lg[-1] < lg[0],
                f"{level} bert losses on the card: {lg}")
        out[level] = dict(losses_card=lg, losses_cpu=lc,
                          loss_max_abs_err=max(abs(x - y)
                                               for x, y in zip(lg, lc)),
                          param_max_abs_err=max(
                              float(np.abs(v - pc[k]).max())
                              for k, v in pg.items()))
    o0, o2 = out["O0"], out["O2"]
    require(o0["loss_max_abs_err"] <= 1e-4,
            f"fp32 bert losses card vs CPU differ by "
            f"{o0['loss_max_abs_err']}")
    require(o0["param_max_abs_err"] <= BERT_REF_PARAM_TOL,
            f"fp32 bert masters card vs CPU differ by "
            f"{o0['param_max_abs_err']}")
    require(o2["loss_max_abs_err"] <= BERT_REF_O2_LOSS_TOL,
            f"O2 bert losses card vs CPU differ by "
            f"{o2['loss_max_abs_err']}")
    emit("bert_train_reference", steps=3, kv_mask="ragged",
         O0=dict(o0, dtype="float32", loss_tolerance=1e-4,
                 param_tolerance=BERT_REF_PARAM_TOL),
         O2=dict(o2, dtype="bfloat16 compute, fp32 masters",
                 loss_tolerance=BERT_REF_O2_LOSS_TOL))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    if not (HERE / "apex_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: apex_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        name, count, smi = phase_device()
        phase_build()
        from apex_tpu_torch.convert import params_from_jax
        from apex_tpu_torch.models import gpt_small
        cfg = gpt_small()
        rng = np.random.default_rng(1)
        requests = [(f"r{i}", rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(32, 513))),
                     int(rng.integers(32, 129))) for i in range(16)]
        solo_reqs = requests[:4]
        ln_recs, fl_recs = phase_kernels([len(p) for _, p, _ in solo_reqs])
        tree = gpt_small_tree(cfg, seed=0)
        model = params_from_jax(tree, cfg, dtype=torch.bfloat16)
        engine_out, serve_counts = phase_serve(model, cfg, requests)
        solo_counts = phase_solo(model, cfg, solo_reqs, engine_out)
        require(serve_counts["layer_norm_fwd"] > 0,
                "layer_norm_fwd never launched on the serve path")
        require(solo_counts["flash_attn_fwd"] > 0,
                "flash_attn_fwd never launched on the solo path")
        del model
        torch.cuda.empty_cache()
        phase_reference(tree, cfg)
        train_recs = phase_train_kernels(cfg)
        train_counts = phase_train(cfg, tree)
        phase_train_reference()
        del tree
        from apex_tpu_torch.models import bert_large
        bert_cfg = bert_large()
        bert_recs = phase_bert_kernels(bert_cfg)
        bert_counts = phase_bert_train(bert_cfg)
        phase_bert_train_reference()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    by_path = {k: {"serve": serve_counts.get(k, 0),
                   "solo": solo_counts.get(k, 0),
                   "train": train_counts[k],
                   "bert_train": bert_counts[k]} for k in bert_counts}
    ln_main = next(r for r in ln_recs if r["n1"] == 8
                   and r["dtype"] == "bfloat16")
    rope_main = train_recs["flash_attn_fwd_rope"][0]
    summary = []
    for rec, recs, launches, src, rep in (
            (ln_main, ln_recs, serve_counts["layer_norm_fwd"],
             "apex_tpu_torch/csrc/layer_norm_fwd.cu",
             "apex_tpu/ops/pallas/layer_norm_kernels.py:132"),
            (fl_recs[0], fl_recs + [rope_main], solo_counts["flash_attn_fwd"],
             "apex_tpu_torch/csrc/flash_attn_fwd.cu",
             "apex_tpu/ops/pallas/flash_attention.py:587"),
            (train_recs["layer_norm_bwd"][0], train_recs["layer_norm_bwd"],
             train_counts["layer_norm_bwd"],
             "apex_tpu_torch/csrc/layer_norm_bwd.cu",
             "apex_tpu/ops/pallas/layer_norm_kernels.py:165"),
            (train_recs["flash_attn_bwd"][0], train_recs["flash_attn_bwd"],
             train_counts["flash_attn_bwd"],
             "apex_tpu_torch/csrc/flash_attn_bwd.cu",
             "apex_tpu/ops/pallas/flash_attention.py:477"),
            (train_recs["packed_adam"][0], train_recs["packed_adam"],
             train_counts["packed_adam"], "apex_tpu_torch/csrc/adam.cu",
             "apex_tpu/ops/pallas/adam_kernel.py:216"),
            (train_recs["packed_scale"][0], train_recs["packed_scale"],
             train_counts["packed_scale"],
             "apex_tpu_torch/csrc/multi_tensor_scale.cu",
             "apex_tpu/ops/pallas/multi_tensor_kernels.py:62"),
            (bert_recs["lamb_stage1"], [bert_recs["lamb_stage1"]],
             bert_counts["lamb_stage1"], "apex_tpu_torch/csrc/lamb.cu",
             "apex_tpu/ops/pallas/lamb_kernels.py:147"),
            (bert_recs["lamb_stage2"], [bert_recs["lamb_stage2"]],
             bert_counts["lamb_stage2"], "apex_tpu_torch/csrc/lamb.cu",
             "apex_tpu/ops/pallas/lamb_kernels.py:240"),
            (bert_recs["packed_sumsq"], [bert_recs["packed_sumsq"]],
             bert_counts["packed_sumsq"],
             "apex_tpu_torch/csrc/multi_tensor_sumsq.cu",
             "apex_tpu/ops/pallas/multi_tensor_kernels.py:200")):
        entry = dict(
            name=rec["kernel"], route="cuda", source=src, replaces=rep,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            shape=rec.get("shape", [rec.get("n1"), rec.get("n2")]),
            launches_by_path=by_path[rec["kernel"]])
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")
        if rec["kernel"] == "flash_attn_fwd":
            entry["train_shape_with_rope"] = {k: rope_main[k] for k in keys}
        if rec["kernel"] in bert_recs and rec is not bert_recs[
                rec["kernel"]]:
            bert = bert_recs[rec["kernel"]]
            entry["bert_shape"] = {k: bert.get(k, [bert.get("n1"),
                                                   bert.get("n2")])
                                   for k in keys}
            entry["bert_shape"]["launches"] = bert_counts[rec["kernel"]]
        if rec.get("library_null_reason"):
            entry["library_null_reason"] = rec["library_null_reason"]
        summary.append(entry)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
