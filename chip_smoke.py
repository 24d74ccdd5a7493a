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
            versions on the CPU, tokens and logits.

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


def _ln_case(n1, dtype, rng):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import layer_norm_fwd, layer_norm_fwd_ref
    from apex_tpu_torch.testing import BF16_CANCEL_ATOL, bf16_ulp_distance
    n2 = 768
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


def _flash_case(shape, rng, masked=False):
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
    o, lse = flash_attn_fwd(q, k, v, causal=True, kv_mask=mask,
                            return_lse=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                        causal=True, kv_mask=mask)
    err = float((o.float() - o_ref).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    require(err <= 2e-2 and lse_err <= 2e-2,
            f"flash_attn_fwd {shape} masked={masked}: o err {err}, "
            f"lse err {lse_err}")
    ms = time_ms(lambda: flash_attn_fwd(q, k, v, causal=True, kv_mask=mask))
    plain = time_ms(lambda: flash_attn_fwd_ref(q, k, v, causal=True,
                                               kv_mask=mask))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if masked:
        causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
        am = causal[None, None] & mask[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am))
        pairs = float(am.sum()) * h
    else:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        pairs = bsz * h * l * (l + 1) / 2
    nbytes = 4 * bsz * l * h * d * 2 + (bsz * l if masked else 0)
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_FLOPS)
    rec = dict(kernel="flash_attn_fwd", shape=list(shape), causal=True,
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
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    ln_main = next(r for r in ln_recs if r["n1"] == 8
                   and r["dtype"] == "bfloat16")
    fl_main = fl_recs[0]
    summary = []
    for rec, recs, launches, src, rep in (
            (ln_main, ln_recs, serve_counts["layer_norm_fwd"],
             "apex_tpu_torch/csrc/layer_norm_fwd.cu",
             "apex_tpu/ops/pallas/layer_norm_kernels.py:132"),
            (fl_main, fl_recs, solo_counts["flash_attn_fwd"],
             "apex_tpu_torch/csrc/flash_attn_fwd.cu",
             "apex_tpu/ops/pallas/flash_attention.py:587")):
        summary.append(dict(
            name=rec["kernel"], route="cuda", source=src, replaces=rep,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            shape=rec.get("shape", [rec.get("n1"), rec.get("n2")])))
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
