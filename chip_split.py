#!/usr/bin/env python3
"""Split the host and the device cost of the port's small hot calls on one
CUDA card, for the checkout of the port beside this script or the one
``--repo`` names (any tree of the port since the first: the calls are
made through the entry points every tree has):

    python3 chip_split.py [--repo DIR]

Each measurement prints one JSON line:

- ``ln_decode_split``  the layer-norm forward (K1) at decode's 8 x 768
  bf16: the wrapper's call, the C entry point called with prepared
  arguments, the kernel's device time (``torch.profiler``), the whole
  no-grad ``fused_layer_norm_affine`` a decode step makes, and the
  wrapper's parts (stream lookup, allocations), beside ``F.layer_norm``;
  host microseconds a call (the best of three runs of 5000 calls);
- ``ln_train``  K1 at 16384 x 768 and 16384 x 1024 bf16 (a train
  forward, with statistics): call ms in turns with ``F.layer_norm``, both
  device times, the bytes bound;
- ``unscale``  amp's unscale (``LossScaler.unscale``, K6) of gpt_small's
  148 and bert_large's 303 bf16 gradients into kept fp32 buffers: ms a
  call, K6's launches a call, its device ms, the bound; and in place over
  fp32 copies beside ``torch._amp_foreach_non_finite_check_and_unscale_``;
- ``decode_step`` (first)  ``chip_smoke.py``'s profile of one decode step
  of 8 slots at gpt_small's width and depth (seeded weights): device ms
  by group, busy share, host ms in K1's calls.

Then the ``nvidia-smi`` name and power limit.  With no card it exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def _load_smoke():
    """``chip_smoke.py`` beside this script, by path (``--repo`` may hold
    another)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ln_decode_split(cs):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.normalization import fused_layer_norm_affine
    from apex_tpu_torch.ops.cuda import build, layer_norm_fwd
    from apex_tpu_torch.ops.cuda import layer_norm as ln
    dev = torch.device("cuda")
    x = torch.randn(8, 768, device=dev).to(torch.bfloat16)
    x3 = x.view(8, 1, 768)
    w, b = (torch.randn(768, device=dev).to(torch.bfloat16) for _ in range(2))
    y = torch.empty_like(x)
    mean, inv = (torch.empty(8, device=dev) for _ in range(2))
    lib = build.library()
    entry = lib.apex_layer_norm_fwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), 8, 768, 1e-5)
    if len(entry.argtypes) == 12:      # dtype codes, no route
        args = head + (1, 1, stream)
    else:                              # one mode word
        args = head + (ln._mode(8, 768, torch.bfloat16, 1, True, None),
                       stream)
    stats_free = "stats" in layer_norm_fwd.__code__.co_varnames
    calls = {
        "c_entry_us": lambda: entry(*args),
        "wrapper_us": (lambda: layer_norm_fwd(x, w, b, 1e-5, stats=False))
        if stats_free else (lambda: layer_norm_fwd(x, w, b, 1e-5)),
        "wrapper_with_stats_us": lambda: layer_norm_fwd(x, w, b, 1e-5),
        "f_layer_norm_us": lambda: F.layer_norm(x, (768,), w, b, 1e-5),
        "fused_layer_norm_affine_no_grad_us":
            lambda: fused_layer_norm_affine(x3, w, b, 768),
        "stream_current_stream_us":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_of_us": lambda: build.stream_of(x),
        "alloc_y_us": lambda: torch.empty_like(x),
        "alloc_stats_two_buffers_us": lambda: (
            torch.empty(8, dtype=torch.float32, device=dev),
            torch.empty(8, dtype=torch.float32, device=dev)),
        "alloc_stats_one_buffer_two_views_us": lambda: torch.empty(
            (2, 8), dtype=torch.float32, device=dev).unbind(0),
    }
    with torch.no_grad():
        us = {k: cs.host_us(fn) for k, fn in calls.items()}
        # the device times last: a profiled run can slow later host calls
        us["device_us"] = cs.device_us(calls["wrapper_us"], ("ln_fwd",))
        us["f_layer_norm_device_us"] = cs.device_us(
            calls["f_layer_norm_us"], ("layer_norm",))
    us["wrapper_python_us"] = us["wrapper_us"] - us["c_entry_us"]
    return dict(shape=[8, 768], dtype="bfloat16",
                wrapper_call="stats=False" if stats_free else "with stats",
                **us)


def ln_train(cs):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.cuda import layer_norm_fwd
    dev = torch.device("cuda")
    out = []
    for n2 in (768, 1024):
        n1 = 16384
        x = torch.randn(n1, n2, device=dev).to(torch.bfloat16)
        w, b = (torch.randn(n2, device=dev).to(torch.bfloat16)
                for _ in range(2))
        t = cs.in_turns({
            "ms": lambda: layer_norm_fwd(x, w, b, 1e-5),
            "library_ms": lambda: F.layer_norm(x, (n2,), w, b, 1e-5)})
        b_ms, _ = cs.bound(2 * n1 * n2 * 2 + 4 * n2 + 8 * n1, 8.0 * n1 * n2,
                           cs.PEAK_FP32_FLOPS)
        out.append(dict(
            n1=n1, n2=n2, dtype="bfloat16", **t, bound_ms=b_ms,
            device_ms=cs.device_us(lambda: layer_norm_fwd(x, w, b, 1e-5),
                                   ("ln_fwd",)) / 1e3,
            library_device_ms=cs.device_us(
                lambda: F.layer_norm(x, (n2,), w, b, 1e-5),
                ("layer_norm",)) / 1e3))
    return out


def unscale(cs):
    import torch
    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.models import bert_large, gpt_small
    from apex_tpu_torch.ops.cuda import packed_scale
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    out = []
    for name, cfg in (("gpt_small", gpt_small()), ("bert_large",
                                                   bert_large())):
        shapes = cs._leaf_shapes(cfg)
        grads = [torch.as_tensor(rng.standard_normal(s, np.float32),
                                 device=dev).to(torch.bfloat16)
                 for s in shapes]
        bufs = [torch.empty(s, device=dev) for s in shapes]
        scaler = LossScaler()
        state = scaler.init_state(dev)
        before = packed_scale.launches
        scaler.unscale(grads, state, out=bufs)
        launches = packed_scale.launches - before
        n = sum(g.numel() for g in grads)
        ms = cs.time_ms(lambda: scaler.unscale(grads, state, out=bufs))
        b_ms, _ = cs.bound(6.0 * n, 2.0 * n, cs.PEAK_FP32_FLOPS)
        f32 = [g.float() for g in grads]
        found = torch.zeros(1, device=dev)
        inv = (1.0 / state.loss_scale).reshape(1)     # the unscale's own
        t = cs.in_turns({
            "in_place_ms": lambda: scaler.unscale(f32, state, out=f32),
            "amp_foreach_in_place_ms":
                lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                    f32, found, inv)})
        ib_ms, _ = cs.bound(8.0 * n, 2.0 * n, cs.PEAK_FP32_FLOPS)
        out.append(dict(
            model=name, leaves=len(shapes), elements=n,
            launches_a_call=launches,
            ms=ms, bound_ms=b_ms, **t, in_place_bound_ms=ib_ms,
            device_ms=cs.device_us(lambda: scaler.unscale(grads, state,
                                                          out=bufs),
                                   ("scale_kernel",), n=5) * launches / 1e3))
        del grads, bufs, f32
        torch.cuda.empty_cache()
    return out


def decode_step(cs):
    import torch
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import gpt_small
    cfg = gpt_small()
    model = params_from_jax(cs.gpt_small_tree(cfg, seed=0), cfg,
                            dtype=torch.bfloat16)
    rec = cs.profile_decode_step(model, cfg)
    del model
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(HERE),
                    help="the checkout whose apex_tpu_torch is measured")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_split: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_split: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    if not (repo / "apex_tpu_torch" / "csrc").is_dir() \
            or not (HERE / "chip_smoke.py").is_file():
        print(f"chip_split: no apex_tpu_torch in {repo}, or no "
              f"chip_smoke.py beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    cs = _load_smoke()
    from apex_tpu_torch.ops.cuda import build
    build.library()
    # the decode step first: the others profile, which can slow the host
    for name, fn in (("decode_step", decode_step),
                     ("ln_decode_split", ln_decode_split),
                     ("ln_train", ln_train), ("unscale", unscale)):
        print(json.dumps({"split": name, "repo": str(repo),
                          "result": fn(cs)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
