"""Autoregressive decoding for :class:`~apex_tpu_torch.models.gpt.GPTModel`,
as ``apex_tpu/models/generate.py``.

The cache is dense, ``(L, B, prompt + max_new, H, D)`` in the model's
dtype, written in place.  A full prefill from an empty cache runs causal
attention over the prompt through :func:`apex_tpu_torch.attention.
attention` (the flash kernel on the card); decode steps and chunked
prefills attend against the cache through :func:`_attn_cached`, whose
math the serve engine shares.  Layer norm goes through the layer-norm
kernel on the card.  The layer math mirrors ``GPTModel.forward`` op for
op.

Greedy (``temperature=0``) or temperature sampling from a
``torch.Generator``.

The decode path names its parts for the profiler's step classifiers
(:data:`apex_tpu_torch.obs.stepclass.DECODE_RANGES`, ranges that exist
only while a capture runs): the weight products and the embedding gather
(``param_read``), the cache writes (``kv_write``), the cache's fp32 read
and the score chain of :func:`_attn_cached` (``kv_read``,
``attention``), the token pick (``sampling``); each decode step of
:func:`generate` runs in :data:`~apex_tpu_torch.obs.stepclass.
GENERATE_STEP`.

``kv_dtype="int8"`` stores the cache as int8 with one fp32 scale per
cached position and layer (``(L, B, M)`` beside each int8 cache): every
write quantizes its tokens' ``(H, D)`` vectors
(:func:`apex_tpu_torch.quant.int8.quantize_kv`), and the read folds the
scales into the attention math (:func:`_attn_cached`).  A full prefill
from an empty cache still runs the flash kernel on the unquantized q / k
/ v; only the cache is int8.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.attention import attention
from apex_tpu_torch.models.gpt import GPTBlock, GPTConfig, GPTModel, gelu
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    fused_layer_norm_affine,
)
from apex_tpu_torch.obs.stepclass import DECODE_RANGES, GENERATE_STEP
from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device
from apex_tpu_torch.ops.rope import apply_rope, rope_tables
from apex_tpu_torch.quant.int8 import quantize_kv
from apex_tpu_torch.utils.profiling import profile_range

NEG_INF = -1e30


def greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Lowest-index argmax over the last axis, ``(..., V) -> (...)``
    int64: exact max, exact compare, integer min — the lowest tied index
    wins whatever the reduction order.  Every greedy pick (solo
    ``generate()``, the serve sampler) goes through this one function.
    An all-NaN row matches nothing and returns ``V - 1``."""
    v = logits.shape[-1]
    mx = logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(v, device=logits.device)
    cand = torch.where(logits == mx, idx, torch.full_like(idx, v))
    return cand.amin(dim=-1).clamp_max(v - 1)


def _ln(x: torch.Tensor, ln: FusedLayerNorm, eps: float) -> torch.Tensor:
    return fused_layer_norm_affine(x, ln.scale, ln.bias, x.shape[-1], eps)


def _attn_cached(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid_mask: torch.Tensor,
                 scale: float, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32-softmax attention of ``q (B, Lq, H, D)`` against the cache
    ``(B, M, H, D)`` under a validity mask (True = attend), ``(Lq, M)``
    shared across the batch or ``(B, Lq, M)`` per row (the serve
    engine's per-slot lengths).  Output in q's dtype.

    ``k_scale`` / ``v_scale`` ``(B, M)`` read an int8 cache: the K scale
    multiplies the scores after the ``scale`` factor and before the mask,
    the V scale the probabilities after the softmax (each is constant
    over the contracted ``(H, D)``, so this is dequantizing the cache
    without making a dequantized copy)."""
    with profile_range(DECODE_RANGES["attention"]):
        mask = valid_mask[None, None] if valid_mask.dim() == 2 \
            else valid_mask[:, None]
        qf = q.float()
        with profile_range(DECODE_RANGES["kv_read"]):
            kf, vf = k_cache.float(), v_cache.float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if k_scale is not None:
            s = s * k_scale[:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        if v_scale is not None:
            p = p * v_scale[:, None, None, :]
        out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
        return out.to(q.dtype)


def _dense(h: torch.Tensor, layer) -> torch.Tensor:
    """``h @ kernel + bias`` of a ``Dense`` layer in h's dtype, in the
    ``param_read`` range."""
    with profile_range(DECODE_RANGES["param_read"]):
        return h @ layer.kernel + layer.bias.to(h.dtype)


def qkv_rotated(x: torch.Tensor, blk: GPTBlock, cfg: GPTConfig, cos, sin):
    """``ln1`` -> qkv projection -> split into ``(B, Lq, H, D)`` -> rope
    on q and k: the head of every cached block (solo and serve)."""
    b, lq = x.shape[0], x.shape[1]
    h = _ln(x, blk.ln1, cfg.layer_norm_eps)
    qkv = _dense(h, blk.attention.qkv)
    q, k, v = (t.reshape(b, lq, cfg.num_heads, cfg.head_dim)
               for t in qkv.split(cfg.hidden_size, dim=-1))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def block_tail(x: torch.Tensor, o: torch.Tensor, blk: GPTBlock,
               cfg: GPTConfig) -> torch.Tensor:
    """Attention output projection + residual, then the ``ln2`` FFN +
    residual: the tail of every cached block (solo and serve)."""
    b, lq = x.shape[0], x.shape[1]
    o = o.reshape(b, lq, cfg.hidden_size)
    x = x + _dense(o, blk.attention.out)
    h = _ln(x, blk.ln2, cfg.layer_norm_eps)
    h = gelu(_dense(h, blk.ffn_in))
    return x + _dense(h, blk.ffn_out)


def _block(x, blk: GPTBlock, cfg: GPTConfig, kc, vc, layer_i: int, cos,
           sin, valid_mask, write_at: int, ks=None, vs=None):
    """One block over ``x (B, Lq, E)``, writing its k/v into the caches
    ``(L, B, M, H, D)`` at ``(layer_i, :, write_at:)`` in place; with the
    int8 format's scale caches ``ks`` / ``vs`` ``(L, B, M)``, quantized
    (one scale a written position)."""
    lq = x.shape[1]
    at = slice(write_at, write_at + lq)
    q, k, v = qkv_rotated(x, blk, cfg, cos, sin)
    with profile_range(DECODE_RANGES["kv_write"]):
        if ks is not None:
            qk, sk = quantize_kv(k)             # (B, Lq, H, D), (B, Lq)
            qv, sv = quantize_kv(v)
            kc[layer_i, :, at] = qk
            vc[layer_i, :, at] = qv
            ks[layer_i, :, at] = sk
            vs[layer_i, :, at] = sv
        else:
            kc[layer_i, :, at] = k.to(kc.dtype)
            vc[layer_i, :, at] = v.to(vc.dtype)
    if lq > 1 and write_at == 0:
        # full prefill from an empty cache: causal self-attention over
        # the rotated prompt q/k/v IS attention to cache slots <= each
        # row's position — the flash kernel, with no (Lq, M) scores
        o = attention(q, k, v, causal=True)
    else:
        # a decode step or a chunk appended mid-sequence: its k/v are in
        # the cache already, so the masked cache attention covers the
        # history and the causality inside the chunk at once
        o = _attn_cached(q, kc[layer_i], vc[layer_i], valid_mask,
                         1.0 / math.sqrt(cfg.head_dim),
                         k_scale=None if ks is None else ks[layer_i],
                         v_scale=None if vs is None else vs[layer_i])
    return block_tail(x, o, blk, cfg)


def _forward_cached(model: GPTModel, cfg: GPTConfig, ids: torch.Tensor,
                    kc: torch.Tensor, vc: torch.Tensor, start: int,
                    ks: Optional[torch.Tensor] = None,
                    vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embed ``ids (B, Lq)`` at positions ``start..``, run every layer
    with cache writes at ``start`` (``ks`` / ``vs``: the int8 format's
    scale caches, None for a dense cache); returns the last token's
    logits ``(B, V)``."""
    b, lq = ids.shape
    m = kc.shape[2]
    dev = ids.device
    with profile_range(DECODE_RANGES["param_read"]):
        x = model.tok_emb.embedding[ids]
    positions = (start + torch.arange(lq, device=dev))[None].expand(b, lq)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    qpos = start + torch.arange(lq, device=dev)[:, None]
    valid = torch.arange(m, device=dev)[None, :] <= qpos          # (Lq, M)
    for i, blk in enumerate(model.blocks):
        x = _block(x, blk, cfg, kc, vc, i, cos, sin, valid, write_at=start,
                   ks=ks, vs=vs)
    x = _ln(x[:, -1:], model.ln_f, cfg.layer_norm_eps)
    with profile_range(DECODE_RANGES["param_read"]):
        return x[:, 0] @ model.lm_head.kernel


def sample_categorical(logits: torch.Tensor, temperature: float,
                       generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits / temperature)`` by inverse
    CDF, with one uniform per row from ``generator``."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    cdf = probs.cumsum(dim=-1)
    u = torch.rand(probs.shape[0], generator=generator,
                   device=generator.device).to(probs.device)
    idx = (cdf <= (u * cdf[:, -1])[:, None]).sum(dim=-1)
    return idx.clamp_max(probs.shape[-1] - 1)


def _check_model_device(model: GPTModel, device: torch.device) -> None:
    if not same_device(model.device, device):
        raise ValueError(f"model is on {model.device}, not {device}")


@torch.inference_mode()
def generate(model: GPTModel, cfg: GPTConfig, prompt_ids,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             kv_dtype: Optional[str] = None) -> torch.Tensor:
    """Decode ``max_new_tokens`` tokens after ``prompt_ids (B, L)``;
    returns ``(B, L + max_new_tokens)`` int64 ids on ``device`` (the card
    by default; the model must be there).  ``temperature=0`` is greedy;
    ``temperature > 0`` samples and needs ``generator``.
    ``kv_dtype="int8"`` keeps the cache in the int8 format (the module
    docstring); None keeps it in the model's dtype."""
    device = resolve_device(device)
    _check_model_device(model, device)
    sample = float(temperature) > 0.0
    if sample and generator is None:
        raise ValueError("temperature sampling requires a generator")
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8'; got "
                         f"{kv_dtype!r}")
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=device)
    b, lp = prompt.shape
    m = lp + int(max_new_tokens)
    shape = (cfg.num_layers, b, m, cfg.num_heads, cfg.head_dim)
    int8 = kv_dtype == "int8"
    kc = torch.zeros(shape, dtype=torch.int8 if int8 else model.dtype,
                     device=device)
    vc = torch.zeros_like(kc)
    ks = vs = None
    if int8:
        ks = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        vs = torch.zeros_like(ks)

    def pick(logits):
        with profile_range(DECODE_RANGES["sampling"]):
            if sample:
                return sample_categorical(logits, float(temperature),
                                          generator)
            return greedy_argmax(logits.float())

    out = [prompt]
    tok = pick(_forward_cached(model, cfg, prompt, kc, vc, start=0,
                               ks=ks, vs=vs))
    out.append(tok[:, None])
    for t in range(int(max_new_tokens) - 1):
        with profile_range(GENERATE_STEP):
            logits = _forward_cached(model, cfg, tok[:, None], kc, vc,
                                     start=lp + t, ks=ks, vs=vs)
            tok = pick(logits)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)[:, :m]
