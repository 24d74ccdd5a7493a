"""GPT-style causal language model, as ``apex_tpu/models/gpt.py``.

Parameters are named as the flax tree names them (``tok_emb``,
``block_{i}/{ln1, attention/{qkv, out}, ln2, ffn_in, ffn_out}``,
``ln_f``, ``lm_head``), so :mod:`apex_tpu_torch.convert` copies a JAX
checkpoint across by name.  Layers are a Python loop over block modules
(the JAX package's ``scan_layers`` has no counterpart in eager mode).
``forward`` builds the kernel-format rope tables once per call and hands
them to the local :func:`apex_tpu_torch.attention.attention`, which
rotates q and k inside the flash kernels (the JAX model's ``use_pallas()``
branch); the KV-cache paths of :mod:`~apex_tpu_torch.models.generate`
and the serve engine rotate before caching instead.  :func:`lm_loss` is
the JAX package's next-token loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.attention import attention
from apex_tpu_torch.layers import Dense, Embed
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.ops.rope import (
    KernelRopeTables,
    rope_kernel_tables,
    rope_tables,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_small() -> GPTConfig:
    """12 layers, 12 heads of 64, hidden 768, FFN 3072, vocab 32000."""
    return GPTConfig()


def gpt_small_tpu() -> GPTConfig:
    """gpt_small with 6 heads of 128 (the JAX package's TPU head width)."""
    return GPTConfig(num_heads=6)


def gpt_tiny() -> GPTConfig:
    """Test-scale config."""
    return GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu (flax ``nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.qkv = Dense(e, 3 * e, dtype=dtype, device=device)
        self.out = Dense(e, e, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                rope: KernelRopeTables) -> torch.Tensor:
        c = self.cfg
        b, l = x.shape[0], x.shape[1]
        q, k, v = (t.reshape(b, l, c.num_heads, c.head_dim)
                   for t in self.qkv(x).split(c.hidden_size, dim=-1))
        # q / k reach the kernels unrotated: the rotation happens on the
        # loaded tiles, and the rotated tensors never exist in memory
        o = attention(q, k, v, causal=True,
                      scale=1.0 / math.sqrt(c.head_dim), rope=rope)
        return self.out(o.reshape(b, l, c.hidden_size))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype=torch.float32, device=None):
        super().__init__()
        e, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln1 = FusedLayerNorm(e, eps=eps, dtype=dtype, device=device)
        self.attention = CausalSelfAttention(cfg, dtype=dtype, device=device)
        self.ln2 = FusedLayerNorm(e, eps=eps, dtype=dtype, device=device)
        self.ffn_in = Dense(e, cfg.intermediate_size, dtype=dtype,
                            device=device)
        self.ffn_out = Dense(cfg.intermediate_size, e, dtype=dtype,
                             device=device)

    def forward(self, x, rope: KernelRopeTables):
        x = x + self.attention(self.ln1(x), rope)
        return x + self.ffn_out(gelu(self.ffn_in(self.ln2(x))))


class GPTModel(nn.Module):
    """Decoder-only transformer: ``forward(input_ids (B, L))`` returns
    logits ``(B, L, vocab)``.  Block ``i`` is the attribute
    ``block_{i}``; :attr:`blocks` lists them in order.  Built on the card
    unless ``device`` says ``"cpu"`` (or ``"meta"``, shapes only)."""

    def __init__(self, cfg: GPTConfig, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        self.cfg = cfg
        self.tok_emb = Embed(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                             device=device)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", GPTBlock(cfg, dtype=dtype,
                                                 device=device))
        self.ln_f = FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                   dtype=dtype, device=device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size,
                             use_bias=False, dtype=dtype, device=device)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}")
                for i in range(self.cfg.num_layers)]

    @property
    def device(self) -> torch.device:
        return self.tok_emb.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.embedding.dtype

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``(B, L, vocab)`` of ``input_ids (B, L)`` at global
        ``positions (B, L)`` (default ``0..L-1``)."""
        c = self.cfg
        b, l = input_ids.shape
        if positions is None:
            positions = torch.arange(l, device=input_ids.device)[None] \
                .expand(b, l)
        x = self.tok_emb(input_ids)
        # the tables depend only on the positions: built once per call,
        # shared by q and k of every layer, in the activations' dtype
        cos, sin = rope_tables(positions, c.head_dim, c.rope_theta)
        rope = rope_kernel_tables(cos, sin, b, l, c.head_dim, x.dtype)
        for blk in self.blocks:
            x = blk(x, rope)
        return self.lm_head(self.ln_f(x))


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32, as the JAX package's
    ``lm_loss``: ``logsumexp(logits) - logits[target]`` per position
    (the picked logit read in the logits' dtype, then widened), averaged
    over ``mask`` (all positions by default; the count is at least 1).
    ``targets`` are the shifted labels."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0].float()
    m = torch.ones_like(picked) if mask is None else mask.float()
    return ((lse - picked) * m).sum() / torch.clamp(m.sum(), min=1.0)
