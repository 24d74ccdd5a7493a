"""BERT for pretraining (masked LM + next-sentence prediction), as
``apex_tpu/models/bert.py``.

Parameters are named as the flax tree names them (``bert/{tok_emb,
pos_emb, seg_emb, emb_ln, layer_{i}/{attention/{qkv, out}, attention_ln,
ffn_in, ffn_out, ffn_ln}}``, ``mlm_transform``, ``mlm_ln``,
``mlm_decoder``, ``pooler``, ``nsp``), so
:func:`apex_tpu_torch.convert.bert_params_from_jax` copies a JAX
checkpoint across by name.  Every layer norm is
:class:`~apex_tpu_torch.normalization.FusedLayerNorm` (K1 / K3 on the
card) and attention goes to the flash kernels (K2 / K4): one ``qkv``
product, q, k and v handed over as strided views of it, no key rotation,
no causal mask, the attention mask as the kernels' key mask.  The JAX
model's head-major and split branches hold the same parameters and
compute the same function; the port has the one.  ``scan_layers`` only
changes the JAX parameter layout (the converter unstacks it); ``remat``
recomputes each layer in the backward, as GPT's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.attention import attention
from apex_tpu_torch.layers import Dense, Embed
from apex_tpu_torch.models.gpt import gelu, run_layer
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    #: the JAX parameter layout only (one stacked ``layers/layer``
    #: subtree); the port's layers are a loop either way
    scan_layers: bool = False
    #: recompute each layer's activations in the backward
    #: (``torch.utils.checkpoint``, the JAX model's ``nn.remat``)
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_large() -> BertConfig:
    """24 layers, 16 heads of 64, hidden 1024, FFN 4096, vocab 30522,
    512 positions: Google's BERT-Large ``bert_config.json``."""
    return BertConfig()


def bert_large_tpu() -> BertConfig:
    """bert_large with 8 heads of 128 (the JAX package's TPU head width;
    same parameters and flops)."""
    return BertConfig(num_heads=8)


def bert_base() -> BertConfig:
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072)


def bert_tiny() -> BertConfig:
    """Test-scale config."""
    return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_heads=4, intermediate_size=256,
                      max_position_embeddings=64)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.qkv = Dense(e, 3 * e, dtype=dtype, device=device)
        self.out = Dense(e, e, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, l = x.shape[0], x.shape[1]
        # (B, L, 3, H, D): q, k, v are strided views of the one product
        # (their bf16 strides are multiples of 8 at every head width the
        # kernels take); unbind's backward stacks the three gradients
        # into one buffer
        q, k, v = self.qkv(x).view(b, l, 3, c.num_heads, c.head_dim) \
            .unbind(2)
        o = attention(q, k, v, causal=False,
                      kv_mask=None if mask is None else mask.bool(),
                      scale=1.0 / math.sqrt(c.head_dim))
        return self.out(o.reshape(b, l, c.hidden_size))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        e, f, eps = cfg.hidden_size, cfg.intermediate_size, \
            cfg.layer_norm_eps
        self.attention = SelfAttention(cfg, dtype=dtype, device=device)
        self.attention_ln = FusedLayerNorm(e, eps=eps, dtype=dtype,
                                           device=device)
        self.ffn_in = Dense(e, f, dtype=dtype, device=device)
        self.ffn_out = Dense(f, e, dtype=dtype, device=device)
        self.ffn_ln = FusedLayerNorm(e, eps=eps, dtype=dtype, device=device)

    def forward(self, x, mask=None):
        x = self.attention_ln(x + self.attention(x, mask))
        h = self.ffn_out(gelu(self.ffn_in(x)))
        return self.ffn_ln(x + h)


class BertModel(nn.Module):
    """The encoder: ``forward(input_ids (B, L), token_type_ids,
    attention_mask (B, L), 1 = attend)`` returns ``(B, L, hidden)``.
    Layer ``i`` is the attribute ``layer_{i}``.  Built on the card unless
    ``device`` says ``"cpu"`` (or ``"meta"``, shapes only)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        self.cfg = cfg
        e = cfg.hidden_size
        self.tok_emb = Embed(cfg.vocab_size, e, dtype=dtype, device=device)
        self.pos_emb = Embed(cfg.max_position_embeddings, e, dtype=dtype,
                             device=device)
        self.seg_emb = Embed(cfg.type_vocab_size, e, dtype=dtype,
                             device=device)
        self.emb_ln = FusedLayerNorm(e, eps=cfg.layer_norm_eps, dtype=dtype,
                                     device=device)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", TransformerLayer(cfg, dtype=dtype,
                                                         device=device))

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.num_layers)]

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        l = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.tok_emb(input_ids) + self.pos_emb.embedding[:l][None] \
            + self.seg_emb(token_type_ids)
        x = self.emb_ln(x)
        for layer in self.layers:
            x = run_layer(layer, self.cfg.remat, x, attention_mask)
        return x


class BertForPreTraining(nn.Module):
    """MLM and NSP heads over the encoder: ``forward`` returns
    ``(mlm_logits (B, L, vocab), nsp_logits (B, 2))``; built on the card
    unless ``device`` says ``"cpu"`` (or ``"meta"``)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        self.cfg = cfg
        e = cfg.hidden_size
        self.bert = BertModel(cfg, dtype=dtype, device=device)
        self.mlm_transform = Dense(e, e, dtype=dtype, device=device)
        self.mlm_ln = FusedLayerNorm(e, eps=cfg.layer_norm_eps, dtype=dtype,
                                     device=device)
        self.mlm_decoder = Dense(e, cfg.vocab_size, dtype=dtype,
                                 device=device)
        self.pooler = Dense(e, e, dtype=dtype, device=device)
        self.nsp = Dense(e, 2, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        seq = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_ln(gelu(self.mlm_transform(seq)))
        mlm_logits = self.mlm_decoder(h)
        pooled = torch.tanh(self.pooler(seq[:, 0]))
        return mlm_logits, self.nsp(pooled)


def pretraining_loss(mlm_logits: torch.Tensor, nsp_logits: torch.Tensor,
                     mlm_labels: torch.Tensor, nsp_labels: torch.Tensor,
                     mlm_mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM plus NSP cross entropy in fp32, as the JAX package's
    ``pretraining_loss``: ``logsumexp(logits) - logits[label]`` per
    position (the picked logit read in the logits' dtype, then widened),
    averaged over the positions where ``mlm_mask`` is 1 (at least one),
    plus the mean NSP ``-log_softmax[label]``.  The logsumexp and the
    log-softmax are the op layer's fp32 ops, as in the JAX package, over
    logits widened first (which is what the fp32 cast does under O1)."""
    lse = amp_ops.logsumexp(mlm_logits.float(), axis=-1)
    picked = mlm_logits.gather(-1, mlm_labels[..., None])[..., 0].float()
    w = mlm_mask.float()
    mlm = ((lse - picked) * w).sum() / torch.clamp(w.sum(), min=1.0)
    nsp_logp = amp_ops.log_softmax(nsp_logits.float(), axis=-1)
    nsp = -nsp_logp.gather(-1, nsp_labels[:, None]).mean()
    return mlm + nsp
