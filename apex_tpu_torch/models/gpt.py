"""GPT-style causal language model, as ``apex_tpu/models/gpt.py``.

Parameters are named as the flax tree names them (``tok_emb``,
``block_{i}/{ln1, attention/{qkv, out}, ln2, ffn_in, ffn_out}``,
``ln_f``, ``lm_head``), so :mod:`apex_tpu_torch.convert` copies a JAX
checkpoint across by name.  Layers are a Python loop over block modules
(the JAX package's ``scan_layers`` has no counterpart in eager mode;
:func:`~apex_tpu_torch.convert.params_from_jax` unstacks its layout).
``GPTConfig.remat`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``, the JAX model's ``nn.remat`` per block): the
memory of long-context training, at the cost of a second forward.
``forward`` builds the kernel-format rope tables once per call and hands
them to the local :func:`apex_tpu_torch.attention.attention`, which
rotates q and k inside the flash kernels (the JAX model's ``use_pallas()``
branch); the KV-cache paths of :mod:`~apex_tpu_torch.models.generate`
and the serve engine rotate before caching instead.  :func:`lm_loss` is
the JAX package's next-token loss.

``GPTConfig.seq_axis_name`` (``"data"``, the default group, or a
``ProcessGroup``) shards the sequence over a group's ranks (context
parallelism): each rank runs ``forward`` on its block of the sequence
with its slice of the *global* positions, q and k are rotated there
(the JAX model's pre-rotated branch: ``apply_rope`` on the half-width
tables), and attention is :func:`~apex_tpu_torch.attention.
ring_attention` over the group, causal (``seq_impl="ulysses"``:
:func:`~apex_tpu_torch.attention.ulysses_attention`).  ``lm_loss(...,
seq_axis_name=)`` divides each rank's sum by the global token count.
Each rank's parameter gradients are then its own share: a train step
must *sum* them over the group (``reduce_fn`` of
``Reducer(axis_name=..., gradient_average=False)``), as JAX's autodiff
sums the replicated parameters' gradients over ``shard_map``'s shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.attention import attention
from apex_tpu_torch.layers import Dense, Embed
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.ops.rope import (
    KernelRopeTables,
    apply_rope,
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
    #: shard the sequence over this group (``"data"`` or a
    #: ``ProcessGroup``: ring attention); None = local
    seq_axis_name: Optional[Any] = None
    #: the sequence-parallel attention under ``seq_axis_name``: the
    #: dispatcher's ``impl`` (``"ring"``, ``"ulysses"``, or the ring's
    #: engine ``"flash"`` / ``"jnp"``)
    seq_impl: str = "ring"
    #: recompute each block's activations in the backward (the JAX
    #: model's ``nn.remat(GPTBlock)``): only the block inputs are kept
    remat: bool = False

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

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        c = self.cfg
        b, l = x.shape[0], x.shape[1]
        q, k, v = (t.reshape(b, l, c.num_heads, c.head_dim)
                   for t in self.qkv(x).split(c.hidden_size, dim=-1))
        scale = 1.0 / math.sqrt(c.head_dim)
        if isinstance(rope, KernelRopeTables):
            # q / k reach the kernels unrotated: the rotation happens on
            # the loaded tiles, and the rotated tensors never exist in
            # memory
            o = attention(q, k, v, causal=True, scale=scale, rope=rope)
        else:
            # sequence-parallel: rotated here at the global positions,
            # then the ring over the group
            cos, sin = rope
            o = attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                          v, axis_name=c.seq_axis_name, impl=c.seq_impl,
                          causal=True, scale=scale)
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

    def forward(self, x, rope):
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
        ``positions (B, L)`` (default ``0..L-1``; with ``seq_axis_name``
        pass this rank's slice of the global positions)."""
        c = self.cfg
        b, l = input_ids.shape
        if positions is None:
            positions = torch.arange(l, device=input_ids.device)[None] \
                .expand(b, l)
        x = self.tok_emb(input_ids)
        # the tables depend only on the positions: built once per call,
        # shared by q and k of every layer (the kernel-format ones in the
        # activations' dtype, on the local path only)
        rope = rope_tables(positions, c.head_dim, c.rope_theta)
        if c.seq_axis_name is None:
            rope = rope_kernel_tables(*rope, b, l, c.head_dim, x.dtype)
        for blk in self.blocks:
            x = run_layer(blk, c.remat, x, rope)
        return self.lm_head(self.ln_f(x))


def run_layer(layer: nn.Module, remat: bool, *args):
    """``layer(*args)``; with ``remat`` and grad enabled, under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    dropped after the forward and recomputed by running it again in the
    backward, so its kernels launch twice in a training step.  The layers
    draw no random numbers, so no RNG state is saved.  The recompute runs
    under the amp O1 cast policy of the forward (autograd may run it on
    another thread, where the thread-local policy is unset), so it
    recomputes the same dtypes."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=amp_ops.recompute_context)
    return layer(*args)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            seq_axis_name: Optional[Any] = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32, as the JAX package's
    ``lm_loss``: ``logsumexp(logits) - logits[target]`` per position
    (the picked logit read in the logits' dtype, then widened), averaged
    over ``mask`` (all positions by default; the count is at least 1).
    ``targets`` are the shifted labels.

    With ``seq_axis_name`` (sequence-sharded training) the count is the
    group's total (one ``all_reduce``), so each rank returns ``local_sum
    / global_count``: the ranks' losses sum to the global mean, and their
    gradients, summed over the group, to its gradient."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0].float()
    m = torch.ones_like(picked) if mask is None else mask.float()
    count = m.sum()
    if seq_axis_name is not None:
        from apex_tpu_torch.parallel.distributed import (_all_reduce_,
                                                         process_group)
        count = _all_reduce_(count.detach().clone(),
                             process_group(seq_axis_name))
    return ((lse - picked) * m).sum() / torch.clamp(count, min=1.0)


def train_toy_lm(cfg: Optional[GPTConfig] = None, steps: int = 50,
                 period: int = 16, device: DeviceLike = None):
    """``(cfg, model, ids)``: gpt_tiny trained briefly on a periodic token
    stream, as the JAX package's ``train_toy_lm``: amp O2 and FusedAdam
    (lr 3e-3), ``steps`` steps on the ``(8, 64)`` ids ``(arange * 7) %
    period``, which it returns (int32) for prompts.  ``model`` is left
    in the O2 serving layout (bf16 parameters) on ``device`` (the card by
    default).  A model with real argmax margins: a random one's
    near-uniform logits measure tie-breaking, not a cache format.  Its
    weights start from seed 8 of PyTorch's CPU generator (drawn on the
    CPU whatever the device, without touching the global generator), so
    it is not the JAX package's model bit for bit."""
    import numpy as np

    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    device = resolve_device(device)
    cfg = cfg or gpt_tiny()
    ids = (np.arange(8 * 64).reshape(8, 64) * 7) % period
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        model = GPTModel(cfg, device="cpu")
    model = model.to(device)
    a = amp.initialize(model, FusedAdam(model.parameters(), lr=3e-3,
                                        device=device),
                       opt_level="O2", device=device)
    step = amp.make_train_step(
        a, model, lambda m, x: lm_loss(m(x)[:, :-1], x[:, 1:]))
    x = torch.as_tensor(ids, device=device)
    for _ in range(steps):
        step(x)
    return cfg, model, ids.astype(np.int32)
