"""Sequence-parallel attention over a process group, as
``apex_tpu/attention/ring.py``: the sequence dimension of ``(B, L, H, D)``
is sharded over the ranks of ``axis_name`` (``"data"``: the default
group, or a ``ProcessGroup``), each rank holding a contiguous block of
``L / W`` positions in rank order.

- :func:`ring_attention`: each rank keeps its query block; the key and
  value blocks (and the key mask) travel one rank forward a step, W
  steps in all, and each step's partial result is merged into an fp32
  carry.  The ``"flash"`` engine (the default on the card) runs the local
  flash attention with ``return_lse=True`` each step
  (:class:`~apex_tpu_torch.attention.FlashAttention`: K2 forward, K4 or
  K13 + K14 backward, the backward with the lse's cotangent) and merges
  ``(o, lse)`` by logsumexp weights (the first block is the carry: at
  world size 1 nothing is merged); under ``causal`` the block from a
  lower rank is attended in full, the diagonal block locally causal, and
  a block from a higher rank is skipped with no launch.  The ``"jnp"``
  engine is the plain materializing online softmax.
- :func:`ulysses_attention`: an all-to-all trades the sequence shard for
  a head shard, ``(B, L/W, H, D) -> (B, L, H/W, D)``, then local
  attention over the whole sequence, then the inverse all-to-all; the
  key mask is all-gathered.
- :func:`attention`: the dispatcher; with no ``axis_name`` it is
  :func:`~apex_tpu_torch.attention.local_attention`.

``impl`` keeps the JAX package's values (``None``, ``"flash"``,
``"jnp"``); ``None`` is ``"flash"`` on the card and ``"jnp"`` on the CPU,
and on CPU tensors both engines run plain PyTorch.  Gradients flow by
autograd: through the merge and :class:`FlashAttention`'s differentiable
``lse``, and through the collectives, which are autograd Functions
(``send`` / ``recv`` are not differentiable in ``torch.distributed``):
a hop sends forward to rank + 1 and its backward sends the cotangent
back to rank - 1, as JAX transposes ``ppermute``; the all-to-all's
backward is the inverse all-to-all.  At world size 1 a hop is the
identity and nothing is sent.

The ranks' backend decides how a block travels: NCCL sends device
tensors; gloo's ``send`` / ``recv`` and all-to-all read host memory, so
under gloo a CUDA block is copied to the host and back, explicitly
(counted as ``via_host`` in :func:`~apex_tpu_torch.parallel.
collective_counts`).  Nothing here picks a backend.  Every hop and
all-to-all is counted there too (``ring_hop``, ``send_recv``,
``all_to_all``).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.attention import local_attention
from apex_tpu_torch.parallel.distributed import _all_gather_parts
from apex_tpu_torch.parallel.p2p import (AllToAll, Anchor, Hop, group_of,
                                         shift, unwire, via_host, wire)

#: the masked score of the plain engine (the JAX package's ``NEG_INF``)
NEG_INF = -1e30

_IMPLS = (None, "flash", "jnp")


def _hop(group, k, v, mask):
    """The next step's blocks: ``(k, v)`` through :class:`~apex_tpu_torch.
    parallel.p2p.Hop`, the mask
    beside them."""
    k, v = Hop.apply(group, "ring_hop", k, v)
    if mask is not None:
        mask = shift([mask], group, 1)[0]
    return k, v, mask


def _scale_of(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5


def _block_scores(q, k, scale, q_off, k_off, causal, kv_mask):
    """fp32 scores ``(B, H, Lq, Lk)`` of one block pair, ``NEG_INF`` where
    the mask or causality hides a key (the JAX package's
    ``_block_scores``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.full_like(s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, neg)
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        neg)
    return s


def _plain_softmax_attention(q, k, v, scale, causal, kv_mask):
    """The JAX package's materializing jnp path over whole sequences (a
    row that sees no key averages every value, as JAX's does)."""
    s = _block_scores(q, k, scale, 0, 0, causal, kv_mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / safe_l, v.float())
    return out.to(q.dtype), m, safe_l, l


def _ring_flash(q, k, v, group, rank, world, causal, kv_mask, scale):
    o = lse = None
    k_t, v_t, mask_t = k, v, kv_mask
    for t in range(world):
        src = (rank - t) % world
        # src < rank: every key precedes every query; src == rank: the
        # diagonal block; src > rank: every key follows (no launch)
        if not (causal and src > rank):
            o_t, lse_t = local_attention(
                q, k_t, v_t, causal=causal and src == rank, kv_mask=mask_t,
                scale=scale, return_lse=True)
            if o is None:
                # merged into an empty carry (o 0, lse NEG_INF) a block is
                # itself, bit for bit and in its gradients: no merge
                o, lse = o_t, lse_t
            else:
                m = torch.maximum(lse, lse_t)
                w1 = torch.exp(lse - m)
                w2 = torch.exp(lse_t - m)
                tot = w1 + w2
                o = (o.float() * w1[..., None]
                     + o_t.float() * w2[..., None]) / tot[..., None]
                lse = m + torch.log(tot)
        if t < world - 1:
            k_t, v_t, mask_t = _hop(group, k_t, v_t, mask_t)
    if world > 1 and torch.is_grad_enabled() and k_t.requires_grad:
        o = Anchor.apply(o, k_t, v_t)
    return o.to(q.dtype)


def _ring_plain(q, k, v, group, rank, world, causal, kv_mask, scale):
    b, l, h, d = q.shape
    m = torch.full((b, h, l), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, l), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, l, h, d), dtype=torch.float32, device=q.device)
    k_t, v_t, mask_t = k, v, kv_mask
    for t in range(world):
        src = (rank - t) % world
        s = _block_scores(q, k_t, scale, rank * l, src * l, causal, mask_t)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_t.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if t < world - 1:
            k_t, v_t, mask_t = _hop(group, k_t, v_t, mask_t)
    safe = torch.where(den == 0.0, torch.ones_like(den), den)
    return (acc / safe.transpose(1, 2)[..., None]).to(q.dtype)


def _engine(impl, q) -> str:
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}: want None, 'flash' or "
                         f"'jnp'")
    return impl or ("flash" if q.is_cuda else "jnp")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name="data", causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis_name``: q,
    k, v are this rank's ``(B, L/W, H, D)`` blocks, ``kv_mask`` its
    ``(B, L/W)`` bool key mask (True = attend).  Returns this rank's
    ``(B, L/W, H, D)`` output in q's dtype.  ``impl``: ``"flash"`` (the
    default on the card) or ``"jnp"`` (the default on the CPU).  A row
    that sees no key gives zeros under ``"flash"`` (the flash kernels'
    convention) and the mean of the values under ``"jnp"`` (the JAX
    package's plain path)."""
    engine = _engine(impl, q)
    group, rank, world = group_of(axis_name)
    scale = _scale_of(q, scale)
    run = _ring_flash if engine == "flash" else _ring_plain
    return run(q, k, v, group, rank, world, causal, kv_mask, scale)


def _gather_mask(kv_mask: torch.Tensor, group) -> torch.Tensor:
    """``(B, L/W)`` masks of every rank joined into ``(B, L)``."""
    send = wire(kv_mask, via_host(kv_mask, group))
    parts = _all_gather_parts(send, group, like=kv_mask)
    return torch.cat([unwire(p, kv_mask) for p in parts], dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name="data", causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """All-to-all sequence parallelism: this rank's ``(B, L/W, H, D)``
    blocks become ``(B, L, H/W, D)`` (a head shard over the whole
    sequence), attention runs locally (``impl``: ``"flash"``, the local
    flash kernels; ``"jnp"``, the plain path), and the output goes back
    to ``(B, L/W, H, D)``.  The heads must divide by the world size."""
    engine = _engine(impl, q)
    group, _, world = group_of(axis_name)
    h = q.shape[2]
    if h % world:
        raise ValueError(f"heads ({h}) must divide by the axis size "
                         f"({world}) for ulysses_attention")
    scale = _scale_of(q, scale)
    if world == 1:
        qf, kf, vf, mask_f = q, k, v, kv_mask
    else:
        qf, kf, vf = AllToAll.apply(group, 2, 1, q, k, v)
        mask_f = None if kv_mask is None else _gather_mask(kv_mask, group)
    if engine == "flash":
        out = local_attention(qf, kf, vf, causal=causal, kv_mask=mask_f,
                              scale=scale)
    else:
        out = _plain_softmax_attention(qf, kf, vf, scale, causal, mask_f)[0]
    if world == 1:
        return out
    return AllToAll.apply(group, 1, 2, out)[0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              axis_name=None, impl: str = "ring", **kwargs):
    """The dispatcher of the JAX package's ``attention``: with no
    ``axis_name`` local attention (``impl="jnp"``: the plain materializing
    path, which takes neither ``rope`` nor ``layout``; otherwise :func:`~apex_tpu_torch.attention.local_attention`,
    the flash kernels, which takes ``causal``, ``kv_mask``, ``scale``,
    ``return_lse``, ``rope`` and ``layout``); with one, ``impl="ring"``
    (:func:`ring_attention`, its default engine), ``"ulysses"``
    (:func:`ulysses_attention`), or ``"flash"`` / ``"jnp"`` (the ring
    with that engine).  ``rope`` and ``layout="bhld"`` are local only:
    the sequence-parallel engines take q and k already rotated at their
    global positions, in ``(B, L, H, D)``."""
    if impl not in ("ring", "ulysses", "flash", "jnp"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if axis_name is not None:
        if kwargs.get("layout", "blhd") == "bhld":
            raise ValueError("layout='bhld' requires axis_name=None")
        if kwargs.get("rope") is not None:
            raise ValueError("rope=(cos, sin) requires axis_name=None; "
                             "rotate q/k with apply_rope before a "
                             "sequence-parallel call")
        kwargs.pop("layout", None)
        kwargs.pop("rope", None)
        if impl == "ulysses":
            return ulysses_attention(q, k, v, axis_name, **kwargs)
        if impl in ("flash", "jnp"):
            return ring_attention(q, k, v, axis_name, impl=impl, **kwargs)
        return ring_attention(q, k, v, axis_name, **kwargs)
    if impl != "jnp":
        return local_attention(q, k, v, **kwargs)
    return _local_plain(q, k, v, **kwargs)


def _local_plain(q, k, v, causal=False, kv_mask=None, scale=None,
                 return_lse=False):
    """The JAX package's local jnp path (``impl="jnp"``), on ``(B, L, H,
    D)`` tensors without rope (the flash path takes both)."""
    out, m, safe_l, l = _plain_softmax_attention(
        q, k, v, _scale_of(q, scale), causal, kv_mask)
    if not return_lse:
        return out
    lse = torch.where(l[..., 0] == 0.0,
                      torch.full_like(l[..., 0], NEG_INF),
                      m[..., 0] + torch.log(safe_l[..., 0]))
    return out, lse.transpose(1, 2)


__all__ = ["NEG_INF", "attention", "ring_attention", "ulysses_attention"]
