"""Per-slot sampling: temperature / top-k / top-p / greedy, as
``apex_tpu/serve/sampling.py`` ``sample_tokens``.

- ``temperature (S,)``: 0 selects the greedy pick for that slot;
- ``top_k (S,)``: ``<= 0`` disables the cutoff;
- ``top_p (S,)``: ``>= 1`` disables the nucleus cutoff; the most
  probable token always survives both.

The JAX package chains one threefry key per slot; here each slot owns a
``torch.Generator`` (CPU, seeded from ``Request.seed``) and every call
draws exactly ONE uniform from each slot's generator, greedy slots
included, so a slot's stream depends only on its own seed and the number
of tokens it has emitted — never on its batch-mates.  The draw picks a
token by inverse CDF over the kept probabilities in descending order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from apex_tpu_torch.models.generate import greedy_argmax
from apex_tpu_torch.obs.stepclass import DECODE_RANGES
from apex_tpu_torch.utils.profiling import profile_range


def make_generator(seed: int) -> torch.Generator:
    """A slot's generator, seeded from its request's seed."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def draw_uniforms(generators: Sequence[torch.Generator]) -> torch.Tensor:
    """One uniform from each generator, ``(S,)`` fp32 on the CPU."""
    return torch.cat([torch.rand(1, generator=g) for g in generators])


def advance_key(seed: int, n: int) -> torch.Generator:
    """The generator of a request with ``seed`` after ``n`` emitted
    tokens (each :func:`sample_tokens` call draws once per slot)."""
    g = make_generator(seed)
    for _ in range(int(n)):
        draw_uniforms([g])
    return g


def sample_tokens(logits: torch.Tensor,
                  generators: Sequence[torch.Generator],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Tokens ``(S,)`` int64 sampled from ``logits (S, V)`` under per-slot
    knobs (module docstring); draws one uniform from each of the ``S``
    generators.  Runs in the ``decode/sampling`` range while a capture
    runs."""
    with profile_range(DECODE_RANGES["sampling"]):
        logits = logits.float()
        s, v = logits.shape
        dev = logits.device
        greedy = greedy_argmax(logits)
        u = draw_uniforms(generators).to(dev)
        temp = temperature.clamp_min(1e-6)[:, None]
        # one stable descending sort serves top-k and top-p; temperature
        # > 0 keeps the order of the raw logits
        order = torch.sort(logits, dim=-1, descending=True,
                           stable=True).indices
        sorted_scaled = (logits / temp).gather(-1, order)
        ranks = torch.arange(v, device=dev)[None, :]
        k_eff = torch.where(top_k <= 0, torch.full_like(top_k, v),
                            top_k.clamp_max(v))[:, None]
        probs = torch.softmax(sorted_scaled, dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep ranks whose PRECEDING mass is under top_p: the smallest
        # prefix whose mass reaches top_p
        keep = (ranks < k_eff) & ((cum - probs)
                                  < top_p.clamp(0.0, 1.0)[:, None])
        keep[:, 0] = True
        kept = torch.where(keep, probs,
                           torch.zeros_like(probs)).cumsum(dim=-1)
        picked = (kept <= (u * kept[:, -1])[:, None]).sum(dim=-1)
        picked = torch.minimum(picked, keep.sum(dim=-1) - 1)
        sampled = order.gather(-1, picked[:, None])[:, 0]
        return torch.where(temperature > 0, sampled, greedy)
