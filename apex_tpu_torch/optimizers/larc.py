"""LARC, layer-wise adaptive rate clipping (``apex_tpu/optimizers/
larc.py``, reference ``apex/parallel/LARC.py:6-97``).

Each leaf's gradient is rescaled by ``trust_coefficient * ||p|| /
(||g|| + weight_decay * ||p|| + eps)`` before the inner optimizer steps:
``clip=True`` caps the ratio to the learning rate at 1, ``clip=False``
scales by the raw rate; the weight decay is folded into the gradient,
and a leaf whose parameter or gradient norm is 0 keeps its gradient.

:func:`larc` is the rescaling of a list of gradients; :class:`LARC`
wraps a ``torch.optim`` optimizer with it (the learning rate is each
parameter group's ``lr``).  The per-leaf norms come from K12
(``multi_tensor_sumsq`` per tensor, one launch over the chunk table of
the parameters and one of the gradients a step on the card; its plain
version on the CPU).  :class:`LARC` forwards ``noop_flag`` /
``model_params``, so amp's :meth:`~apex_tpu_torch.amp.Amp.step_if`
still drives :class:`~apex_tpu_torch.optimizers.FusedAdam` in one K11
launch under the device skip flag.
"""

from __future__ import annotations

import inspect
from typing import List, Optional, Sequence

import torch

from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE, per_tensor_sumsq


@torch.no_grad()
def larc(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
         lr, trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8, weight_decay: float = 0.0
         ) -> List[torch.Tensor]:
    """The LARC-rescaled gradients (new tensors, each in its gradient's
    dtype) of ``params`` (``LARC.py:68-97``), computed in fp32."""
    grads, params = list(grads), list(params)
    if len(grads) != len(params):
        raise ValueError(f"{len(grads)} gradients for {len(params)} "
                         "parameters")
    if not grads:
        return []
    p_norm = torch.sqrt(per_tensor_sumsq(CHUNK_SIZE, [params]))
    g_norm = torch.sqrt(per_tensor_sumsq(CHUNK_SIZE, [grads]))
    adaptive = trust_coefficient * p_norm \
        / (g_norm + p_norm * weight_decay + eps)
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=p_norm.device)
    rate = torch.clamp_max(adaptive / lr_t, 1.0) if clip else adaptive
    on = (p_norm > 0) & (g_norm > 0)
    # where a norm is 0 the gradient stays: no decay term, a rate of 1
    rate = torch.where(on, rate, torch.ones_like(rate))
    decay = torch.where(on, torch.full_like(rate, weight_decay),
                        torch.zeros_like(rate))
    return [((g.float() + decay[i] * p.float()) * rate[i]).to(g.dtype)
            for i, (g, p) in enumerate(zip(grads, params))]


class LARC:
    """``LARC(optimizer, trust_coefficient=0.02, clip=True, eps=1e-8,
    weight_decay=0.0)``: an optimizer whose :meth:`step` rescales each
    parameter group's gradients by :func:`larc` at the group's ``lr``,
    then steps ``optimizer``; ``param_groups`` are the inner
    optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.optimizer = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay
        self._inner_takes_flag = "noop_flag" in inspect.signature(
            optimizer.step).parameters

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @torch.no_grad()
    def step(self, closure=None, *, noop_flag: Optional[torch.Tensor] = None,
             model_params: Optional[Sequence[torch.Tensor]] = None):
        """Rescale every group's gradients, then step the inner
        optimizer, passing ``noop_flag`` / ``model_params`` on.  An inner
        optimizer without them reads the flag on the host (a set flag
        skips the step) and takes no ``model_params``."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.optimizer.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            for p, g in zip(ps, larc(
                    [p.grad for p in ps], ps, group["lr"],
                    self.trust_coefficient, self.clip, self.eps,
                    self.weight_decay)):
                p.grad = g
        if self._inner_takes_flag:
            self.optimizer.step(noop_flag=noop_flag,
                                model_params=model_params)
        elif model_params is not None:
            raise TypeError(f"{type(self.optimizer).__name__}.step takes no "
                            "model_params")
        elif noop_flag is None or not bool(noop_flag.reshape(-1)[0]):
            self.optimizer.step()
        return loss
