"""FusedAdam, as ``apex_tpu/optimizers/fused_adam.py``: Adam with the
descale, both moments and the update fused into one pass per parameter
(K5, :func:`apex_tpu_torch.ops.cuda.packed_adam`, on the card).

Two surfaces: :func:`adam_step`, the raw update of one leaf, and
:class:`FusedAdam`, a ``torch.optim.Optimizer`` over fp32 (master)
tensors.  Bias correction is per leaf: each parameter carries its own
step count (the reference's per-param ``state['step']``, the JAX
package's ``leaf_step``), and ``step_size = lr * sqrt(1 - b2^t) /
(1 - b1^t)`` is computed in fp32 on the device for every leaf at once.
A step can be made conditional on a device flag (``noop_flag``, the amp
overflow flag): the kernels and the step counts read it on the card, so
a skipped step needs no host sync.  Parameters are updated in place.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch

from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device
from apex_tpu_torch.ops.cuda import packed_adam
from apex_tpu_torch.ops.cuda.adam import EPS_MODE_INSIDE, EPS_MODE_OUTSIDE


def bias_corrected_step_sizes(lr: float, beta1: float, beta2: float,
                              steps: torch.Tensor,
                              bias_correction: bool = True) -> torch.Tensor:
    """fp32 ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` for each count in
    ``steps`` (or ``lr`` without bias correction)."""
    t = steps.float()
    if not bias_correction:
        return torch.full_like(t, lr)
    b1 = torch.tensor(beta1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(beta2, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    return lr * torch.sqrt(bc2) / bc1


def adam_step(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, *, lr: float, beta1: float, beta2: float,
              eps: float, step: torch.Tensor, scale=1.0,
              weight_decay: float = 0.0, eps_mode: int = EPS_MODE_OUTSIDE,
              bias_correction: bool = True,
              p_copy: Optional[torch.Tensor] = None,
              noop_flag: Optional[torch.Tensor] = None) -> None:
    """One fused Adam update of one leaf, in place; all math in fp32.
    ``step`` is the 1-based count after this update; ``scale`` divides
    the gradient (a number or a one-element fp32 tensor)."""
    step_size = bias_corrected_step_sizes(
        lr, beta1, beta2, torch.as_tensor(step, device=p.device).reshape(1),
        bias_correction)
    scale_t = torch.as_tensor(scale, dtype=torch.float32,
                              device=p.device).reshape(1)
    packed_adam(p.view(-1), m.view(-1), v.view(-1), g.reshape(-1),
                step_size, scale_t, noop_flag, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay, eps_mode=eps_mode,
                p_copy=None if p_copy is None else p_copy.view(-1))


class FusedAdam(torch.optim.Optimizer):
    """Adam over fp32 parameters with the reference's constructor.

    ``step(noop_flag=None, model_params=None)``: ``noop_flag`` (one int32
    on the parameters' device) makes the whole step conditional on the
    card; ``model_params`` (one half tensor per parameter, in order) get
    a bf16 copy of each new parameter in the same pass, the reference's
    fused half write-back.  Gradients are the parameters' ``.grad``.
    The parameters must lie on ``device`` (the card by default; pass
    ``device="cpu"`` for the plain versions)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-8, eps_inside_sqrt: bool = False,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 amsgrad: bool = False, device: DeviceLike = None):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        if max_grad_norm:
            raise RuntimeError(
                "max_grad_norm belongs to FP16Optimizer's fused grad-norm "
                "path, not FusedAdam (which receives the combined scale "
                "from its wrapper), as in the reference.")
        device = resolve_device(device)
        defaults = dict(lr=lr, bias_correction=bias_correction,
                        betas=tuple(betas), eps=eps,
                        eps_mode=(EPS_MODE_INSIDE if eps_inside_sqrt
                                  else EPS_MODE_OUTSIDE),
                        weight_decay=weight_decay)
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                if not same_device(p.device, device):
                    raise ValueError(f"FusedAdam: a parameter is on "
                                     f"{p.device}, not {device}")

    def _group_steps(self, group) -> torch.Tensor:
        """The group's per-leaf step counts, one int32 vector; each
        parameter's ``state['step']`` is a 0-dim view into it."""
        params = group["params"]
        steps = group.get("leaf_steps")
        if steps is None or steps.numel() != len(params):
            steps = torch.zeros(len(params), dtype=torch.int32,
                                device=params[0].device)
            group["leaf_steps"] = steps
            for i, p in enumerate(params):
                st = self.state[p]
                st["step"] = steps[i]
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        return steps

    @torch.no_grad()
    def step(self, closure=None, *, noop_flag: Optional[torch.Tensor] = None,
             model_params: Optional[Sequence[torch.Tensor]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        copies: List[Optional[torch.Tensor]] = (
            list(model_params) if model_params is not None else [])
        at = 0
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            steps = self._group_steps(group)
            dev = params[0].device
            if noop_flag is None:
                steps += 1
            else:
                steps += (noop_flag.reshape(()) == 0).to(torch.int32)
            beta1, beta2 = group["betas"]
            sizes = bias_corrected_step_sizes(
                group["lr"], beta1, beta2, steps, group["bias_correction"])
            # the gradients arrive unscaled (amp's unscale ran first)
            one = torch.ones(1, dtype=torch.float32, device=dev)
            for i, p in enumerate(params):
                copy = copies[at + i] if copies else None
                if p.grad is None:
                    raise RuntimeError("FusedAdam: a parameter has no grad "
                                       "(every leaf steps, as in the JAX "
                                       "optimizer)")
                st = self.state[p]
                packed_adam(p.view(-1), st["exp_avg"].view(-1),
                            st["exp_avg_sq"].view(-1), p.grad.reshape(-1),
                            sizes[i:i + 1], one, noop_flag,
                            beta1=beta1, beta2=beta2, eps=group["eps"],
                            weight_decay=group["weight_decay"],
                            eps_mode=group["eps_mode"],
                            p_copy=None if copy is None else copy.view(-1))
            at += len(params)
        if copies and at != len(copies):
            raise ValueError(f"model_params has {len(copies)} tensors for "
                             f"{at} parameters")
        return loss
