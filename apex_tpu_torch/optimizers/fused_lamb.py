"""FusedLAMB, as ``apex_tpu/optimizers/fused_lamb.py``: the layer-wise
adaptive large-batch optimizer in two fused stages over the whole tree.

One update (:func:`lamb_step`) is three kernel launches over a
:class:`~apex_tpu_torch.ops.multi_tensor.ChunkTable` of the leaves, on
the card:

1. K9 ``packed_sumsq``: the global sum of squares of the gradients (only
   with a clip, ``max_grad_norm > 0``);
2. K7 ``lamb_stage1``: the clip factor ``1 / max(||g|| / max_grad_norm,
   1)`` formed on the device, both moments, the update ``u = m_hat /
   (sqrt(v_hat) + eps) + weight_decay * p`` with per-leaf bias
   correction, and per-chunk ``||p||^2`` / ``||u||^2`` partials;
3. K8 ``lamb_stage2``: per leaf the trust ratio ``lr * ||p|| / ||u||``
   (``lr`` when either norm is 0) and ``p -= ratio * u``, with the bf16
   compute copy written in the same pass.

Weight decay applies to every leaf, as in the JAX package.  Each leaf
carries its own step count (the JAX ``leaf_step``) beside the global
``step``; both advance by a device expression of the amp overflow flag
(``noop_flag``), and the kernels read that flag on the card, so a
skipped step needs no host sync.  Parameters and moments are updated in
place; the update ``u`` lives in one fp32 scratch buffer.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device
from apex_tpu_torch.ops.cuda import lamb_stage1, lamb_stage2, packed_sumsq
from apex_tpu_torch.ops.multi_tensor import ChunkTable


def bias_corrections(beta1: float, beta2: float, steps: torch.Tensor,
                     bias_correction: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(1 - beta1^t, 1 - beta2^t)`` for each count in ``steps``
    (ones without bias correction)."""
    t = steps.float()
    if not bias_correction:
        return torch.ones_like(t), torch.ones_like(t)
    b1 = torch.tensor(beta1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(beta2, dtype=torch.float32, device=t.device)
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def lamb_step(table: ChunkTable, p: Sequence[torch.Tensor],
              g: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
              v: Sequence[torch.Tensor], u: Sequence[torch.Tensor],
              leaf_steps: torch.Tensor, *, lr: float, beta1: float = 0.9,
              beta2: float = 0.999, eps: float = 1e-6,
              weight_decay: float = 0.01, max_grad_norm: float = 1.0,
              bias_correction: bool = True,
              noop_flag: Optional[torch.Tensor] = None,
              p_copy: Optional[Sequence[torch.Tensor]] = None) -> None:
    """One LAMB update of the table's leaves, in place: ``p`` (fp32
    masters, or bf16 parameters), their gradients ``g`` (fp32 or p's
    dtype, already unscaled), fp32 moments ``m`` / ``v``, fp32 scratch
    ``u``, the int32 per-leaf step counts ``leaf_steps`` (advanced here,
    by 1 or by ``noop_flag == 0``) and, when given, the bf16 compute
    copies ``p_copy``.  The kernels on the card, their plain versions on
    the CPU."""
    if noop_flag is None:
        leaf_steps += 1
    else:
        leaf_steps += (noop_flag.reshape(()) == 0).to(torch.int32)
    bc1, bc2 = bias_corrections(beta1, beta2, leaf_steps, bias_correction)
    sumsq = packed_sumsq(table, g) if max_grad_norm > 0 else None
    p_sq, u_sq = lamb_stage1(table, p, g, m, v, u, bc1, bc2, sumsq,
                             noop_flag, beta1=beta1, beta2=beta2, eps=eps,
                             weight_decay=weight_decay,
                             max_grad_norm=max_grad_norm)
    lamb_stage2(table, p, u, p_sq, u_sq, noop_flag, lr=lr, p_copy=p_copy)


class FusedLAMB(torch.optim.Optimizer):
    """LAMB over fp32 (master) tensors with the JAX package's constructor.

    ``step(noop_flag=None, model_params=None)`` as
    :class:`~apex_tpu_torch.optimizers.FusedAdam`'s: ``noop_flag`` (one
    int32 on the parameters' device) makes the whole step conditional on
    the card; ``model_params`` (one bf16 tensor per parameter, in order)
    get the bf16 copy of each new parameter in stage 2.  Gradients are
    the parameters' ``.grad``.  One parameter group: the global-norm clip
    and the one-launch kernels span the whole tree, as JAX's
    ``fused_lamb`` does.  The parameters must lie on ``device`` (the card
    by default; ``device="cpu"`` runs the plain versions)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0, device: DeviceLike = None):
        device = resolve_device(device)
        defaults = dict(lr=lr, bias_correction=bias_correction,
                        betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                if not same_device(p.device, device):
                    raise ValueError(f"FusedLAMB: a parameter is on "
                                     f"{p.device}, not {device}")
        self._table: Optional[ChunkTable] = None
        self._u: List[torch.Tensor] = []

    @property
    def table(self) -> Optional[ChunkTable]:
        """The chunk table of the last step (``None`` before the first)."""
        return self._table

    def _tree(self, params: List[torch.Tensor]) -> ChunkTable:
        """The chunk table and update scratch of ``params``, built anew
        when the leaves' sizes or device change (the pointer rows follow
        the tensors' storage on their own)."""
        t = self._table
        if t is None or not t.fits(params) or t.device != params[0].device:
            t = ChunkTable.of(params)
            _, self._u = t.flat_views([p.shape for p in params])
            self._table = t
        return t

    def _leaf_steps(self, group) -> torch.Tensor:
        """The group's per-leaf step counts, one int32 vector; each
        parameter's ``state['step']`` is a 0-dim view into it.  A
        parameter seen for the first time starts at 0 with zero
        moments."""
        params = group["params"]
        steps = group.get("leaf_steps")
        if steps is not None and steps.numel() == len(params) and all(
                p in self.state for p in params):
            return steps
        dev = params[0].device
        steps = torch.zeros(len(params), dtype=torch.int32, device=dev)
        for i, p in enumerate(params):
            st = self.state[p]
            if "step" in st:
                steps[i] = st["step"]
            else:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            st["step"] = steps[i]
        group["leaf_steps"] = steps
        group.setdefault("step", torch.zeros((), dtype=torch.int32,
                                             device=dev))
        return steps

    @torch.no_grad()
    def step(self, closure=None, *, noop_flag: Optional[torch.Tensor] = None,
             model_params: Optional[Sequence[torch.Tensor]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if len(self.param_groups) != 1:
            raise ValueError("FusedLAMB takes one parameter group (the clip "
                             "and the kernels span the whole tree)")
        group = self.param_groups[0]
        params = group["params"]
        if not params:
            return loss
        if any(p.grad is None for p in params):
            raise RuntimeError("FusedLAMB: a parameter has no grad (every "
                               "leaf steps, as in the JAX optimizer)")
        copies = list(model_params) if model_params is not None else None
        if copies is not None and len(copies) != len(params):
            raise ValueError(f"model_params has {len(copies)} tensors for "
                             f"{len(params)} parameters")
        table = self._tree(params)
        steps = self._leaf_steps(group)
        group["step"] += 1 if noop_flag is None else \
            (noop_flag.reshape(()) == 0).to(torch.int32)
        states = [self.state[p] for p in params]
        beta1, beta2 = group["betas"]
        lamb_step(table, params, [p.grad.contiguous() for p in params],
                  [st["exp_avg"] for st in states],
                  [st["exp_avg_sq"] for st in states], self._u, steps,
                  lr=group["lr"], beta1=beta1, beta2=beta2,
                  eps=group["eps"], weight_decay=group["weight_decay"],
                  max_grad_norm=group["max_grad_norm"],
                  bias_correction=group["bias_correction"],
                  noop_flag=noop_flag, p_copy=copies)
        return loss
