"""FusedAdam, as ``apex_tpu/optimizers/fused_adam.py``: Adam with the
descale, both moments and the update fused into one pass.

Two surfaces: :func:`adam_step`, the raw update of one leaf (K5,
:func:`apex_tpu_torch.ops.cuda.packed_adam`, on the card), and
:class:`FusedAdam`, a ``torch.optim.Optimizer`` over fp32 (master)
tensors whose step is one K11 launch per parameter group and dtype
(:func:`apex_tpu_torch.ops.cuda.packed_adam_tree`, over a chunk table of
the group's leaves: the reference's one ``multi_tensor_apply`` launch).
Bias correction is per leaf: each parameter carries its own step count
(the reference's per-param ``state['step']``, the JAX package's
``leaf_step``), and ``step_size = lr * sqrt(1 - b2^t) / (1 - b1^t)`` is
computed in fp32 on the device for every leaf at once; K11 reads each
leaf's own.  A step can be made conditional on a device flag
(``noop_flag``, the amp overflow flag): the kernels and the step counts
read it on the card, so a skipped step needs no host sync.  Parameters
are updated in place.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch

from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device
from apex_tpu_torch.ops.cuda import packed_adam, packed_adam_tree
from apex_tpu_torch.ops.cuda.adam import EPS_MODE_INSIDE, EPS_MODE_OUTSIDE
from apex_tpu_torch.ops.multi_tensor import ChunkTable, group_by_dtype


def bias_corrected_step_sizes(lr: float, beta1: float, beta2: float,
                              steps: torch.Tensor,
                              bias_correction: bool = True) -> torch.Tensor:
    """fp32 ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` for each count in
    ``steps`` (or ``lr`` without bias correction)."""
    t = steps.float()
    if not bias_correction:
        return torch.full_like(t, lr)
    # made on the device: a host scalar copied up would wait for the stream
    b1 = torch.full((), beta1, dtype=torch.float32, device=t.device)
    b2 = torch.full((), beta2, dtype=torch.float32, device=t.device)
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
    Each parameter group steps in one K11 launch over a chunk table kept
    from step to step, one launch for each pair of parameter and gradient
    dtypes it holds (a gradient is fp32 or its parameter's dtype; O3 with
    an fp32-kept normalization leaf mixes bf16 and fp32 parameters).  The
    parameters must lie on
    ``device`` (the card by default; pass ``device="cpu"`` for the plain
    versions)."""

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
        #: (group index, parameter and gradient dtypes) -> the chunk
        #: table of those leaves
        self._tables: Dict[tuple, ChunkTable] = {}

    @property
    def tables(self) -> List[ChunkTable]:
        """The chunk tables of the last steps (for their row counters)."""
        return list(self._tables.values())

    def _group_steps(self, group) -> torch.Tensor:
        """The group's per-leaf step counts, one int32 vector; each
        parameter's ``state['step']`` is a 0-dim view into it.  A
        parameter seen for the first time (a group grown by
        ``Amp.add_params``) starts at 0 with zero moments; the others
        keep theirs."""
        params = group["params"]
        steps = group.get("leaf_steps")
        if steps is not None and steps.numel() == len(params) and all(
                p in self.state for p in params):
            return steps
        steps = torch.zeros(len(params), dtype=torch.int32,
                            device=params[0].device)
        for i, p in enumerate(params):
            st = self.state[p]
            if "step" in st:
                steps[i] = st["step"]
            else:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            st["step"] = steps[i]
        group["leaf_steps"] = steps
        return steps

    @torch.no_grad()
    def init_state(self) -> None:
        """Make every parameter's moments and step count now (zeros and 0
        for a new one, as the first step would), so that a checkpoint can
        name them before the first step."""
        for group in self.param_groups:
            if group["params"]:
                self._group_steps(group)

    def schedule_step(self) -> torch.Tensor:
        """The updates applied so far (the JAX package's global
        ``FusedAdamState.step``): the largest per-leaf count, since a
        leaf added mid-run counts from 0.  A new 0-dim int32 tensor."""
        self.init_state()
        counts = [g["leaf_steps"].max() for g in self.param_groups
                  if g["params"]]
        return torch.stack(counts).max()

    def _table(self, key, params: List[torch.Tensor]) -> ChunkTable:
        """The chunk table of ``key`` (a group and a dtype pair), built
        anew when its leaves' sizes or device change."""
        table = self._tables.get(key)
        if table is None or not table.fits(params) \
                or table.device != params[0].device:
            table = self._tables[key] = ChunkTable.of(params)
        return table

    @torch.no_grad()
    def step(self, closure=None, *, noop_flag: Optional[torch.Tensor] = None,
             model_params: Optional[Sequence[torch.Tensor]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        copies: Optional[List[torch.Tensor]] = (
            list(model_params) if model_params is not None else None)
        n_params = sum(len(g["params"]) for g in self.param_groups)
        if copies is not None and len(copies) != n_params:
            raise ValueError(f"model_params has {len(copies)} tensors for "
                             f"{n_params} parameters")
        at = 0
        for gi, group in enumerate(self.param_groups):
            params = group["params"]
            if not params:
                continue
            if any(p.grad is None for p in params):
                raise RuntimeError("FusedAdam: a parameter has no grad "
                                   "(every leaf steps, as in the JAX "
                                   "optimizer)")
            grads = [p.grad.contiguous() for p in params]
            # one launch per (parameter, gradient) dtype pair: O3 with an
            # fp32-kept normalization leaf mixes bf16 and fp32 parameters
            subsets = group_by_dtype([(p.dtype, g.dtype)
                                      for p, g in zip(params, grads)])
            steps = self._group_steps(group)
            if noop_flag is None:
                steps += 1
            else:
                steps += (noop_flag.reshape(()) == 0).to(torch.int32)
            beta1, beta2 = group["betas"]
            sizes = bias_corrected_step_sizes(
                group["lr"], beta1, beta2, steps, group["bias_correction"])
            # the gradients arrive unscaled (amp's unscale ran first)
            one = torch.ones(1, dtype=torch.float32, device=params[0].device)
            gcopies = None if copies is None else copies[at:at + len(params)]
            for key, idx in subsets.items():
                ps = [params[i] for i in idx]
                cs = None if gcopies is None else [gcopies[i] for i in idx]
                # the kernel writes copies of one half dtype (bf16 or
                # fp16); where other dtypes are among them (an fp32
                # normalization parameter kept beside its master), every
                # copy is the new parameter, copied after
                in_kernel = cs is not None and len(
                    {c.dtype for c in cs}) == 1 and cs[0].dtype in (
                        torch.bfloat16, torch.float16)
                packed_adam_tree(
                    self._table((gi,) + key, ps), ps,
                    [self.state[p]["exp_avg"] for p in ps],
                    [self.state[p]["exp_avg_sq"] for p in ps],
                    [grads[i] for i in idx],
                    sizes if len(subsets) == 1 else sizes[idx], one,
                    noop_flag, beta1=beta1, beta2=beta2, eps=group["eps"],
                    weight_decay=group["weight_decay"],
                    eps_mode=group["eps_mode"],
                    p_copy=cs if in_kernel else None)
                if cs is not None and not in_kernel:
                    torch._foreach_copy_(cs, ps)
            at += len(params)
        return loss
