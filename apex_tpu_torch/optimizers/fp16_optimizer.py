"""The flat-buffer FP16 optimizer, as ``apex_tpu/optimizers/
fp16_optimizer.py`` (the reference's fused ``FP16_Optimizer``): one flat
fp32 master, m and v for the whole model, and one fused Adam pass a step.

At construction the model's parameters are copied into one flat fp32
master, and each parameter becomes a view into one flat half buffer (the
reference's re-aliasing): the model computes in half precision on those
views, and the Adam pass writes the new half copy straight into them.

A step takes the *scaled* half gradients (one per parameter, in order):

1. they are copied into one kept flat fp32 buffer (a plain copy; the JAX
   package's is an XLA concat);
2. K9 takes their global sum of squares over a one-leaf chunk table;
3. the loss scale and the ``max_grad_norm`` clip fold into one
   ``combined_scale`` on the device;
4. K5 makes one Adam pass over the flat buffers with the half copy,
   conditional on the non-finite flag of that sum;
5. the optimizer's own loss scaler (dynamic: from ``2**16``, window 1000;
   or static) takes its step.

Nothing is read back to the host: ``overflow``, ``loss_scale`` and
``grad_norm`` come back as device tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState
from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device
from apex_tpu_torch.ops.cuda import packed_adam, packed_sumsq
from apex_tpu_torch.ops.cuda.adam import EPS_MODE_INSIDE, EPS_MODE_OUTSIDE
from apex_tpu_torch.ops.multi_tensor import ChunkTable
from apex_tpu_torch.optimizers.fused_adam import bias_corrected_step_sizes


class FP16Optimizer:
    """Fused flat-buffer FP16 optimizer over ``params`` (the model's fp32
    parameters, or the model), with the JAX package's constructor.

    ``opt.step(model_grads) -> {"overflow", "loss_scale", "grad_norm"}``
    from the scaled half gradients of :attr:`model_params`; scale the
    loss with :meth:`scale_loss` first.  The parameters must lie on
    ``device`` (the card by default; ``device="cpu"`` runs the plain
    versions)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, eps_inside_sqrt: bool = False,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 max_grad_norm: float = 0.0,
                 model_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        device = resolve_device(device)
        if isinstance(params, nn.Module):
            params = params.parameters()
        self._params: List[torch.Tensor] = list(params)
        if not self._params:
            raise ValueError("FP16Optimizer: no parameters")
        for p in self._params:
            if not same_device(p.device, device):
                raise ValueError(f"FP16Optimizer: a parameter is on "
                                 f"{p.device}, not {device}")
            if not p.is_floating_point():
                raise TypeError(f"FP16Optimizer: a {p.dtype} parameter")
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.eps_mode = EPS_MODE_INSIDE if eps_inside_sqrt \
            else EPS_MODE_OUTSIDE
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.max_grad_norm = max_grad_norm
        self.model_dtype = model_dtype
        self.scaler = (LossScaler(loss_scale="dynamic", init_scale=2.0 ** 16,
                                  scale_window=1000)
                       if dynamic_loss_scale
                       else LossScaler(loss_scale=static_loss_scale))
        dev = self._params[0].device
        self._shapes = [p.shape for p in self._params]
        self._sizes = [p.numel() for p in self._params]
        with torch.no_grad():
            self.master = torch.cat([p.detach().reshape(-1).float()
                                     for p in self._params])
            self.m = torch.zeros_like(self.master)
            self.v = torch.zeros_like(self.master)
            self._flat_grad = torch.empty_like(self.master)
            self._flat_half = self.master.to(model_dtype)
            # the model's parameters become views into the flat half copy
            for p, view in zip(self._params, self._views(self._flat_half)):
                p.data = view
        self.step_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.scaler_state: LossScaleState = self.scaler.init_state(dev)
        self._table = ChunkTable([self.master.numel()], dev)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view(s) for v, s in
                zip(flat.split(self._sizes), self._shapes)]

    @property
    def model_params(self) -> List[torch.Tensor]:
        """The model's half parameters (views into one flat buffer)."""
        return self._params

    @property
    def loss_scale(self) -> torch.Tensor:
        return self.scaler_state.loss_scale

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        return self.scaler.scale_loss(loss, self.scaler_state)

    def master_params(self) -> List[torch.Tensor]:
        """The fp32 masters, as views of the flat master in the
        parameters' shapes."""
        return self._views(self.master)

    @torch.no_grad()
    def step(self, model_grads: Iterable[torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """One fused update from the scaled half gradients of
        :attr:`model_params`, in order."""
        grads = list(model_grads)
        if len(grads) != len(self._params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self._params)} parameters")
        torch.cat([g.reshape(-1) for g in grads], out=self._flat_grad)
        sumsq = packed_sumsq(self._table, [self._flat_grad])
        grad_norm = torch.sqrt(sumsq)
        finite = torch.isfinite(sumsq).reshape(())
        scale = self.scaler_state.loss_scale.reshape(1)
        combined = scale
        if self.max_grad_norm and self.max_grad_norm > 0:
            # an unscaled norm above max_grad_norm grows the descale
            # divisor (the reference folds the clip into combined_scale)
            clip = (grad_norm / scale) / self.max_grad_norm
            combined = torch.where(clip > 1.0, scale * clip, scale)
        step = self.step_count + 1
        step_size = bias_corrected_step_sizes(
            self.lr, self.beta1, self.beta2, step.reshape(1),
            self.bias_correction)
        noop = torch.logical_not(finite).to(torch.int32).reshape(1)
        packed_adam(self.master, self.m, self.v, self._flat_grad, step_size,
                    combined, noop, beta1=self.beta1, beta2=self.beta2,
                    eps=self.eps, weight_decay=self.weight_decay,
                    eps_mode=self.eps_mode, p_copy=self._flat_half)
        self.scaler_state, overflow = self.scaler.update(self.scaler_state,
                                                         finite)
        self.step_count = torch.where(overflow, self.step_count, step)
        return {"overflow": overflow, "loss_scale": self.scaler_state
                .loss_scale, "grad_norm": grad_norm.reshape(())}

    # -- checkpointing (the JAX package's state_dict / load_state_dict) --
    def state_dict(self) -> dict:
        return {"master": self.master, "m": self.m, "v": self.v,
                "step": self.step_count,
                "loss_scale": self.scaler_state.loss_scale,
                "unskipped": self.scaler_state.unskipped}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        """Load a :meth:`state_dict`; the model's half parameters are
        refreshed from the loaded master."""
        for name in ("master", "m", "v"):
            getattr(self, name).copy_(torch.as_tensor(d[name]).reshape(-1))
        self._flat_half.copy_(self.master)
        dev = self.master.device
        self.step_count = torch.as_tensor(d["step"], dtype=torch.int32) \
            .to(dev).reshape(())
        self.scaler_state = LossScaleState(
            loss_scale=torch.as_tensor(d["loss_scale"], dtype=torch.float32)
            .to(dev).reshape(()),
            unskipped=torch.as_tensor(d["unskipped"], dtype=torch.int32)
            .to(dev).reshape(()))
