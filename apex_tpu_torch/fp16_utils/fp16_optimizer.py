"""The legacy master-weight wrapper, as ``apex_tpu/fp16_utils/
fp16_optimizer.py`` (the reference's ``apex/fp16_utils/fp16_optimizer.py``,
``FP16_Optimizer``, with its ``optimizer.backward(loss)`` API).

:class:`FP16Optimizer` wraps **any** ``torch.optim.Optimizer`` built over
a (half) model's parameters: it makes fp32 master clones of them, moves
the optimizer's parameter groups onto the masters (the reference's
master swap), and after each inner step copies the masters back into the
model's parameters.  The JAX package's method names stay:
:meth:`~FP16Optimizer.backward`, :meth:`~FP16Optimizer.
update_master_grads` (the unscale into the masters' gradients: one K6
launch over the chunk table with one device flag, as amp's scaler),
:meth:`~FP16Optimizer.clip_master_grads` (K9 through
:func:`~apex_tpu_torch.fp16_utils.clip_grad_norm`), :meth:`~FP16Optimizer.
step`, :meth:`~FP16Optimizer.step_with_closure`, :meth:`~FP16Optimizer.
state_dict` and :meth:`~FP16Optimizer.load_state_dict`.  The scaler is
amp's (:class:`apex_tpu_torch.amp.LossScaler`: a static scale, or with
``dynamic_loss_scale`` init ``init_scale`` and window ``scale_window``),
its state on the device.

An overflow skips the inner step and moves the scaler as amp's
``update`` does.  The JAX package gates the step with ``lax.cond``; a
generic ``torch.optim`` step cannot read a device flag, so for such an
inner optimizer the wrapper reads the flag on the host once a step, as
the reference's ``FP16_Optimizer`` did.  An inner optimizer whose
``step`` takes ``noop_flag`` (the port's
:class:`~apex_tpu_torch.optimizers.FusedAdam`) gets the flag on the
device, writes the half copies in its own pass (``model_params``), and
nothing is read back.

This is not :class:`apex_tpu_torch.optimizers.FP16Optimizer`, the
flat-buffer optimizer of the reference's ``apex/optimizers``.
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState
from apex_tpu_torch.fp16_utils.fp16util import clip_grad_norm


class FP16Optimizer:
    """Master-weight wrapper around ``init_optimizer`` (built over the
    model's parameters, not stepped yet).

    Attributes: ``optimizer`` (the inner one, now over the masters),
    ``model_params`` (the model's parameters, in the optimizer's order),
    ``master_params`` (their fp32 clones, likewise), ``scaler`` and
    ``scaler_state``."""

    def __init__(self, init_optimizer: torch.optim.Optimizer,
                 static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 scale_window: int = 1000, init_scale: float = 2.0 ** 16):
        self.optimizer = init_optimizer
        self.model_params: List[torch.Tensor] = []
        self.master_params: List[torch.Tensor] = []
        with torch.no_grad():
            for group in init_optimizer.param_groups:
                masters = []
                for p in group["params"]:
                    if init_optimizer.state.get(p):
                        raise ValueError("FP16Optimizer wraps an optimizer "
                                         "that has not stepped yet")
                    m = p.detach().to(torch.float32, copy=True)
                    self.model_params.append(p)
                    self.master_params.append(m)
                    masters.append(m)
                group["params"] = masters
        if not self.model_params:
            raise ValueError("the optimizer holds no parameters")
        if dynamic_loss_scale:
            self.scaler = LossScaler(loss_scale="dynamic",
                                     init_scale=init_scale,
                                     scale_window=scale_window)
        else:
            self.scaler = LossScaler(loss_scale=float(static_loss_scale))
        self.scaler_state: LossScaleState = self.scaler.init_state(
            self.master_params[0].device)
        self._grads: Optional[List[torch.Tensor]] = None
        #: whether the inner step takes a device skip flag
        self._takes_flag = "noop_flag" in inspect.signature(
            init_optimizer.step).parameters

    @property
    def loss_scale(self) -> torch.Tensor:
        """The current scale (fp32, 0-dim, on the device)."""
        return self.scaler_state.loss_scale

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        return self.scaler.scale_loss(loss, self.scaler_state)

    def backward(self, loss: torch.Tensor,
                 retain_graph: bool = False) -> torch.Tensor:
        """The backward of the scaled loss: the model's parameters get
        their (scaled, half) gradients in ``.grad``; returns ``loss``."""
        self.scale_loss(loss).backward(retain_graph=retain_graph)
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the model's gradients (the masters' are set per step)."""
        for p in self.model_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def _master_grad_buffers(self) -> List[torch.Tensor]:
        """fp32 gradient buffers beside the masters, kept from step to
        step (the unscale's outputs: one chunk table, pointers that do
        not move)."""
        if self._grads is None:
            self._grads = [torch.empty_like(m) for m in self.master_params]
        return self._grads

    @torch.no_grad()
    def update_master_grads(self, model_grads: Optional[
            Sequence[torch.Tensor]] = None
    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The model's gradients (``model_grads``, one per parameter in
        :attr:`model_params`' order, by default their ``.grad``; a missing
        one counts as zeros) unscaled into fp32 master gradients:
        ``(master_grads, finite)``, ``finite`` a 0-dim bool on the device,
        checked on the scaled values.  One K6 launch on the card."""
        if model_grads is None:
            model_grads = [p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for p in self.model_params]
        if len(model_grads) != len(self.model_params):
            raise ValueError(f"{len(model_grads)} gradients for "
                             f"{len(self.model_params)} parameters")
        grads, flag = self.scaler.unscale(
            list(model_grads), self.scaler_state,
            out=self._master_grad_buffers())
        return grads, (flag == 0).reshape(())

    @torch.no_grad()
    def clip_master_grads(self, master_grads: Sequence[torch.Tensor],
                          max_norm: float, norm_type: float = 2.0
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Global-norm clip of the fp32 master gradients: ``(clipped,
        norm)`` (the 2-norm by K9)."""
        return clip_grad_norm(list(master_grads), max_norm, norm_type)

    @torch.no_grad()
    def step(self, model_grads: Optional[Sequence[torch.Tensor]] = None,
             clip_norm: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Unscale, clip (with ``clip_norm``), update the scaler, then the
        inner step on the masters unless the gradients overflowed, and
        the masters copied into the model's parameters.  Returns device
        tensors ``overflow`` (0-dim bool) and ``loss_scale`` (after the
        update)."""
        master_grads, finite = self.update_master_grads(model_grads)
        if clip_norm is not None:
            master_grads, _ = self.clip_master_grads(master_grads,
                                                     clip_norm)
        self.scaler_state, overflow = self.scaler.update(self.scaler_state,
                                                         finite)
        for m, g in zip(self.master_params, master_grads):
            m.grad = g
        if self._takes_flag:
            self.optimizer.step(noop_flag=overflow.to(torch.int32)
                                .reshape(1), model_params=self.model_params)
        elif not bool(overflow):
            # a generic optimizer's step cannot read a device flag
            self.optimizer.step()
            torch._foreach_copy_(self.model_params, self.master_params)
        for m in self.master_params:
            m.grad = None
        return {"overflow": overflow,
                "loss_scale": self.scaler_state.loss_scale}

    def step_with_closure(self, closure: Callable[[], torch.Tensor],
                          clip_norm: Optional[float] = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``loss = closure()`` (the forward), its scaled backward and
        :meth:`step`, once: ``(loss, info)``.  The model's gradients are
        cleared first."""
        self.zero_grad()
        with torch.enable_grad():
            loss = self.backward(closure())
        return loss, self.step(clip_norm=clip_norm)

    def state_dict(self) -> Dict[str, Any]:
        """The fp32 masters, the inner optimizer's state, and the scaler
        state (``loss_scale``, ``unskipped``)."""
        return {"master_params": [m.detach().clone()
                                  for m in self.master_params],
                # the inner state dict holds the live tensors
                "opt_state": copy.deepcopy(self.optimizer.state_dict()),
                "loss_scale": self.scaler_state.loss_scale.clone(),
                "unskipped": self.scaler_state.unskipped.clone()}

    @torch.no_grad()
    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict`'s fields; the model's parameters
        take the restored masters."""
        if len(d["master_params"]) != len(self.master_params):
            raise ValueError(f"{len(d['master_params'])} masters for "
                             f"{len(self.master_params)} parameters")
        for m, saved in zip(self.master_params, d["master_params"]):
            m.copy_(saved)
        self.optimizer.load_state_dict(copy.deepcopy(d["opt_state"]))
        dev = self.master_params[0].device
        self.scaler_state = LossScaleState(
            torch.as_tensor(d["loss_scale"], dtype=torch.float32)
            .to(dev).reshape(()),
            torch.as_tensor(d["unskipped"], dtype=torch.int32)
            .to(dev).reshape(()))
        torch._foreach_copy_(self.model_params, self.master_params)


#: the reference's spelling
FP16_Optimizer = FP16Optimizer

__all__ = ["FP16Optimizer", "FP16_Optimizer"]
