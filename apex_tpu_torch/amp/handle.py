"""The module-level ``scale_loss`` and the legacy ``init`` handle API, as
``apex_tpu/amp/handle.py``.

- :func:`scale_loss` scales a loss by the most recently initialized
  :class:`~apex_tpu_torch.amp.Amp` (:func:`active_amp`, the reference's
  ``_amp_state`` global) or by the one passed; the unscale, overflow check,
  scaler update and conditional step that the reference's context manager
  runs at exit are :meth:`Amp.apply_gradients` (or the multi-loss pieces).
- ``handle = init(...)`` turns the O1 op-cast policy on for the calling
  thread until ``handle._deactivate()``; ``handle.wrap_optimizer(model,
  optimizer)`` binds them to an :class:`Amp` under the handle's policy.
  The port's :class:`Amp` casts the model it binds, so ``wrap_optimizer``
  takes the model as well as the optimizer.  There is no cast cache to
  clear: each cast is an autograd op of its step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.amp import policy as policy_lib
from apex_tpu_torch.amp.frontend import Amp
from apex_tpu_torch.amp.scaler import LossScaler

_active_amp: Optional[Amp] = None


def _set_active_amp(a: Optional[Amp]) -> None:
    global _active_amp
    _active_amp = a


def active_amp() -> Optional[Amp]:
    """The :class:`Amp` of the most recent ``initialize`` call, if any."""
    return _active_amp


def scale_loss(loss: torch.Tensor, amp: Optional[Amp] = None,
               loss_id: int = 0) -> torch.Tensor:
    """``loss * loss_scale`` of scaler ``loss_id`` of ``amp`` (by default
    :func:`active_amp`): differentiate the result, then hand the
    gradients to :meth:`Amp.apply_gradients`."""
    a = amp if amp is not None else _active_amp
    if a is None:
        raise RuntimeError("amp.scale_loss called before amp.initialize")
    return a.scale_loss(loss, loss_id=loss_id)


class AmpHandle:
    """The legacy handle: construction turns the op-cast policy on (for
    the calling thread) until :meth:`_deactivate`."""

    def __init__(self, properties: policy_lib.Properties,
                 verbose: bool = False):
        self._properties = properties
        self._verbose = verbose
        self._all_wrappers = []
        self._ctx = None
        if properties.enabled and properties.cast_ops:
            self._ctx = amp_ops.cast_context(properties)
            self._ctx.__enter__()

    @property
    def is_active(self) -> bool:
        return self._properties.enabled

    @property
    def has_cache(self) -> bool:
        return False

    def wrap_optimizer(self, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       num_loss: int = 1) -> Amp:
        """``model`` and ``optimizer`` (built over its parameters) bound
        to an :class:`Amp` under the handle's policy, with ``num_loss``
        scalers."""
        a = Amp(model, optimizer, self._properties,
                LossScaler(loss_scale=self._properties.loss_scale),
                num_losses=num_loss)
        self._all_wrappers.append(a)
        return a

    def scale_loss(self, loss: torch.Tensor,
                   loss_id: int = 0) -> torch.Tensor:
        if not self.is_active:
            return loss
        if not self._all_wrappers:
            raise RuntimeError("wrap_optimizer before scale_loss")
        return self._all_wrappers[-1].scale_loss(loss, loss_id=loss_id)

    def _clear_cache(self) -> None:
        pass

    def _deactivate(self) -> None:
        """Turn the policy off and undo the ``register_*`` patches."""
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
        amp_ops.deactivate_registrations()


class NoOpHandle:
    """The handle of disabled amp."""

    @property
    def is_active(self) -> bool:
        return False

    @property
    def has_cache(self) -> bool:
        return False

    def wrap_optimizer(self, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       num_loss: int = 1) -> Amp:
        props = policy_lib.resolve(opt_level="O0", enabled=False)
        return Amp(model, optimizer, props, LossScaler(loss_scale=1.0),
                   num_losses=num_loss)

    def scale_loss(self, loss, loss_id: int = 0):
        return loss

    def _clear_cache(self) -> None:
        pass

    def _deactivate(self) -> None:
        pass


def init(enabled: bool = True, opt_level: str = "O1",
         half_dtype: torch.dtype = torch.bfloat16, loss_scale="dynamic",
         enable_caching: bool = True, verbose: bool = False):
    """Turn the op-cast policy on and return a handle (the reference's
    ``amp.init``); ``enable_caching`` is accepted for the signature.
    Prefer :func:`apex_tpu_torch.amp.initialize`."""
    if not enabled:
        return NoOpHandle()
    props = policy_lib.resolve(opt_level=opt_level, enabled=True,
                               half_dtype=half_dtype, loss_scale=loss_scale)
    return AmpHandle(props, verbose=verbose)
