"""The legacy loss scalers, as ``apex_tpu/fp16_utils/loss_scaler.py`` (the
reference's ``apex/fp16_utils/loss_scaler.py``): the static
:class:`LossScaler` and :class:`DynamicLossScaler`, whose legacy defaults
(init ``2**32``, factor 2, window 1000, the ``max(scale / factor, 1)``
floor) differ from amp's scaler on purpose.

They keep their state on the host, as the originals do: the scale is a
Python float and :meth:`DynamicLossScaler.update_scale` takes a host
boolean.  :meth:`DynamicLossScaler.has_overflow` is one K15 launch over
the whole gradient list on the card
(:func:`~apex_tpu_torch.ops.cuda.finite.all_finite_packed`) and then one
host read of its flag.  New code should use
:class:`apex_tpu_torch.amp.LossScaler`, whose state stays on the device.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from apex_tpu_torch.ops.cuda.finite import all_finite_packed


class LossScaler:
    """Static loss scaler: the scale never moves and nothing overflows."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = float(scale)

    def has_overflow(self, params) -> bool:
        return False

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def scale_gradient(self, grads: Iterable[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each gradient times the scale, as new tensors."""
        return [g * self.loss_scale for g in grads]

    def backward(self, loss: torch.Tensor, retain_graph: bool = False
                 ) -> None:
        """``(loss.float() * scale).backward()``: the gradients of the
        scaled loss land in the parameters' ``.grad``."""
        (loss.float() * self.loss_scale).backward(retain_graph=retain_graph)

    def update_scale(self, overflow: bool) -> None:
        pass


class DynamicLossScaler(LossScaler):
    """Dynamic legacy scaler: halve on overflow (never below 1), double
    after ``scale_window`` clean iterations since the last overflow."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.cur_iter = 0
        self.last_overflow_iter = -1

    def has_overflow(self, grads: Iterable[Optional[torch.Tensor]]) -> bool:
        """Whether any gradient holds a non-finite value (``None`` entries
        are skipped): one K15 launch over the list on the card, its plain
        version on the CPU, then one host read."""
        present = [g for g in grads if g is not None]
        if not present:
            return False
        return not bool(all_finite_packed(present))

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) \
                % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1


__all__ = ["DynamicLossScaler", "LossScaler"]
