"""Dynamic loss scaling on the device, as ``apex_tpu/amp/scaler.py``.

The scale, the good-step counter and the overflow flag are device
tensors, and every transition is tensor arithmetic: nothing here reads a
value back to the host, so a train step makes no host sync.  The unscale
runs the K6 kernel (:func:`apex_tpu_torch.ops.cuda.packed_scale`) on the
card, one launch per gradient into one shared flag.

Semantics as the reference's: a dynamic scale starts at ``2**16``,
doubles after ``scale_window`` (2000) overflow-free steps, halves on
overflow, and stays within ``[min_loss_scale (1.0 by default),
max_loss_scale (2**24)]``; a static scale never moves, but an overflow
still skips the step.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.amp.policy import DYNAMIC
from apex_tpu_torch.ops.cuda import packed_scale


class LossScaleState(NamedTuple):
    """Device-side scaler state: ``loss_scale`` fp32 and ``unskipped``
    int32 (consecutive overflow-free steps), both 0-dim."""

    loss_scale: torch.Tensor
    unskipped: torch.Tensor


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-dim bool: every element of every floating tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors
             if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Configuration and state transitions; ``loss_scale="dynamic"``
    selects dynamic scaling, a number a static scale."""

    loss_scale: Union[float, str] = DYNAMIC
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_loss_scale: Optional[float] = None
    max_loss_scale: float = 2.0 ** 24

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == DYNAMIC

    def init_state(self, device=None) -> LossScaleState:
        scale = self.init_scale if self.dynamic else float(self.loss_scale)
        return LossScaleState(
            loss_scale=torch.tensor(scale, dtype=torch.float32,
                                    device=device),
            unskipped=torch.tensor(0, dtype=torch.int32, device=device))

    @property
    def floor(self) -> float:
        """The least dynamic scale: ``min_loss_scale`` or 1.0."""
        return self.min_loss_scale if self.min_loss_scale is not None \
            else 1.0

    def pinned_at_floor(self, state: LossScaleState) -> torch.Tensor:
        """0-dim bool: the dynamic scale sits at its floor, so the next
        overflow cannot shrink it (always False for a static scale)."""
        if not self.dynamic:
            return torch.zeros((), dtype=torch.bool,
                               device=state.loss_scale.device)
        return state.loss_scale <= self.floor

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScaleState) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        return loss.float() * state.loss_scale

    def unscale(self, grads: Sequence[torch.Tensor], state: LossScaleState,
                out_dtype: torch.dtype = torch.float32,
                out: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``g.float() * (1 / scale)`` cast to ``out_dtype`` for each
        gradient (into ``out``, one tensor per gradient, when given), and
        one int32 flag ``(1,)``: nonzero when any incoming (still scaled)
        gradient holds a non-finite value.  On the card, one K6 launch per
        gradient, all into the same flag."""
        dev = state.loss_scale.device
        inv = (1.0 / state.loss_scale).reshape(1)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        outs = [None] * len(grads) if out is None else list(out)
        if len(outs) != len(grads):
            raise ValueError(f"{len(outs)} out tensors for {len(grads)} "
                             f"gradients")
        res = [packed_scale(g, inv, out_dtype, flag, o)
               for g, o in zip(grads, outs)]
        return res, flag

    def update(self, state: LossScaleState, grads_finite: torch.Tensor
               ) -> Tuple[LossScaleState, torch.Tensor]:
        """The post-backward transition; returns ``(new_state,
        overflow)``, ``overflow`` a 0-dim bool device tensor (the step
        must be skipped)."""
        overflow = torch.logical_not(grads_finite.reshape(()))
        if not self.dynamic:
            return state, overflow
        scale = state.loss_scale
        shrunk = torch.clamp(scale / self.scale_factor, min=self.floor)
        unskipped = torch.where(overflow, torch.zeros_like(state.unskipped),
                                state.unskipped + 1)
        window_hit = unskipped >= self.scale_window
        grown = torch.clamp(scale * self.scale_factor,
                            max=self.max_loss_scale)
        new_scale = torch.where(overflow, shrunk,
                                torch.where(window_hit, grown, scale))
        unskipped = torch.where(window_hit, torch.zeros_like(unskipped),
                                unskipped)
        return LossScaleState(new_scale, unskipped), overflow
