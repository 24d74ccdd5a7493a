"""Dynamic loss scaling on the device, as ``apex_tpu/amp/scaler.py``.

The scale, the good-step counter and the overflow flag are device
tensors, and every transition is tensor arithmetic: nothing here reads a
value back to the host, so a train step makes no host sync.  The unscale
runs the K6 kernel (:func:`apex_tpu_torch.ops.cuda.packed_scale`) on the
card, the unscale onto stashed gradients K10
(:func:`apex_tpu_torch.ops.cuda.packed_axpby`), and the finite check of
unscaled gradients K15 (:func:`all_finite`), each one launch over the
whole tree.

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
from apex_tpu_torch.ops.cuda.finite import all_finite_packed
from apex_tpu_torch.ops.multi_tensor import (
    CHUNK_SIZE,
    multi_tensor_axpby,
    table_for,
)


class LossScaleState(NamedTuple):
    """Device-side scaler state: ``loss_scale`` fp32 and ``unskipped``
    int32 (consecutive overflow-free steps), both 0-dim."""

    loss_scale: torch.Tensor
    unskipped: torch.Tensor


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-dim bool: every element of every floating tensor is finite
    (integer tensors skipped; True for none).  On the card one K15 launch
    over the whole list (:func:`~apex_tpu_torch.ops.cuda.finite.
    all_finite_packed`), the leaves read in place in their own dtypes; on
    the CPU its plain version."""
    return all_finite_packed(tensors)


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
        gradient (into ``out``, one tensor per gradient, when given, each
        in its own dtype; ``out`` may be ``grads`` itself), and one int32
        flag ``(1,)``: nonzero when any incoming (still scaled) gradient
        holds a non-finite value.  On the card, one K6 launch over the
        chunk table of the gradients (:func:`~apex_tpu_torch.ops.
        multi_tensor.table_for`), whatever dtypes they mix.  A gradient
        that is not contiguous is read through a contiguous copy; ``out``
        must be contiguous (K6 refuses it otherwise).  Without ``out`` the
        results are views of one new buffer."""
        dev = state.loss_scale.device
        inv = (1.0 / state.loss_scale).reshape(1)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        if out is not None and len(out) != len(grads):
            raise ValueError(f"{len(out)} out tensors for {len(grads)} "
                             f"gradients")
        if not grads:
            return [], flag
        xs = [g.contiguous() for g in grads]
        table = table_for(xs)
        outs = list(out) if out is not None else table.empty_views(
            [g.shape for g in grads], [out_dtype] * len(grads))
        packed_scale(table, xs, inv, flag, outs)
        return outs, flag

    def unscale_with_stashed(self, new_grads: Sequence[torch.Tensor],
                             stashed: Sequence[torch.Tensor],
                             state: LossScaleState,
                             out: Optional[Sequence[torch.Tensor]] = None
                             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The accumulation path: ``(1 / scale) * new + 1 * stashed`` in
        fp32 (into ``out`` when given, each in its own dtype, else fp32),
        and one int32 flag ``(1,)`` raised only by a non-finite value of
        the *new* gradients (``arg_to_check=0``, so a stale inf in the
        stash is not this backward's).  On the card, one K10 launch over
        the whole tree (one per dtype group)."""
        inv = 1.0 / state.loss_scale
        outs, flag = multi_tensor_axpby(
            CHUNK_SIZE, [new_grads, stashed], inv, 1.0, arg_to_check=0,
            out_dtype=torch.float32, out=out)
        return outs, flag.reshape(1)

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
