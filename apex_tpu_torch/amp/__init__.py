"""Mixed precision for the port: opt-level policies, device-side loss
scaling and the train step (``apex_tpu/amp``'s O0-O3 path)."""

from apex_tpu_torch.amp.frontend import (
    Amp,
    default_keep_fp32_filter,
    initialize,
    make_train_step,
)
from apex_tpu_torch.amp.policy import Properties, resolve
from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState, all_finite

__all__ = ["Amp", "LossScaleState", "LossScaler", "Properties",
           "all_finite", "default_keep_fp32_filter", "initialize",
           "make_train_step", "resolve"]
