"""Mixed precision for the port: opt-level policies (O0-O4), the op
layer (O1's casts, O4's fp8 operand quantization), device-side loss
scaling with one scaler per loss, and the train step (``apex_tpu/amp``)."""

from apex_tpu_torch.amp import lists, ops
from apex_tpu_torch.amp.frontend import (
    Amp,
    default_keep_fp32_filter,
    initialize,
    make_train_step,
)
from apex_tpu_torch.amp.handle import (
    AmpHandle,
    NoOpHandle,
    active_amp,
    init,
    scale_loss,
)
from apex_tpu_torch.amp.ops import (
    cast_context,
    deactivate_registrations,
    disable_casts,
    float_function,
    fp8_function,
    fp8_trace,
    half_function,
    promote_function,
    register_float_function,
    register_fp8_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.policy import (O0, O1, O2, O3, O4, Properties,
                                       opt_levels, resolve)
from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState, all_finite
from apex_tpu_torch.ops.cuda.finite import all_finite_packed

__all__ = ["Amp", "AmpHandle", "LossScaleState", "LossScaler",
           "NoOpHandle", "O0", "O1", "O2", "O3", "O4", "Properties",
           "active_amp", "all_finite", "all_finite_packed", "cast_context",
           "deactivate_registrations", "default_keep_fp32_filter",
           "disable_casts", "float_function", "fp8_function", "fp8_trace",
           "half_function", "init", "initialize", "lists",
           "make_train_step", "ops", "opt_levels", "promote_function",
           "register_float_function", "register_fp8_function",
           "register_half_function", "register_promote_function",
           "resolve", "scale_loss"]
