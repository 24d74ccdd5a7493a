"""Manual mixed-precision utilities (``apex_tpu/fp16_utils``): the
``fp16util`` conversions, the legacy master-weight wrapper
``FP16Optimizer`` (alias ``FP16_Optimizer``) and the legacy host-state
loss scalers ``LossScaler`` / ``DynamicLossScaler``.  The flat-buffer
optimizer of the reference's ``apex/optimizers`` is
:class:`apex_tpu_torch.optimizers.FP16Optimizer`."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import (
    FP16_Optimizer,
    FP16Optimizer,
)
from apex_tpu_torch.fp16_utils.fp16util import (
    BN_convert_float,
    FP16Model,
    clip_grad_norm,
    convert_module,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
    to_python_float,
    tree_to_float,
    tree_to_half,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (
    DynamicLossScaler,
    LossScaler,
)

# the reference's spellings
tofp16 = tree_to_half
network_to_half = tree_to_half

__all__ = ["BN_convert_float", "DynamicLossScaler", "FP16Optimizer",
           "FP16_Optimizer", "LossScaler", "FP16Model", "clip_grad_norm",
           "convert_module", "convert_network",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "network_to_half", "prep_param_lists", "to_python_float",
           "tofp16", "tree_to_float", "tree_to_half"]
