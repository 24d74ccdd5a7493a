from apex_tpu_torch.optimizers.fp16_optimizer import FP16Optimizer
from apex_tpu_torch.optimizers.fused_adam import (
    EPS_MODE_INSIDE,
    EPS_MODE_OUTSIDE,
    FusedAdam,
    adam_step,
)
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, lamb_step

__all__ = ["EPS_MODE_INSIDE", "EPS_MODE_OUTSIDE", "FP16Optimizer",
           "FusedAdam", "FusedLAMB", "adam_step", "lamb_step"]
