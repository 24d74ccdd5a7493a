from apex_tpu_torch.optimizers.fused_adam import (
    EPS_MODE_INSIDE,
    EPS_MODE_OUTSIDE,
    FusedAdam,
    adam_step,
)

__all__ = ["EPS_MODE_INSIDE", "EPS_MODE_OUTSIDE", "FusedAdam", "adam_step"]
