from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (
    MultiTensorApply,
    multi_tensor_applier,
)

__all__ = ["MultiTensorApply", "multi_tensor_applier"]
