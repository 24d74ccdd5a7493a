"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version, and the build that compiles them (:mod:`.build`)."""

from apex_tpu_torch.ops.cuda.adam import packed_adam, packed_adam_ref
from apex_tpu_torch.ops.cuda.flash_attention import (
    flash_attn_bwd,
    flash_attn_bwd_ref,
    flash_attn_fwd,
    flash_attn_fwd_ref,
)
from apex_tpu_torch.ops.cuda.lamb import (
    lamb_stage1,
    lamb_stage1_ref,
    lamb_stage2,
    lamb_stage2_ref,
)
from apex_tpu_torch.ops.cuda.layer_norm import (
    layer_norm_bwd,
    layer_norm_bwd_ref,
    layer_norm_fwd,
    layer_norm_fwd_ref,
)
from apex_tpu_torch.ops.cuda.multi_tensor import (
    packed_scale,
    packed_scale_ref,
    packed_sumsq,
    packed_sumsq_ref,
)

#: every kernel wrapper, by the name its launch counter reports under
KERNELS = {"layer_norm_fwd": layer_norm_fwd,
           "flash_attn_fwd": flash_attn_fwd,
           "layer_norm_bwd": layer_norm_bwd,
           "flash_attn_bwd": flash_attn_bwd,
           "packed_adam": packed_adam,
           "packed_scale": packed_scale,
           "lamb_stage1": lamb_stage1,
           "lamb_stage2": lamb_stage2,
           "packed_sumsq": packed_sumsq}


def launch_counts() -> dict:
    """``{kernel name: launches so far}``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "flash_attn_bwd", "flash_attn_bwd_ref",
           "flash_attn_fwd", "flash_attn_fwd_ref", "lamb_stage1",
           "lamb_stage1_ref", "lamb_stage2", "lamb_stage2_ref",
           "launch_counts", "layer_norm_bwd", "layer_norm_bwd_ref",
           "layer_norm_fwd", "layer_norm_fwd_ref", "packed_adam",
           "packed_adam_ref", "packed_scale", "packed_scale_ref",
           "packed_sumsq", "packed_sumsq_ref", "reset_launch_counts"]
