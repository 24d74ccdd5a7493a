"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version, and the build that compiles them (:mod:`.build`)."""

from apex_tpu_torch.ops.cuda.adam import (
    packed_adam,
    packed_adam_ref,
    packed_adam_tree,
    packed_adam_tree_ref,
)
from apex_tpu_torch.ops.cuda.conv1x1 import (
    conv1x1_bwd,
    conv1x1_bwd_ref,
    conv1x1_route,
)
from apex_tpu_torch.ops.cuda.finite import (
    all_finite_packed,
    packed_nonfinite,
    packed_nonfinite_ref,
)
from apex_tpu_torch.ops.cuda.flash_attention import (
    attn_delta,
    bwd_route,
    flash_attn_bwd,
    flash_attn_bwd_dkv,
    flash_attn_bwd_dkv_ref,
    flash_attn_bwd_dq,
    flash_attn_bwd_dq_ref,
    flash_attn_bwd_ref,
    flash_attn_fwd,
    flash_attn_fwd_ref,
    flash_bwd_finish,
    flash_bwd_finish_ref,
    flash_bwd_prologue,
    flash_bwd_prologue_ref,
    flash_bwd_simt,
    flash_fwd_prologue,
    flash_fwd_prologue_ref,
    flash_fwd_simt,
    fused_bwd,
    fused_bwd_max_bytes,
    fused_bwd_partials_bytes,
    fwd_route,
    simt_layout,
    tma_geometry,
    two_pass_bwd,
)
from apex_tpu_torch.ops.cuda.flash_mh import (
    flash_mh_bwd,
    flash_mh_bwd_ref,
    flash_mh_fwd,
    flash_mh_fwd_ref,
    mh_bwd_route,
    mh_fused_bwd,
    mh_partials_bytes,
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
    ln_bwd_route,
    ln_fwd_route,
)
from apex_tpu_torch.ops.cuda.multi_tensor import (
    packed_axpby,
    packed_axpby_ref,
    packed_scale,
    packed_scale_ref,
    packed_sumsq,
    packed_sumsq_ref,
    sumsq_per_tensor,
    sumsq_per_tensor_ref,
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
           "packed_sumsq": packed_sumsq,
           "packed_axpby": packed_axpby,
           "packed_adam_tree": packed_adam_tree,
           "sumsq_per_tensor": sumsq_per_tensor,
           "flash_attn_bwd_dq": flash_attn_bwd_dq,
           "flash_attn_bwd_dkv": flash_attn_bwd_dkv,
           "flash_bwd_prologue": flash_bwd_prologue,
           "conv1x1_bwd": conv1x1_bwd,
           "packed_nonfinite": packed_nonfinite,
           "flash_mh_fwd": flash_mh_fwd,
           "flash_mh_bwd": flash_mh_bwd,
           "flash_fwd_prologue": flash_fwd_prologue,
           "flash_fwd_simt": flash_fwd_simt,
           "flash_bwd_simt": flash_bwd_simt,
           "flash_bwd_finish": flash_bwd_finish}


def launch_counts() -> dict:
    """``{kernel name: launches so far}``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "all_finite_packed", "attn_delta", "bwd_route",
           "conv1x1_bwd", "conv1x1_route", "flash_bwd_finish", "flash_bwd_finish_ref",
           "flash_bwd_simt", "flash_fwd_prologue",
           "flash_fwd_prologue_ref", "flash_fwd_simt", "fwd_route",
           "mh_bwd_route",
           "conv1x1_bwd_ref", "flash_mh_bwd", "flash_mh_bwd_ref",
           "flash_mh_fwd", "flash_mh_fwd_ref", "mh_fused_bwd",
           "mh_partials_bytes", "packed_nonfinite", "packed_nonfinite_ref",
           "flash_attn_bwd", "flash_attn_bwd_dkv",
           "flash_attn_bwd_dkv_ref", "flash_attn_bwd_dq",
           "flash_attn_bwd_dq_ref", "flash_attn_bwd_ref",
           "flash_attn_fwd", "flash_attn_fwd_ref", "flash_bwd_prologue",
           "flash_bwd_prologue_ref", "fused_bwd",
           "fused_bwd_max_bytes", "fused_bwd_partials_bytes", "lamb_stage1",
           "lamb_stage1_ref", "lamb_stage2", "lamb_stage2_ref",
           "launch_counts", "layer_norm_bwd", "layer_norm_bwd_ref",
           "layer_norm_fwd", "layer_norm_fwd_ref", "ln_bwd_route",
           "ln_fwd_route",
           "packed_adam",
           "packed_adam_ref", "packed_adam_tree", "packed_adam_tree_ref",
           "packed_axpby", "packed_axpby_ref", "packed_scale",
           "packed_scale_ref", "packed_sumsq", "packed_sumsq_ref",
           "reset_launch_counts", "simt_layout", "sumsq_per_tensor",
           "sumsq_per_tensor_ref", "tma_geometry", "two_pass_bwd"]
