"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version, and the build that compiles them (:mod:`.build`)."""

from apex_tpu_torch.ops.cuda.flash_attention import (
    flash_attn_fwd,
    flash_attn_fwd_ref,
)
from apex_tpu_torch.ops.cuda.layer_norm import (
    layer_norm_fwd,
    layer_norm_fwd_ref,
)

#: every kernel wrapper, by the name its launch counter reports under
KERNELS = {"layer_norm_fwd": layer_norm_fwd,
           "flash_attn_fwd": flash_attn_fwd}


def launch_counts() -> dict:
    """``{kernel name: launches so far}``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "flash_attn_fwd", "flash_attn_fwd_ref",
           "launch_counts", "layer_norm_fwd", "layer_norm_fwd_ref",
           "reset_launch_counts"]
