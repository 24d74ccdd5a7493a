"""The port of ``apex_tpu/ops/pallas/experimental``'s entry points that
have a kernel of their own: :func:`flash_attention_mh` (K17 / K18).  Like
the JAX package's, nothing on a default path imports this namespace; the
1x1-conv backward (K16) lives in :mod:`apex_tpu_torch.ops.cuda.conv1x1`
and the packed finite check (K15) in :mod:`apex_tpu_torch.ops.cuda.finite`.
"""

from apex_tpu_torch.ops.experimental.flash_mh import (
    FlashAttentionMH,
    flash_attention_mh,
)

__all__ = ["FlashAttentionMH", "flash_attention_mh"]
