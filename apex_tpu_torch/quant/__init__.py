"""fp8 / int8 as a precision regime, as ``apex_tpu/quant``.

- :mod:`.fp8`: the fp8-training half: e4m3 / e5m2 quantization with
  per-tensor scales, the delayed-scaling states (amax history and the
  scale derived from it, device tensors carried by the ``Amp`` beside
  the loss scaler under O4), and :func:`~.fp8.scaled_matmul`
  (``torch._scaled_mm`` on the card).  amp's O4 level drives it through
  the op layer (:mod:`apex_tpu_torch.amp.ops`).
- :mod:`.int8`: the inference half: symmetric per-channel int8 weights
  and the per-token int8 KV-cache format that ``kv_dtype="int8"``
  selects in :func:`apex_tpu_torch.models.generate.generate` and
  :class:`apex_tpu_torch.serve.ServeConfig`: int8 pools beside fp32 scale
  pools, about half the bytes of a bf16 cache.
"""

from apex_tpu_torch.quant.fp8 import (  # noqa: F401
    FP8_E4M3,
    FP8_E5M2,
    DelayedScalingState,
    Fp8TrainState,
    bwd_qdq,
    delayed_scale,
    dequantize,
    fp8_max,
    init_delayed_scaling,
    init_train_state,
    qdq,
    qdq_ste,
    quantize,
    record_amax,
    rescale_events,
    scaled_matmul,
    step_saturation,
    tree_amax,
    update_train_state,
)
from apex_tpu_torch.quant.int8 import (  # noqa: F401
    dequantize_int8,
    kv_dequant_scales,
    quantize_int8,
    quantize_kv,
)
