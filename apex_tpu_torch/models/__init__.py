from apex_tpu_torch.models.gpt import (
    GPTConfig,
    GPTModel,
    gpt_small,
    gpt_small_tpu,
    gpt_tiny,
)

__all__ = ["GPTConfig", "GPTModel", "gpt_small", "gpt_small_tpu",
           "gpt_tiny"]
