from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    BertModel,
    SelfAttention,
    TransformerLayer,
    bert_base,
    bert_large,
    bert_large_tpu,
    bert_tiny,
    pretraining_loss,
)
from apex_tpu_torch.models.gpt import (
    GPTConfig,
    GPTModel,
    gpt_small,
    gpt_small_tpu,
    gpt_tiny,
    lm_loss,
)

__all__ = ["BertConfig", "BertForPreTraining", "BertModel", "GPTConfig",
           "GPTModel", "SelfAttention", "TransformerLayer", "bert_base",
           "bert_large", "bert_large_tpu", "bert_tiny", "gpt_small",
           "gpt_small_tpu", "gpt_tiny", "lm_loss", "pretraining_loss"]
