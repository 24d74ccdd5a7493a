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
from apex_tpu_torch.models.resnet import (
    ARCHS,
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet50S2D,
    ResNet101,
    ResNet152,
    accuracy,
    resnet_loss,
    shard_rows,
    synthetic_batch,
)
from apex_tpu_torch.models.dcgan import (
    Discriminator,
    Generator,
    dcgan_step,
    gan_losses,
)
from apex_tpu_torch.models.mlp import MLP, AmpDense, cross_entropy_loss
from apex_tpu_torch.models.gpt import (
    GPTConfig,
    GPTModel,
    gpt_small,
    gpt_small_tpu,
    gpt_tiny,
    lm_loss,
    train_toy_lm,
)

__all__ = ["AmpDense", "Discriminator", "Generator", "MLP",
           "cross_entropy_loss", "dcgan_step", "gan_losses", "ARCHS", "BasicBlock", "Bottleneck", "ResNet", "ResNet18",
           "ResNet34", "ResNet50", "ResNet50S2D", "ResNet101", "ResNet152",
           "accuracy", "resnet_loss", "shard_rows", "synthetic_batch", "BertConfig", "BertForPreTraining", "BertModel", "GPTConfig",
           "GPTModel", "SelfAttention", "TransformerLayer", "bert_base",
           "bert_large", "bert_large_tpu", "bert_tiny", "gpt_small",
           "gpt_small_tpu", "gpt_tiny", "lm_loss", "pretraining_loss",
           "train_toy_lm"]
