"""Model zoo of the port: GPT, BERT and ResNet-50."""

from apex_tpu_torch.models.bert import BertConfig, BertModel  # noqa: F401
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel  # noqa: F401
from apex_tpu_torch.models.resnet import (  # noqa: F401
    Bottleneck, ResNet50, ResNetConfig)

__all__ = ["GPTConfig", "GPTModel", "BertConfig", "BertModel",
           "ResNetConfig", "ResNet50", "Bottleneck"]
