"""Model zoo of the port: GPT and BERT."""

from apex_tpu_torch.models.bert import BertConfig, BertModel  # noqa: F401
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel  # noqa: F401

__all__ = ["GPTConfig", "GPTModel", "BertConfig", "BertModel"]
