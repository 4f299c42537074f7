"""Model zoo of the port (GPT in this slice)."""

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel  # noqa: F401

__all__ = ["GPTConfig", "GPTModel"]
