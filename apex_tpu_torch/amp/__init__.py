"""Mixed-precision support of the port: on-device loss scaling."""

from apex_tpu_torch.amp.scaler import (  # noqa: F401
    DynamicLossScale, LossScaleState, NoOpLossScale, StaticLossScale,
    all_finite, make_loss_scale, select_tree)

__all__ = ["DynamicLossScale", "LossScaleState", "NoOpLossScale",
           "StaticLossScale", "all_finite", "make_loss_scale", "select_tree"]
