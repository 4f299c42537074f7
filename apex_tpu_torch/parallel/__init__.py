"""Data-parallel toolkit of the port: batch normalization with the
reference's arithmetic, on one device (the cross-device DDP and
SyncBatchNorm reduction come with multi-GPU, queue item A5), and the
``LARC`` re-export (it lives with the optimizers;
``reference:apex/parallel/LARC.py``)."""

from apex_tpu_torch.optimizers.larc import LARC  # noqa: F401
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    BatchNormState, SyncBatchNorm, sync_batch_norm)

__all__ = ["BatchNormState", "SyncBatchNorm", "sync_batch_norm", "LARC"]
