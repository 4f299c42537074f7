"""The port's ``apex_tpu/utils``: so far :class:`AutoResume`, the
preemption hook of the elastic runner. The timers and the logging helpers
of the reference's package are queue item A7a."""

from apex_tpu_torch.utils import autoresume  # noqa: F401
from apex_tpu_torch.utils.autoresume import AutoResume

__all__ = ["AutoResume", "autoresume"]
