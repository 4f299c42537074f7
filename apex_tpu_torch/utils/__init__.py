"""The port's ``apex_tpu/utils``: :class:`AutoResume`, the preemption hook
of the elastic runner; the Megatron-style timers and the profiling window
(:mod:`~apex_tpu_torch.utils.timers`); rank-aware logging
(:mod:`~apex_tpu_torch.utils.logging`)."""

from apex_tpu_torch.utils import autoresume, logging, timers  # noqa: F401
from apex_tpu_torch.utils.autoresume import AutoResume
from apex_tpu_torch.utils.logging import (RankInfoFormatter, get_logger,
                                          rank_zero_only, set_verbosity,
                                          setup_logging)
from apex_tpu_torch.utils.timers import (Timer, Timers, device_fence,
                                         profile_trace)

__all__ = ["AutoResume", "autoresume", "Timer", "Timers", "device_fence",
           "profile_trace", "RankInfoFormatter", "get_logger",
           "rank_zero_only", "set_verbosity", "setup_logging", "timers",
           "logging"]
