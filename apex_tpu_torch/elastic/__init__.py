"""The elastic runtime of the port: so far the serving half of the
deterministic fault plan (:class:`~apex_tpu_torch.elastic.faults
.FaultPlan`)."""

from apex_tpu_torch.elastic.faults import FaultPlan

__all__ = ["FaultPlan"]
