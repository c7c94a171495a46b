"""The serving tier of the port: the async :class:`AnticlusterRouter` and
its synchronous facade :class:`AnticlusterService` (the reference's
``Generator``, a model server, belongs to the model stack and is not
ported)."""

from repro_torch.serve.router import (AnticlusterRouter, EnginePool, Rejected,
                                      ServiceMetrics, Ticket)
from repro_torch.serve.anticluster_service import AnticlusterService

__all__ = ["AnticlusterRouter", "AnticlusterService", "EnginePool",
           "Rejected", "ServiceMetrics", "Ticket"]
