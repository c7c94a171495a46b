"""The serving tier of the port: the async :class:`AnticlusterRouter` and
its synchronous facade :class:`AnticlusterService`, and the model server
:class:`Generator` (``generate.py``, the reference's batched generation
engine)."""

from repro_torch.serve.generate import Generator
from repro_torch.serve.router import (AnticlusterRouter, EnginePool, Rejected,
                                      ServiceMetrics, Ticket)
from repro_torch.serve.anticluster_service import AnticlusterService

__all__ = ["AnticlusterRouter", "AnticlusterService", "EnginePool",
           "Generator", "Rejected", "ServiceMetrics", "Ticket"]
