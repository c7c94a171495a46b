"""Synchronous facade over the async serving tier.

Counterpart of ``repro/serve/anticluster_service.py``:
:class:`AnticlusterService` is ``partition`` for one request and
``partition_many`` for a burst, a thin wrapper over
:class:`repro_torch.serve.router.AnticlusterRouter` with no background
thread: ``partition_many`` admits the whole burst atomically and drives the
queue inline, so same-bucket requests stack, with the router's row-bucket
padding, engine pools and metrics.

New code should use the router's async surface directly
(``submit(x, deadline=...) -> Ticket``).
"""

from __future__ import annotations

from repro_torch.serve.router import AnticlusterRouter

__all__ = ["AnticlusterService"]


class AnticlusterService(AnticlusterRouter):
    """Shape-keyed, warm-started request batching for ``anticluster``.

    An :class:`AnticlusterRouter` with no background worker: callers drive
    the queue inline through the synchronous ``partition`` /
    ``partition_many`` (or explicitly via ``submit`` + ``Ticket.result``,
    which pumps the queue on the calling thread).  Single-threaded and
    deterministic; services absorbing live traffic should use
    :class:`AnticlusterRouter` itself (``background=True``).
    ``device=None`` serves on the CUDA devices, ``device="cpu"`` on the CPU.
    """

    def __init__(self, spec=None, *, max_group: int = 32, **overrides):
        super().__init__(spec, max_group=max_group, background=False,
                         **overrides)
