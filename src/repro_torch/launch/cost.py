"""The dry-run's count of a step's work, on ``meta`` tensors.

The counterpart of ``repro/launch/hlo_cost.py``, which reads the trip
counts and the operations of XLA's compiled HLO text.  Nothing in the
port produces HLO, so the port counts the step itself: :class:`CostCounter`
is a ``TorchDispatchMode`` under which the step runs once on ``meta``
tensors (shapes without data), every Python loop running out.  It counts

- FLOPs, by ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, attention), plus the operations of each
  hand-written kernel the step reaches, which ``kernels/ops.py``'s
  ``meta`` path reports (the counts of the kernel's bound);
- bytes, as each operation's input and output bytes, views and
  allocations aside, before any fusion (departure P11), plus each
  kernel's;
- ``unknown_trip_whiles``: 0, since no loop is left uncounted.
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

aten = torch.ops.aten
# allocations and metadata: no bytes move
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.detach,
             aten.lift_fresh}


def _bytes(objs) -> int:
    """The bytes of the tensors among ``objs``, in lists and tuples too
    (an operation's arguments and outputs nest no deeper)."""
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.nbytes
        elif isinstance(o, (list, tuple)):
            n += _bytes(o)
    return n


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)``, then ``c.flops``,
    ``c.bytes``, and by operation ``c.flops_by_op`` (the kernels under
    their names)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.unknown_trip_whiles = 0
        self.flops_by_op = collections.Counter()
        self._meta = ops.meta_counter(self)

    def __enter__(self):
        self._meta.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._meta.__exit__(*exc)

    def add_kernel(self, name: str, flops: int, n_bytes: int) -> None:
        self.flops += flops
        self.bytes += n_bytes
        self.flops_by_op[name] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[str(packet)] += n
        if not func.is_view and packet not in _NO_BYTES:
            self.bytes += (_bytes(args) + _bytes(kwargs.values())
                           + _bytes(out if isinstance(out, (list, tuple))
                                    else (out,)))
        return out
