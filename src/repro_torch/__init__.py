"""PyTorch/CUDA port of the ABA anticlustering system (``repro`` is the JAX
reference).

The ported slice is the ABA solve behind :func:`anticluster`: the
centrality sort, the Section 4.2 / 4.3 rearrangements, the Algorithm-1
batch scan (dense, streaming and hierarchical) and the batched auction
LAP, whose bidding rounds and chunk gathers run through hand-written CUDA
kernels for Hopper (``repro_torch/kernels/csrc``); and the sessions on top
of it: :class:`AnticlusterEngine` (warm ``repartition``,
``dispatch_repartition``, ``update``) and
``repro_torch.incremental.IncrementalPartition``; the mesh route
(``repro_torch.core.sharded``, ``repro_torch.sharding.Mesh``,
``repro_torch.launch.make_host_mesh``) with its sharded sessions; and the
consumers: ``repro_torch.data`` (the mini-batch sequencer, K-fold
cross-validation), ``repro_torch.train`` (the overlapped mini-batch
pipeline), ``repro_torch.serve`` (the serving router) and
``repro_torch.obs`` (tracing, solver telemetry, memory profiles).  The
paper's baselines are host code in ``repro_torch.core.baselines``.  Entry points run on the
CUDA device unless ``device="cpu"`` is passed.  The front door is
``from repro_torch.anticluster import anticluster``, as in the JAX package.
"""

from repro_torch.anticluster import (ABAState, AnticlusterEngine,
                                     AnticlusterResult, AnticlusterSpec,
                                     ShardedABAState)
from repro_torch.core.assignment import (AuctionConfig, auction_solve,
                                         auction_solve_factored,
                                         available_solvers, get_solver,
                                         register_solver)
from repro_torch.state import (abastate_from_numpy, abastate_to_numpy,
                               shardedstate_from_numpy, shardedstate_to_numpy,
                               state_from_numpy, state_to_numpy)

__all__ = [
    "AnticlusterSpec", "AnticlusterResult", "AnticlusterEngine", "ABAState",
    "ShardedABAState",
    "AuctionConfig", "auction_solve", "auction_solve_factored",
    "available_solvers", "get_solver", "register_solver",
    "state_from_numpy", "state_to_numpy", "abastate_from_numpy",
    "abastate_to_numpy", "shardedstate_from_numpy", "shardedstate_to_numpy",
]
