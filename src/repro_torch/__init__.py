"""PyTorch/CUDA port of the ABA anticlustering system (``repro`` is the JAX
reference).

The ported slice is the streaming ABA solve behind :func:`anticluster`:
the centrality sort, the Section 4.2 rearrangement, the Algorithm-1 batch
scan (dense and streaming) and the batched auction LAP, whose bidding
rounds and chunk gathers run through hand-written CUDA kernels for Hopper
(``repro_torch/kernels/csrc``).  Entry points run on the CUDA device unless
``device="cpu"`` is passed.  The front door is
``from repro_torch.anticluster import anticluster``, as in the JAX package.
"""

from repro_torch.anticluster import (AnticlusterEngine, AnticlusterResult,
                                     AnticlusterSpec)
from repro_torch.core.assignment import (AuctionConfig, auction_solve,
                                         auction_solve_factored,
                                         available_solvers, get_solver,
                                         register_solver)
from repro_torch.state import state_from_numpy, state_to_numpy

__all__ = [
    "AnticlusterSpec", "AnticlusterResult", "AnticlusterEngine",
    "AuctionConfig", "auction_solve", "auction_solve_factored",
    "available_solvers", "get_solver", "register_solver",
    "state_from_numpy", "state_to_numpy",
]
