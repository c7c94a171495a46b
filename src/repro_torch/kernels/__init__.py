"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

The public entry point, counterpart of ``repro.kernels``: the dispatchers
``bid_top2`` and ``cdist`` (both with ``idx=``), the plain versions
``bid_top2_ref``, ``cdist_ref`` and ``ssm_scan_ref``, and the dispatcher
``ssm_scan`` (counterpart of ``ssm_scan_pallas``).  Nothing is compiled at
import: the CUDA sources are built at a kernel's first launch.
"""

from repro_torch.kernels.ops import bid_top2, cdist, ssm_scan
from repro_torch.kernels.ref import bid_top2_ref, cdist_ref, ssm_scan_ref

__all__ = ["bid_top2", "cdist", "bid_top2_ref", "cdist_ref",
           "ssm_scan_ref", "ssm_scan"]
