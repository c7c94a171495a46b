"""Launch helpers of the PyTorch port: :func:`make_host_mesh`, and the
training launcher ``python -m repro_torch.launch.train``."""

from repro_torch.launch.mesh import make_host_mesh

__all__ = ["make_host_mesh"]
