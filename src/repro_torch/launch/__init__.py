"""Launch helpers of the PyTorch port: the meshes (:func:`make_host_mesh`,
:func:`make_production_mesh`), the dry-run's abstract inputs
(``launch.inputs``), its cost count (``launch.cost``) and CLI
(``python -m repro_torch.launch.dryrun``), and the training launcher
``python -m repro_torch.launch.train``."""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
