"""Placement of the port's mesh route: :class:`Mesh` and the data axes."""

from repro_torch.sharding.specs import (DATA_AXIS_CANDIDATES, Mesh,
                                        resolve_data_axes, shard_devices)

__all__ = ["DATA_AXIS_CANDIDATES", "Mesh", "resolve_data_axes",
           "shard_devices"]
