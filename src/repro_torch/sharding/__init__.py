"""Placement: the logical-axis rules (:func:`to_pspec`,
:class:`NamedSharding`), :class:`Mesh` and the data axes of the port's
mesh route."""

from repro_torch.sharding.specs import (DATA_AXIS_CANDIDATES, LOGICAL, Mesh,
                                        NamedSharding, logical_to_sharding,
                                        resolve_data_axes, shard_devices,
                                        to_pspec, tree_pspecs)

__all__ = ["DATA_AXIS_CANDIDATES", "LOGICAL", "Mesh", "NamedSharding",
           "logical_to_sharding", "resolve_data_axes", "shard_devices",
           "to_pspec", "tree_pspecs"]
