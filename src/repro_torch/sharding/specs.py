"""Logical axis -> mesh axis rules, and the data-parallel placement of
anticlustering sessions, in PyTorch.

Counterpart of ``repro/sharding/specs.py``.  Every parameter and
activation dim is tagged with a logical axis (MaxText-style, reduced
vocabulary):

  fsdp   ZeRO-3 weight sharding over the data-parallel axes ('pod','data')
  tp     tensor parallel over 'model' (heads / ff / vocab / experts / d_inner)
  dp     batch dim of activations over ('pod','data')
  sp     long sequences (decode KV caches) over 'model' (flash-decode style)
  None   replicated

Axes missing from the mesh (e.g. 'pod' on the single-pod mesh) are
dropped.  A partition spec is a plain tuple whose entries are None, an
axis name or a tuple of names, as ``tuple(PartitionSpec(...))`` gives
them; :class:`NamedSharding` pairs one with its mesh.  No partitioner
reads them: the dry-run (``repro_torch.launch.dryrun``) sizes each
argument's share of a device from them.

:data:`DATA_AXIS_CANDIDATES` and :func:`resolve_data_axes` are copied
with their messages.  :class:`Mesh` stands in for ``jax.sharding.Mesh``:
a named grid of ``torch.device`` s.  The port's mesh route
(:mod:`repro_torch.core.sharded`) runs one solve a data-parallel shard, on
the device at that shard's position, with no collective; a mesh may name
one device at several positions (its shards then run one after another
there).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LOGICAL = {
    "fsdp": ("pod", "data"),
    "dp": ("pod", "data"),
    "tp": ("model",),
    "sp": ("model",),
    None: (),
}


def _resolve(tag, axis_names):
    axes = tuple(a for a in LOGICAL[tag] if a in axis_names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def to_pspec(tags: tuple, axis_names) -> tuple:
    """('fsdp', 'tp') -> (('pod', 'data'), 'model') on the 3-axis mesh."""
    return tuple(_resolve(t, axis_names) for t in tags)


class NamedSharding(NamedTuple):
    """A mesh and a partition spec over its axes (the port's
    ``jax.sharding.NamedSharding``)."""
    mesh: "Mesh"
    spec: tuple


def logical_to_sharding(tags: tuple, mesh) -> NamedSharding:
    return NamedSharding(mesh, to_pspec(tags, mesh.axis_names))


def _is_tags(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(t, (str, type(None)))
                                        for t in x)


def tree_pspecs(tag_tree, axis_names):
    """Map a nested dict (or list) of logical-tag tuples to partition
    specs."""
    if _is_tags(tag_tree):
        return to_pspec(tag_tree, axis_names)
    if isinstance(tag_tree, dict):
        return {k: tree_pspecs(v, axis_names) for k, v in tag_tree.items()}
    return type(tag_tree)(tree_pspecs(v, axis_names) for v in tag_tree)


def spec_shards(spec: tuple, mesh) -> list[int]:
    """The shards of each dim under ``spec`` on ``mesh``: the product of
    the sizes of the axes its entry names (1 where None)."""
    out = []
    for entry in spec:
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        out.append(math.prod(mesh.shape[a] for a in names))
    return out


# --- data-parallel placement of anticlustering sessions ---------------------

DATA_AXIS_CANDIDATES = ("pod", "data")


class Mesh:
    """A named n-D grid of devices (the port's ``jax.sharding.Mesh``).

    ``devices`` is an ndarray (or nested sequence) of ``torch.device`` /
    device strings, one axis per name in ``axis_names``; ``shape`` maps each
    axis to its size, in order, as JAX's does.  Positions may repeat a
    device.
    """

    def __init__(self, devices, axis_names):
        flat = [torch.device(d) for d in np.asarray(devices, object).ravel()]
        grid = np.empty(len(flat), object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(np.asarray(devices, object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a {self.devices.ndim}-D device grid needs as many axis "
                f"names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def resolve_data_axes(mesh: Mesh, data_axes="auto") -> tuple[str, ...]:
    """The concrete mesh axes that shard the data rows.

    ``"auto"`` (the :class:`repro_torch.anticluster.AnticlusterSpec`
    default) takes whichever of the canonical data-parallel axes
    (:data:`DATA_AXIS_CANDIDATES`) exist on ``mesh`` -- the single-pod mesh
    simply has no ``'pod'`` axis.  An **explicit** tuple is validated
    strictly: naming an axis the mesh does not have raises with the offending
    names instead of silently dropping them (a typo'd axis would otherwise
    quietly change the shard count and therefore every label).
    """
    if data_axes is None or data_axes == "auto":
        axes = tuple(a for a in DATA_AXIS_CANDIDATES if a in mesh.axis_names)
        if not axes:
            raise ValueError(
                f"mesh axes {tuple(mesh.axis_names)} contain none of the "
                f"default data axes {DATA_AXIS_CANDIDATES}; pass data_axes "
                "naming the axis that shards the rows")
        return axes
    axes = (data_axes,) if isinstance(data_axes, str) else tuple(data_axes)
    missing = tuple(a for a in axes if a not in mesh.axis_names)
    if missing:
        raise ValueError(
            f"data_axes {missing} not present on the mesh (axes: "
            f"{tuple(mesh.axis_names)}); silently dropping them would "
            "change the shard count -- name only existing axes or use "
            'data_axes="auto"')
    if not axes:
        raise ValueError("data_axes must name at least one mesh axis")
    return axes


def shard_devices(mesh: Mesh, axes: tuple[str, ...]) -> list[torch.device]:
    """The device of each data-parallel shard, in shard order.

    Shard ``s`` is the row-major index over ``axes`` (in the order given),
    the order in which a ``PartitionSpec(axes)`` lays row blocks out; the
    mesh's other axes replicate the shard, which runs on their first
    position.
    """
    names = mesh.axis_names
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for s in range(math.prod(sizes)):
        coords = dict(zip(axes, np.unravel_index(s, sizes)))
        out.append(mesh.devices[tuple(int(coords.get(a, 0)) for a in names)])
    return out
