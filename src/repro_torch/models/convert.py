"""The reference's parameter tree <-> the port's :class:`Model`.

Parity with ``repro.models`` goes through here: the port draws its own
weights (departure P8), so the tests hand the reference's ``init_params``
tree, as nested dicts of numpy arrays, to :func:`params_from_jax`.
:func:`params_to_numpy` is the way back, the reference's stacked leaves
(checkpoints write them).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.transformer import Model, flatten_defs, model_defs


def params_from_jax(cfg, tree: dict, *, device=None) -> Model:
    """A :class:`Model` on ``device`` (default CUDA) holding ``tree``'s
    arrays, name for name: ``tree["blocks"]["L0"]["attn"]["in_proj"][b]``
    becomes ``model.blocks[b]["L0"].attn.in_proj``.  Raises ValueError
    unless ``tree`` has exactly ``model_defs``' leaves at their shapes."""
    dev = resolve_device(device)
    defs = flatten_defs(model_defs(cfg))
    arrays = {k: np.asarray(v) for k, v in flatten_defs(tree).items()}
    if set(arrays) != set(defs):
        raise ValueError(
            f"parameter tree of {cfg.name}: missing "
            f"{sorted(set(defs) - set(arrays))}, unexpected "
            f"{sorted(set(arrays) - set(defs))}")
    for path, pd in defs.items():
        if arrays[path].shape != tuple(pd.shape):
            raise ValueError(f"{path}: shape {arrays[path].shape}, "
                             f"model_defs says {tuple(pd.shape)}")
    model = Model(cfg, device=dev)
    with torch.no_grad():
        for path, block, p in model.leaves():
            a = arrays[path] if block is None else arrays[path][block]
            p.copy_(torch.tensor(a))
    return model


def params_to_numpy(model: Model) -> dict:
    """``{reference path: numpy array}`` of ``model``'s parameters, each
    block leaf stacked on a leading ``n_blocks`` axis (``model_defs``'
    shapes), the paths in the reference's flattening order (sorted)."""
    parts: dict = {}
    for path, block, p in model.leaves():
        a = p.detach().cpu().numpy()
        if block is None:
            parts[path] = a
        else:
            parts.setdefault(path, []).append(a)
    return {path: (np.stack(parts[path]) if isinstance(parts[path], list)
                   else parts[path])
            for path in sorted(parts, key=lambda k: k.split("/"))}
