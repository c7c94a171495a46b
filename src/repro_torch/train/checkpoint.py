"""Checkpoint save/restore with atomic rename, retention, and restore onto
given devices.

Counterpart of ``repro/train/checkpoint.py``, with its on-disk format key
for key: one directory ``step_<10 digits>`` per checkpoint holding
``arrays.npz`` (flattened ``path -> array`` leaves) and ``manifest.json``
(step, each leaf's shape and dtype).  A tree is nested dicts (keys
flattened in sorted order, as JAX flattens them), tuples or lists
(``path/0``, ...), dataclasses (their fields, as the reference's
registered dataclasses: ``ABAState``), tensors, numpy arrays and
:class:`~repro_torch.models.Model` s, whose leaves are the reference's:
a block leaf is stacked on a leading ``n_blocks`` axis on save and split
back on restore.  So a file written by either package restores in the
other, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import Model


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/b/0": numpy array}`` of a tree, in JAX's flattening order."""
    if isinstance(tree, Model):
        return {prefix + k: a for k, a in params_to_numpy(tree).items()}
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        leaf = tree.detach().cpu().numpy() if torch.is_tensor(tree) \
            else np.asarray(tree)
        return {prefix[:-1]: leaf}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint write; prunes to the newest ``keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(tree)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": int(step),
        "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                   for k, a in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def _device_of(like):
    if isinstance(like, Model):
        return next(like.parameters()).device
    return like.device if torch.is_tensor(like) else None


def _rebuild(like, data, prefix: str, device):
    """``like``'s structure holding the arrays of ``data`` under
    ``prefix``; each tensor and model on ``device`` (default its own)."""
    if isinstance(like, Model):
        flat = {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}
        return params_from_jax(like.cfg, flat,
                               device=device or _device_of(like))

    def sub(key, v, dev):
        return _rebuild(v, data, f"{prefix}{key}/", dev)

    if isinstance(like, dict):
        return {k: sub(k, v, _pick(device, k)) for k, v in like.items()}
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: sub(f.name, getattr(like, f.name), _pick(device, f.name))
            for f in dataclasses.fields(like)})
    if isinstance(like, (tuple, list)):
        return type(like)(sub(i, v, _pick(device, i))
                          for i, v in enumerate(like))
    key = prefix[:-1]
    a = data[key]
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{key}: checkpoint shape {a.shape}, expected "
                         f"{tuple(like.shape)}")
    if torch.is_tensor(like):
        return torch.from_numpy(np.array(a)).to(
            dtype=like.dtype, device=device or like.device)
    return np.asarray(a).astype(np.asarray(like).dtype)


def _pick(device, key):
    """The device subtree for ``key``: a tree of devices is indexed, a
    single device (or None) applies to the whole subtree."""
    return device[key] if isinstance(device, (dict, tuple, list)) else device


def restore(ckpt_dir: str, like_tree, *, step: int | None = None,
            shardings=None):
    """Restore into the structure of ``like_tree`` (new tensors, a new
    :class:`Model` for a model; the like tree is not changed).

    ``shardings``: optional matching tree of ``torch.device`` s (or one
    device for a subtree) on which the restored tensors are placed, as the
    reference places its arrays with ``NamedSharding`` s; default each
    like leaf's device.  Returns (tree, step) or (None, -1) when no
    checkpoint exists.
    """
    steps = latest_steps(ckpt_dir)
    if not steps:
        return None, -1
    step = step if step is not None else max(steps)
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _rebuild(like_tree, data, "", shardings), step


# --- anticlustering engine sessions ----------------------------------------
#
# The engine's carried state (repro_torch.anticluster.ABAState /
# ShardedABAState) is a dataclass of tensors, so the generic save/restore
# above handles it, with the reference's keys ("prices/0", "moment_sum",
# "moment_count", "prev_labels"); a training job resuming after preemption
# warm-starts its per-epoch anticlustering where it left off.

def save_engine_state(ckpt_dir: str, step: int, state, *,
                      keep: int = 3) -> str:
    """Checkpoint an engine session state (``ABAState`` /
    ``ShardedABAState``).  Restore with :func:`restore_engine_state`."""
    return save(ckpt_dir, step, state, keep=keep)


def restore_engine_state(ckpt_dir: str, engine, x_or_shape, *,
                         step: int | None = None):
    """Restore a session state for ``engine`` and input shape
    ``x_or_shape``: validated against ``engine.init_state`` (its shapes
    and dtypes) and placed on the engine's device (the port keeps a mesh
    session's state whole there; ``engine.state_shardings`` names only the
    devices its shards run on).  Returns ``(state, step)`` or ``(None,
    -1)`` when no checkpoint exists."""
    return restore(ckpt_dir, engine.init_state(x_or_shape), step=step)
