"""The solver state carried across runs, to and from numpy.

This system has no weights: the auction's dual prices are its carried
state.  A warm run starts every batch LAP from carried prices instead of
zeros (``aba_core`` / ``aba_stream`` ``prices=``, the solvers' ``prices=``).
These functions move such a state between the JAX package (whose
``ABAState`` leaves and whose cores' ``return_state`` dicts become numpy
arrays with ``np.asarray``) and the port's tensors, so that both packages
can run the same warm solve: :func:`state_from_numpy` /
:func:`state_to_numpy` as mappings, :func:`abastate_from_numpy` /
:func:`abastate_to_numpy` as the engine's ``ABAState``, so that a JAX
session's state warm-starts a port session.

A state is a mapping of leaf names to arrays, or a tuple of arrays for the
per-level ``prices``.  Float leaves become float32 tensors, integer leaves
(labels) int32 tensors, as the JAX package keeps them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device


def _leaf_to_tensor(a, device):
    a = np.asarray(a)
    dtype = torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def state_from_numpy(state, device=None) -> dict:
    """A state (mapping, or a dataclass such as the JAX ``ABAState``) of
    numpy leaves -> the same keys holding tensors on ``device``."""
    dev = resolve_device(device)
    if dataclasses.is_dataclass(state):
        state = {f.name: getattr(state, f.name)
                 for f in dataclasses.fields(state)}
    out = {}
    for name, leaf in state.items():
        if isinstance(leaf, (tuple, list)):
            out[name] = tuple(_leaf_to_tensor(a, dev) for a in leaf)
        else:
            out[name] = _leaf_to_tensor(leaf, dev)
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's state dict -> the same keys holding numpy arrays."""
    out = {}
    for name, leaf in state.items():
        if isinstance(leaf, (tuple, list)):
            out[name] = tuple(t.detach().cpu().numpy() for t in leaf)
        else:
            out[name] = leaf.detach().cpu().numpy()
    return out


def abastate_from_numpy(state, device=None):
    """A state with the ``ABAState`` fields (the JAX dataclass, a mapping,
    any object with those attributes) -> the port's
    :class:`repro_torch.anticluster.ABAState` on ``device``."""
    from repro_torch.anticluster import ABAState

    if not isinstance(state, dict):
        state = {f.name: getattr(state, f.name)
                 for f in dataclasses.fields(ABAState)}
    t = state_from_numpy(state, device)
    return ABAState(prices=tuple(t["prices"]),
                    moment_sum=t["moment_sum"].float(),
                    moment_count=t["moment_count"].float(),
                    prev_labels=t["prev_labels"])


def abastate_to_numpy(state) -> dict:
    """The port's ``ABAState`` -> a dict of its fields as numpy arrays
    (``prices`` a tuple)."""
    return state_to_numpy({f.name: getattr(state, f.name)
                           for f in dataclasses.fields(state)})
