"""Shared building blocks of the model stack: the parameter definition and
the norms.

Counterpart of ``repro/models/layers.py:21-54``.  Each module exposes
``<name>_defs(cfg)`` returning ``{name: PD(shape, logical_axes, fan_in)}``;
the stack (``transformer.py``) builds its parameters, their initialisation
and the reference's stacked layout from the same metadata.  RoPE,
attention and the MLP (the reference's ``layers.py:57-355``) belong to the
attention family, which is not ported yet (``ROADMAP.md`` Queue 1 item 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PD(NamedTuple):
    """Parameter definition: shape + logical sharding tags + init fan-in."""
    shape: tuple
    axes: tuple       # logical tags per dim: 'fsdp' | 'tp' | 'sp' | None
    fan_in: int = 0   # 0 -> zeros/ones init decided by name ('norm'/'bias')


def norm_apply(cfg, w, x, b=None):
    """rmsnorm as ``x / rms(x) * (1 + w)`` (gemma-style, so zero-init is the
    identity) or layernorm (``+ b``), in float32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * w
        if b is not None:
            out = out + b
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * (1.0 + w)
    return out.to(x.dtype)


def norm_defs(cfg, name="norm"):
    d = {name: PD((cfg.d_model,), (None,))}
    if cfg.norm == "layernorm":
        d[name + "_b"] = PD((cfg.d_model,), (None,))
    return d


def register(module: torch.nn.Module, defs: dict, *, device, dtype) -> None:
    """Give ``module`` one uninitialised parameter per ``PD`` of ``defs``,
    under the definition's name (serving only: no gradient)."""
    for name, pd in defs.items():
        module.register_parameter(name, torch.nn.Parameter(
            torch.empty(pd.shape, device=device, dtype=dtype),
            requires_grad=False))
