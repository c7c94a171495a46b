"""AdamW + LR schedule over the port's :class:`~repro_torch.models.Model`.

Counterpart of ``repro/train/optimizer.py``.  Moments are float32 whatever
the parameters' dtype, and the update runs in float32; global-norm clipping
included.  The optimizer state is keyed by the reference's leaf paths
(``"blocks/L0/attn/in_proj"``, ``"final_norm"``, ...): ``m`` and ``v`` hold
each leaf at the reference's shape, a block leaf **stacked** on a leading
``n_blocks`` axis, so that a checkpoint holds the reference's arrays key for
key; block ``b``'s parameter is updated against row ``b`` of its leaf's
moments.

Gradients are a mapping ``{(path, block): tensor}`` with the keys of
``Model.leaves()`` (``block`` None for a top-level leaf): :func:`grads_of`
reads them off a model after ``backward``.

The weight decay applies where the reference's does: to a leaf whose
**stacked** shape (``model_defs``) has rank 2 or more.  Every block leaf is
stacked, so every block's norms, biases, ``conv_b``, ``dt_b`` and
``d_skip`` decay; of the top-level leaves, the 1-D ``final_norm`` and
``final_norm_b`` (and the encoder's) do not.  A test on the port tensor's
own ``ndim`` would skip the decay on all those block leaves.

The update writes the model's parameters and the moments in place (the
reference returns new trees; in place keeps one copy of 16 bytes a
parameter on the card) and returns them.  ``opt_abstract`` and
``opt_pspecs`` are the dry-run's abstract state and its partition specs,
over ``transformer.abstract_params``' and ``param_pspecs``' leaf paths.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch._device import ShapeDtype
from repro_torch.models.transformer import flatten_defs, model_defs


class OptConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then a cosine down to ``min_lr_frac``; float32, as
    the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _leaf_shapes(cfg) -> dict:
    """The reference's leaf paths and their stacked shapes."""
    return {path: tuple(pd.shape)
            for path, pd in flatten_defs(model_defs(cfg)).items()}


def adamw_init(model) -> dict:
    """Zero moments at the reference's (stacked) leaf shapes, on the
    model's device, and step 0 (int32)."""
    dev = next(model.parameters()).device
    shapes = _leaf_shapes(model.cfg)

    def zeros():
        return {path: torch.zeros(shape, dtype=torch.float32, device=dev)
                for path, shape in shapes.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_abstract(abstract_params: dict) -> dict:
    """The state's shapes and dtypes: float32 moments at every leaf's
    shape, an int32 step."""
    moments = {path: ShapeDtype(sd.shape, torch.float32)
               for path, sd in abstract_params.items()}
    return {"m": moments, "v": dict(moments),
            "step": ShapeDtype((), torch.int32)}


def opt_pspecs(param_pspecs: dict) -> dict:
    """The moments take their weights' partition specs (ZeRO: they follow
    the weights' FSDP sharding); the step is replicated."""
    return {"m": param_pspecs, "v": param_pspecs, "step": ()}


def grads_of(model) -> dict:
    """``{(path, block): p.grad}`` for every parameter of ``model``, zeros
    where the backward left no gradient."""
    return {(path, b): (torch.zeros_like(p) if p.grad is None else p.grad)
            for path, b, p in model.leaves()}


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: dict, opt_state: dict, model):
    """One AdamW step of ``model`` by ``grads`` (see :func:`grads_of`):
    clip by the global norm, bias-corrected moments, weight decay by the
    reference's stacked rank.  Updates the parameters and ``m``, ``v`` in
    place; returns ``(model, opt_state, {"lr", "grad_norm"})`` with the
    state's step advanced."""
    step = opt_state["step"]
    lr = lr_at(cfg, step).to(step.device)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip else torch.ones((), device=gnorm.device))
    t = (step + 1).to(torch.float32)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=t.device)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    shapes = _leaf_shapes(model.cfg)
    for path, b, p in model.leaves():
        m, v = opt_state["m"][path], opt_state["v"][path]
        if b is not None:
            m, v = m[b], v[b]
        g = grads[(path, b)].float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if len(shapes[path]) >= 2:
            u = u + cfg.weight_decay * pf
        p.copy_((pf - lr * u).to(p.dtype))
    opt_state["step"] = step + 1
    return model, opt_state, {"lr": lr, "grad_norm": gnorm}
