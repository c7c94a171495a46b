"""Error-feedback int8 gradient compression over the data-parallel shards.

Counterpart of ``repro/train/compression.py``.  The gradient all-reduce is
a reduce-scatter and an all-gather, both legs carried in int8 with a
float32 scale a leaf that the shards agree on (the largest of their maxima);
the reduce accumulates in int32.  The quantization error is kept in an
error-feedback state and added back at the next step (Karimireddy et al.
2019).

The reference runs the exchange inside ``shard_map``; here it is a host
loop over the data shards, as ``core/sharded.py`` runs ``shard_map``: each
shard's gradients, then the agreed maximum, the int8 quantization, the
int32 sum, the requantization with the second agreed scale, the gather and
the error feedback.  After the float quantization everything is integer
work or the same float32 operations on the same values, so the mean and
the error state are bitwise the reference's.  A leaf is the reference's
leaf: a block leaf's scale is agreed over all its blocks, as the
reference's is over its stacked array (the reduce-scatter's split of the
flattened leaf changes no value: every step is elementwise but the two
maxima).

* :func:`ef_allreduce` ``(grads, err_state)``: one tree a shard of each,
  keyed as ``optimizer.grads_of``; returns the mean (one tree a shard, all
  equal) and each shard's new error state.
* :func:`make_compressed_dp_train_step` ``(cfg, mesh, opt_cfg)``: the
  replicated-model data-parallel step (per-shard gradients -> compressed
  mean -> AdamW), used by ``launch/train.py --grad-compression``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as T
from repro_torch.train.optimizer import OptConfig, adamw_update, grads_of


def init_error_state(model) -> dict:
    """Zero error feedback, float32, keyed as ``optimizer.grads_of``."""
    return {(path, b): torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            for path, b, p in model.leaves()}


def _quantize(v, scale):
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def _agreed_scale(pieces) -> torch.Tensor:
    """``max(max |piece|, 1e-12) / 127`` over every shard's pieces: the
    scale the shards agree on (the reference's ``pmax``)."""
    gmax = torch.stack([p.abs().max() for p in pieces]).max()
    return torch.clamp(gmax, min=1e-12) / 127.0


def _compress_leaf(gs, errs):
    """One leaf's int8 error-feedback all-reduce-mean.  ``gs[s]`` and
    ``errs[s]`` are shard ``s``'s pieces of the leaf (its blocks, or the one
    tensor).  Returns (the mean's pieces, each shard's new error pieces)."""
    n_dev = len(gs)
    flat = [[g.float() + e for g, e in zip(gp, ep)]
            for gp, ep in zip(gs, errs)]
    scale = _agreed_scale([p for sp in flat for p in sp])
    qs = [[_quantize(p, scale) for p in sp] for sp in flat]
    new_err = [[p - q.float() * scale for p, q in zip(sp, sq)]
               for sp, sq in zip(flat, qs)]
    # leg 1: the reduce-scatter, int32 sums of the int8 payload
    total = [sum(sq[k].to(torch.int32) for sq in qs)
             for k in range(len(qs[0]))]
    mean = [t.float() * scale / n_dev for t in total]
    # leg 2: requantize with the second agreed scale, then the gather
    s2 = _agreed_scale(mean)
    out = [_quantize(m, s2).float() * s2 for m in mean]
    return out, new_err


def ef_allreduce(grads, err_state):
    """The compressed mean over the data shards: ``grads`` and
    ``err_state`` hold one tree a shard (keyed as ``optimizer.grads_of``),
    all on one device.  Returns (the mean, one tree a shard, all equal;
    each shard's new error state)."""
    n = len(grads)
    if len(err_state) != n:
        raise ValueError(f"{n} shards of gradients, {len(err_state)} of "
                         "error state")
    leaves: dict = {}
    for key in grads[0]:
        leaves.setdefault(key[0], []).append(key)
    means = [dict() for _ in range(n)]
    errs = [dict() for _ in range(n)]
    for keys in leaves.values():
        out, new_err = _compress_leaf([[g[k] for k in keys] for g in grads],
                                      [[e[k] for k in keys] for e in err_state])
        for s in range(n):
            for k, o, e in zip(keys, out, new_err[s]):
                means[s][k] = o
                errs[s][k] = e
    return means, errs


def make_compressed_dp_train_step(cfg, mesh, opt_cfg: OptConfig = OptConfig(),
                                  axes: tuple[str, ...] = ("data",),
                                  loss_chunk: int = 512):
    """Replicated-model data-parallel train step with the compressed
    gradient exchange: ``step(model, opt_state, err, batch) -> (model,
    opt_state, err, metrics)``.

    The batch splits over the shards of ``axes`` (those the mesh has), in
    order; each shard's loss and gradients are computed with the one model,
    one shard after another on the model's device (the mesh gives the
    shard count; a replica a card is not ported); ``err`` is the error
    state, one
    tree that every shard starts from (:func:`init_error_state`) or one a
    shard, and the step returns one a shard, each shard's own, as the
    reference's devices keep theirs.  The loss is the shards' mean, the
    update AdamW with the compressed mean.
    """
    axis_names = tuple(a for a in axes if a in mesh.axis_names)
    n_shards = math.prod(mesh.shape[a] for a in axis_names)

    def step(model, opt_state, err, batch):
        n = batch["tokens"].shape[0]
        if n % n_shards:
            raise ValueError(f"batch of {n} does not split over {n_shards} "
                             "data shards")
        size = n // n_shards
        model.requires_grad_(True)
        grads, losses = [], []
        for s in range(n_shards):
            model.zero_grad(set_to_none=True)
            part = {k: v[s * size:(s + 1) * size] for k, v in batch.items()}
            loss = T.lm_loss(cfg, model, part, loss_chunk=loss_chunk)
            loss.backward()
            grads.append(grads_of(model))
            losses.append(loss.detach())
        model.zero_grad(set_to_none=True)
        errs = err if isinstance(err, (list, tuple)) else [err] * n_shards
        means, errs = ef_allreduce(grads, errs)
        del grads
        loss = sum(losses[1:], losses[0]) / n_shards
        model, opt_state, om = adamw_update(opt_cfg, means[0], opt_state,
                                            model)
        return model, opt_state, errs, {"loss": loss, **om}

    return step
