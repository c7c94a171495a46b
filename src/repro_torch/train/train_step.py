"""train_step / serve_step builders: the functions the launcher executes.

Counterpart of ``repro/train/train_step.py``.  ``make_train_step`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
with optional microbatch gradient accumulation: each microbatch's backward
adds its float32 gradients into the parameters' ``.grad`` (the reference's
scan carry, in the same order), so the peak activation footprint is one
microbatch's.  The step turns the model's gradients on, updates it and the
optimizer state in place (:func:`~repro_torch.train.optimizer.adamw_update`)
and clears the gradients after.

``mesh`` goes to ``lm_loss``, ``prefill`` and ``decode_step``, where it
reaches the MoE only (``transformer._moe_call``: each data shard's
experts over the ``model`` axis); the reference's other uses of its mesh
constrain shardings and leave the arithmetic as it is without one.  The
rest of the step runs on the model's device.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.train.optimizer import OptConfig, adamw_update, grads_of


def make_train_step(cfg, mesh=None, opt_cfg: OptConfig = OptConfig(),
                    microbatches: int = 1, loss_chunk: int = 512):
    """Build the train step for a model config (see the module's doc)."""

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        n = batch["tokens"].shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} does not split into "
                             f"{microbatches} microbatches")
        size = n // microbatches
        loss = None
        for i in range(microbatches):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            part = T.lm_loss(cfg, model, micro, mesh=mesh,
                             loss_chunk=loss_chunk)
            part.backward()
            part = part.detach()
            loss = part if loss is None else loss + part
        grads = grads_of(model)
        if microbatches > 1:
            loss = loss / microbatches
            for g in grads.values():
                g.div_(microbatches)
        model, opt_state, om = adamw_update(opt_cfg, grads, opt_state, model)
        model.zero_grad(set_to_none=True)
        return model, opt_state, {"loss": loss, **om}

    return train_step


def make_serve_step(cfg, mesh=None):
    """One decode step for a running batch: (model, cache, kv_len, tokens)
    -> (next_tokens (B, 1), logits, cache).  Greedy head (sampling lives in
    ``repro_torch.serve.generate``)."""

    @torch.no_grad()
    def serve_step(model, cache, kv_len, tokens):
        logits, cache = T.decode_step(cfg, model, cache, kv_len, tokens,
                                      mesh=mesh)
        nxt = logits[:, -1, :].argmax(-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return serve_step


def make_prefill_step(cfg, mesh, max_len: int):
    """``prefill_step(model, tokens, extra=None, enc_frames=None) ->
    (last-position logits, cache)`` at ``max_len``."""

    @torch.no_grad()
    def prefill_step(model, tokens, extra=None, enc_frames=None):
        return T.prefill(cfg, model, tokens, max_len, extra_embeds=extra,
                         enc_frames=enc_frames, mesh=mesh)

    return prefill_step
