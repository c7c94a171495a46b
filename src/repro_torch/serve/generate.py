"""Batched generation engine: prefill once, then decode steps.

Counterpart of ``repro/serve/generate.py``.  Static-batch serving (all
requests share a step clock), for every model the stack builds: the SSM
family (falcon-mamba-7b), whose prefill runs every Mamba layer's scan
through ``ops.ssm_scan`` (one kernel launch a layer on the card); the
dense attention family, whose prefill fills the KV cache that each decode
step extends at ``kv_len``; the MoE family (granite-moe-3b), deepseek-v2's
MLA, whose cache holds the compressed latents that the decode steps read
in the absorbed form, and the hybrid jamba-v0.1-52b (Mamba, attention and
MoE layers; ``ssm_scan`` once a Mamba layer), and the front ends:
qwen2-vl-7b with its patch embeddings (``extra_embeds``) and whisper-medium
with its frame embeddings (``enc_frames``, encoded once by the prefill,
whose cross-attention k and v every step reads).  Attention, MoE, MLA, the
encoder and cross-attention are plain torch (the reference's have no
Pallas kernel), and so are the decode steps.  Sampling: greedy, or
with ``temperature > 0`` from a ``torch.Generator`` on the model's device
seeded by ``seed`` (departure P9: not ``jax.random.categorical``'s bits).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import transformer as T


class Generator:
    def __init__(self, cfg, model, *, max_len: int = 512, device=None):
        """Serve ``model`` on ``device`` (default CUDA; the model is moved
        there if it is elsewhere)."""
        self.device = resolve_device(device)
        self.cfg, self.model = cfg, model.to(self.device)
        self.max_len = max_len

    def generate(self, prompts, n_steps: int, *, temperature: float = 0.0,
                 seed: int = 0, enc_frames=None, extra_embeds=None,
                 stop_token: int | None = None) -> np.ndarray:
        """prompts: (B, S_prompt) ints; ``extra_embeds`` (B, P, D) and
        ``enc_frames`` (B, T, D), numpy arrays or tensors, go to the
        prefill on the server's device.  Returns (B, n_steps) int32 tokens:
        the first the prefill's argmax, then greedy or sampled steps,
        stopping early once every row has emitted ``stop_token``."""
        cfg = self.cfg
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                  device=self.device)
        enc_frames, extra_embeds = (
            None if a is None else torch.as_tensor(a, device=self.device)
            for a in (enc_frames, extra_embeds))
        b, s = prompts.shape
        if s + n_steps > self.max_len:
            raise ValueError(f"increase max_len: {s} prompt tokens + "
                             f"{n_steps} steps > {self.max_len}")
        logits, cache = T.prefill(cfg, self.model, prompts, self.max_len,
                                  enc_frames=enc_frames,
                                  extra_embeds=extra_embeds)
        kv_len = s
        tok = logits[:, -1:, :].argmax(-1)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        out = [tok]
        done = np.zeros(b, bool)
        for _ in range(n_steps - 1):
            logits, cache = T.decode_step(cfg, self.model, cache, kv_len, tok)
            last = logits[:, -1, :]
            if temperature > 0:
                probs = torch.softmax(last / max(temperature, 1e-6), dim=-1)
                tok = torch.multinomial(probs, 1, generator=rng)
            else:
                tok = last.argmax(-1, keepdim=True)
            kv_len += 1
            out.append(tok)
            if stop_token is not None:
                done |= tok[:, 0].cpu().numpy() == stop_token
                if done.all():
                    break
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
