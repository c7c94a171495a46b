"""Registry mapping --arch ids to their ModelConfig: one module per arch
lives in ``repro_torch/configs`` (copies of the reference's), and this
registry, a copy of ``repro/models/registry.py``, is the single lookup
point."""

from __future__ import annotations

import importlib

ARCHS = (
    "qwen2p5_14b",
    "gemma2_2b",
    "gemma_7b",
    "smollm_360m",
    "jamba_v0p1_52b",
    "deepseek_v2_236b",
    "granite_moe_3b",
    "qwen2_vl_7b",
    "falcon_mamba_7b",
    "whisper_medium",
)

ALIASES = {
    "qwen2.5-14b": "qwen2p5_14b",
    "gemma2-2b": "gemma2_2b",
    "gemma-7b": "gemma_7b",
    "smollm-360m": "smollm_360m",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-medium": "whisper_medium",
}


def get_config(arch: str, *, reduced: bool = False, **over):
    name = ALIASES.get(arch, arch).replace("-", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.config()
    if reduced:
        cfg = cfg.reduced()
    if over:
        import dataclasses
        cfg = dataclasses.replace(cfg, **over)
    return cfg
