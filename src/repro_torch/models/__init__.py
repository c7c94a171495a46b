"""The model stack of the port (counterpart of ``repro.models``): the
configs and registry of the ten architectures; the SSM family's model
(falcon-mamba-7b), whose Mamba prefill runs the ``ssm_scan`` kernel; the
dense attention family's (smollm-360m, gemma2-2b, gemma-7b,
qwen2.5-14b); the MoE and MLA family's (granite-moe-3b,
deepseek-v2-236b) and the hybrid jamba-v0.1-52b, whose Mamba layers run
``ssm_scan`` too; the front ends (qwen2-vl-7b, whisper-medium).
Attention, the MLP, the MoE and MLA are plain torch, as the reference's
are plain ``jnp``.  ``transformer.lm_loss`` is the training loss (the
train step is ``repro_torch.train``); in training the scan's gradient is
the ``ssm_scan_bwd`` kernel."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mla import MLA
from repro_torch.models.moe import MoE
from repro_torch.models.registry import ALIASES, ARCHS, get_config
from repro_torch.models.transformer import Model, init_params

__all__ = ["ALIASES", "ARCHS", "MLA", "Model", "ModelConfig", "MoE",
           "get_config", "init_params", "params_from_jax"]
