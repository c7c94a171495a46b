"""The model stack of the port (counterpart of ``repro.models``): the
configs and registry of the ten architectures; the SSM family's model
(falcon-mamba-7b), whose Mamba prefill runs the ``ssm_scan`` kernel; the
dense attention family's (smollm-360m, gemma2-2b, gemma-7b,
qwen2.5-14b); the MoE and MLA family's (granite-moe-3b,
deepseek-v2-236b) and the hybrid jamba-v0.1-52b, whose Mamba layers run
``ssm_scan`` too.  Attention, the MLP, the MoE and MLA are plain torch, as
the reference's are plain ``jnp``.  The front ends and training are later
slices (``ROADMAP.md`` Queue 1 item 1)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mla import MLA
from repro_torch.models.moe import MoE
from repro_torch.models.registry import ALIASES, ARCHS, get_config
from repro_torch.models.transformer import Model, init_params

__all__ = ["ALIASES", "ARCHS", "MLA", "Model", "ModelConfig", "MoE",
           "get_config", "init_params", "params_from_jax"]
