"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 -- Mamba+attn 1:7 interleave, MoE every other
layer.  [arXiv:2403.19887]"""
from repro_torch.models.config import (LayerSpec, ModelConfig,
                                      MoESpec, SSMSpec)


def config() -> ModelConfig:
    # 8-layer period: attn at index 4; MoE on odd indices (1:1 with dense).
    pat = tuple(
        LayerSpec(mixer="attn" if i == 4 else "mamba",
                  mlp="moe" if i % 2 == 1 else "dense")
        for i in range(8))
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536, head_dim=128,
        pattern=pat, norm="rmsnorm", mlp_act="silu",
        moe=MoESpec(n_experts=16, top_k=2, d_expert=14336),
        ssm=SSMSpec(d_state=16, d_conv=4, expand=2, scan_chunk=16),
    )
