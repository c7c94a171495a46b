"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
MoE 40e top-8, vocab=49155.  [hf:ibm-granite/granite-3.0-*]"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        pattern=(LayerSpec(mixer="attn", mlp="moe"),),
        moe=MoESpec(n_experts=40, top_k=8, d_expert=512),
        tie_embeddings=True, mlp_act="silu",
    )
