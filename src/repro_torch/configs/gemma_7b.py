"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 -- GeGLU, head_dim=256.  [arXiv:2403.08295]"""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        d_ff=24576, vocab_size=256000, head_dim=256,
        mlp_act="gelu", scale_embed=True, tie_embeddings=True,
        pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    )
