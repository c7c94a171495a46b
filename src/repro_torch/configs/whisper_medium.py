"""whisper-medium [audio]: enc-dec 24L d_model=1024 16H d_ff=4096
vocab=51865 -- conv frontend STUB: input_specs() provides precomputed frame
embeddings (B, enc_ctx, D).  [arXiv:2212.04356]"""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51865, head_dim=64,
        norm="layernorm", mlp_act="gelu", frontend="audio",
        enc_layers=24, enc_ctx=1500,
        pattern=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),
    )
