"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
-- local+global alternating attention, logit softcap.  [arXiv:2408.00118]"""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_ff=9216, vocab_size=256000, head_dim=256,
        attn_softcap=50.0, logit_softcap=30.0,
        mlp_act="gelu", scale_embed=True, tie_embeddings=True,
        post_block_norm=True,
        pattern=(LayerSpec(mixer="attn", mlp="dense", sliding_window=4096),
                 LayerSpec(mixer="attn", mlp="dense")),
    )
