"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts top-6.  [arXiv:2405.04434]"""
from repro_torch.models.config import (LayerSpec, MLASpec, ModelConfig,
                                      MoESpec)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab_size=102400, head_dim=128,
        pattern=(LayerSpec(mixer="mla", mlp="moe"),),
        mla=MLASpec(q_lora=1536, kv_lora=512, qk_nope_dim=128,
                    qk_rope_dim=64, v_dim=128),
        moe=MoESpec(n_experts=160, top_k=6, n_shared=2, d_expert=1536,
                    renorm=False),
        rope_theta=10000.0, mlp_act="silu",
    )
