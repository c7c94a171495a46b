"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 -- mamba1 architecture.  [arXiv:2410.05355]"""
from repro_torch.models.config import LayerSpec, ModelConfig, SSMSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=65024, head_dim=64,
        pattern=(LayerSpec(mixer="mamba", mlp="none"),),
        ssm=SSMSpec(d_state=16, d_conv=4, expand=2, scan_chunk=16),
    )
