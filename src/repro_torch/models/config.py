"""Model configuration for the 10 assigned architectures.

A copy of ``repro/models/config.py``, which imports no JAX; the port keeps
its own.  A model is a stack of ``n_layers`` layers described by a
repeating *block pattern* (`pattern`), each entry a ``LayerSpec``.  The
reference stacks the parameters per pattern position with a leading
``n_blocks = n_layers / len(pattern)`` dim and scans them; the port keeps
that layout in ``model_defs`` and runs the blocks in a Python loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    n_shared: int = 0            # deepseek shared experts (dense path)
    d_expert: int = 0            # per-expert ffn hidden
    renorm: bool = True          # renormalize top-k probs
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLASpec:
    q_lora: int = 0              # 0 -> full-rank q projection
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    scan_chunk: int = 1          # timesteps unrolled per scan step (S`Perf:
                                 # lets XLA keep the SSM state in registers
                                 # across the chunk; 1 = paper-faithful
                                 # per-step recurrence)


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating block pattern."""
    mixer: str = "attn"          # "attn" | "mla" | "mamba"
    mlp: str = "dense"           # "dense" | "moe" | "none"
    sliding_window: int = 0      # 0 -> global attention
    cross_attn: bool = False     # whisper decoder
    encoder: bool = False        # whisper encoder (non-causal self-attn)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # attention details
    qkv_bias: bool = False
    attn_softcap: float = 0.0    # gemma2: 50.0
    logit_softcap: float = 0.0   # gemma2: 30.0
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (pairs per section)

    # mlp
    mlp_act: str = "silu"        # silu | gelu (GeGLU when gated)

    # norms / embeddings
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    post_block_norm: bool = False  # gemma2 post-norms
    scale_embed: bool = False    # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = False

    moe: MoESpec | None = None
    mla: MLASpec | None = None
    ssm: SSMSpec | None = None

    # encoder-decoder (whisper): encoder layers w/ non-causal self-attn
    enc_layers: int = 0
    enc_ctx: int = 1500          # whisper frame positions after conv stub

    # modality frontends are STUBS: extra embedded inputs concatenated
    # ahead of the token stream ("vlm" patches / "audio" frames)
    frontend: str = "none"       # none | vision | audio

    # training-time details
    remat: bool = True
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # S`Perf knobs (defaults = paper-faithful baseline)
    embed_shard: str = "vocab"   # "vocab" (Megatron) | "dmodel" (untied only:
                                 # gather needs no collective)
    seq_parallel: bool = False   # shard the residual stream's seq dim over
                                 # 'model' between blocks (Megatron-SP):
                                 # divides remat-saved activations by tp

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            self.name, self.n_layers, len(self.pattern))

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to the 16-way 'model' axis (granite: 49155 ->
        49168; whisper: 51865 -> 51872).  Padded logits are masked to -1e30
        in logits_from_hidden, so loss/argmax are exact."""
        return -(-self.vocab_size // 16) * 16

    @property
    def dt_rank(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    def reduced(self, **over) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=len(self.pattern) * min(2, self.n_blocks),
            d_model=64, n_heads=4, n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16, d_ff=128, vocab_size=256,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_ctx=16 if self.enc_layers else self.enc_ctx,
            attn_chunk_q=16, attn_chunk_kv=16,
            param_dtype="float32", compute_dtype="float32",
            name=self.name + "-smoke",
        )
        if self.moe:
            # capacity_factor >= E/k guarantees zero drops, making smoke
            # outputs exactly mesh-independent (drops depend on local T).
            base["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                d_expert=32, n_shared=min(self.moe.n_shared, 1),
                capacity_factor=8.0)
        if self.mla:
            base["mla"] = MLASpec(q_lora=32 if self.mla.q_lora else 0,
                                  kv_lora=32, qk_nope_dim=16, qk_rope_dim=8,
                                  v_dim=16)
        if self.ssm:
            base["ssm"] = SSMSpec(d_state=4, d_conv=4, expand=2, dt_rank=8)
        if self.mrope_sections:
            half = base["head_dim"] // 2
            t = half // 4
            base["mrope_sections"] = (half - 2 * ((half - t) // 2),
                                      (half - t) // 2, (half - t) // 2)
        base.update(over)
        return dataclasses.replace(self, **base)
