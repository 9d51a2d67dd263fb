"""zamba2-7b [arXiv:2411.15242] — hybrid: Mamba2 backbone with a
shared-weight attention block interleaved every N blocks."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,            # d_model / num_heads
    d_ff=14336,
    vocab_size=32_000,
    hidden_act="gelu",
    norm="rmsnorm",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256),
    hybrid_attn_every=6,     # shared attention block every 6 mamba blocks
    source="arXiv:2411.15242 (Zamba2)",
)
