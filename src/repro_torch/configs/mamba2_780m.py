"""mamba2-780m [arXiv:2405.21060] — attention-free SSD (state-space duality)."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)
