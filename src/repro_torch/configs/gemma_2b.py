"""gemma-2b [arXiv:2403.08295] — dense, GeGLU, head_dim=256, MQA (kv=1)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,          # MQA on the 2b model
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    hidden_act="gelu",       # GeGLU
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2403.08295 (Gemma)",
)
