"""yi-9b [arXiv:2403.04652] — llama-architecture dense GQA."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    hidden_act="silu",       # SwiGLU
    norm="rmsnorm",
    rope_theta=10_000.0,
    source="arXiv:2403.04652 (Yi)",
)
