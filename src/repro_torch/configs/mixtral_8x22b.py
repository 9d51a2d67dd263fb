"""mixtral-8x22b [arXiv:2401.04088] — 8-expert top-2 MoE, GQA, SWA
(per the assignment spec)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32_768,
    hidden_act="silu",
    norm="rmsnorm",
    sliding_window=4096,     # SWA per assignment
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral)",
)
