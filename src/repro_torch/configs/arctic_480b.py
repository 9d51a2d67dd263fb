"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — 128-expert top-2 MoE
with a parallel dense residual FFN on every layer ("dense-MoE hybrid")."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    hidden_act="silu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual=True),
    optimizer_dtype="bfloat16",   # fp32 moments would not fit 256 chips
    source="hf:Snowflake/snowflake-arctic-base",
)
