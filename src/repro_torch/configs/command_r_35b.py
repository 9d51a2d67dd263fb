"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias,
parallel attention+FFN block, LayerNorm, tied embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256_000,
    hidden_act="silu",
    norm="layernorm",
    use_bias=False,
    parallel_block=True,     # Cohere parallel residual block
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
