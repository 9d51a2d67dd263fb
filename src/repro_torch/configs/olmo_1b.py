"""olmo-1b [arXiv:2402.00838] — dense, non-parametric LayerNorm (no scale/bias)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    hidden_act="silu",
    norm="nonparametric",    # OLMo LN without affine params
    use_bias=False,
    tie_embeddings=True,
    source="arXiv:2402.00838 (OLMo)",
)
