"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini
decoder + CLIP vision frontend. Per the assignment carve-out the vision
encoder is a STUB: input_specs() provides precomputed patch embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    hidden_act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    modality="vlm",
    num_patches=576,         # 24x24 CLIP patch grid per image tile
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
