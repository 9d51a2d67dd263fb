"""musicgen-large [arXiv:2306.05284] — decoder-only transformer over EnCodec
tokens (4 codebooks, delay pattern). The EnCodec frontend is a STUB per the
assignment carve-out; the model consumes/emits codebook token streams."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,         # EnCodec codebook size
    hidden_act="gelu",
    norm="layernorm",
    use_bias=True,
    modality="audio",
    num_codebooks=4,
    source="arXiv:2306.05284 (MusicGen)",
)
