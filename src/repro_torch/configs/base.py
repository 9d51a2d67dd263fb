"""Config dataclasses for the repro framework.

Every assigned architecture gets one module in this package defining a
``CONFIG: ModelConfig`` with the exact published numbers (citation in the
module docstring). The smoke-test reduction (``smoke()``) preserves the
*family* (dense/moe/ssm/hybrid/vlm/audio) while shrinking every dimension to
CPU scale, per the assignment (<=2 layers, d_model<=512, <=4 experts).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    # inference headroom: static-shape TPU MoE requires a capacity bound;
    # drops under extreme router skew are the documented approximation
    # (GShard/Switch semantics). Tests that need exactness set this to
    # num_experts, which makes C >= S (provably drop-free).
    capacity_factor_eval: float = 2.0
    # Arctic keeps a small dense ("residual") FFN in parallel with the MoE
    # FFN on every layer [hf:Snowflake/snowflake-arctic-base].
    dense_residual: bool = False


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters [arXiv:2405.21060]."""

    d_state: int = 128
    head_dim: int = 64          # SSD "P" — value-head dim
    expand: int = 2             # d_inner = expand * d_model
    chunk_size: int = 256       # SSD chunk length for the blocked scan
    conv_width: int = 4         # causal depthwise conv window
    ngroups: int = 1            # B/C groups (GVA); 1 == multi-value attention

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- block structure ---------------------------------------------------
    hidden_act: str = "silu"     # "gelu" => GeGLU gating, "silu" => SwiGLU
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparametric
    use_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False  # attention and FFN in parallel (command-r)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA window; None => full causal

    # --- mixtures / state-space / hybrid ------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared-weight* attention block applied every
    # ``hybrid_attn_every`` backbone blocks [arXiv:2411.15242].
    hybrid_attn_every: int = 0

    # --- modality frontends (stubbed per the assignment carve-out) ----------
    modality: str = "text"       # text | vlm | audio
    num_patches: int = 0         # VLM: precomputed patch embeddings per image
    num_codebooks: int = 1       # audio: EnCodec codebook streams

    # --- numerics / memory ---------------------------------------------------
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "bfloat16"    # stored parameter dtype
    optimizer_dtype: str = "float32"  # Adam moment dtype (arctic: bfloat16)
    remat: str = "block"             # none | block | full

    # --- beyond-paper optimization toggles (EXPERIMENTS.md §Perf) -----------
    # "moe_dispatch"  shard the MoE dispatch buffer over the batch axes when
    #                 experts don't divide (baseline replicates it — the
    #                 Fig-17-style mapping mismatch, at the sharding level)
    # "decode_cache"  force the in-model KV-cache constraint to match the
    #                 input layout exactly (kills involuntary resharding)
    # "fsdp"          pure-FSDP parameter layout over (data x model) instead
    #                 of TP(model) x FSDP(data) — wins when weight traffic
    #                 < activation all-reduce traffic
    # "bf16_grads"    custom-vjp boundary after each pre-matmul norm: the
    #                 backward TP all-reduces carry bf16 (not f32) payloads
    opts: Tuple[str, ...] = ()
    # OPT(decode_cache): store each KV head ``decode_kv_expand`` times so
    # stored heads == TP degree — the cache shards over 'model' exactly like
    # the q heads, decode attention is fully local, and the per-token cache
    # write lands on an UNsharded dim (no involuntary gather). 2x KV memory.
    decode_kv_expand: int = 1

    # citation for the exact numbers above
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family in ("ssm",):
            assert self.num_heads == 0 and self.ssm is not None
        if self.family in ("moe",):
            assert self.moe is not None
        if self.family == "hybrid":
            assert self.ssm is not None and self.hybrid_attn_every > 0
        if self.num_heads:
            assert self.head_dim * self.num_heads >= self.d_model // 2

    # --- derived sizes -------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def attn_params(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model

    def ffn_params_dense(self, d_ff: Optional[int] = None) -> int:
        d_ff = self.d_ff if d_ff is None else d_ff
        return 3 * self.d_model * d_ff  # gated (w_gate, w_up, w_down)

    def ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        c = self.ssm
        d_in = c.d_inner(self.d_model)
        nheads = c.num_heads(self.d_model)
        # in_proj emits [z, x, B, C, dt]; out_proj returns to d_model.
        d_bc = 2 * c.ngroups * c.d_state
        in_proj = self.d_model * (2 * d_in + d_bc + nheads)
        conv = (d_in + d_bc) * c.conv_width
        return in_proj + conv + nheads * 2 + d_in * self.d_model  # + A, D + out

    def layer_params(self) -> int:
        """Parameters of ONE backbone layer (attention archs) or block (ssm)."""
        if self.family == "ssm":
            return self.ssm_params()
        p = self.attn_params()
        if self.moe is not None:
            p += self.moe.num_experts * self.ffn_params_dense()
            p += self.d_model * self.moe.num_experts  # router
            if self.moe.dense_residual:
                p += self.ffn_params_dense()
        else:
            p += self.ffn_params_dense()
        return p

    def param_count(self) -> int:
        """Approximate total params (embeddings + layers + head)."""
        embed = self.vocab_size * self.d_model * self.num_codebooks
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model * self.num_codebooks
        if self.family == "hybrid":
            body = self.num_layers * self.ssm_params()
            # ONE shared attention block (+ its FFN), reused at each interleave
            shared = self.attn_params() + self.ffn_params_dense()
            body += shared  # weights are shared => counted once
        else:
            body = self.num_layers * self.layer_params()
        return embed + head + body

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_layer_active = self.attn_params() + m.top_k * self.ffn_params_dense()
        per_layer_active += self.d_model * m.num_experts
        if m.dense_residual:
            per_layer_active += self.ffn_params_dense()
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return embed + head + self.num_layers * per_layer_active

    # ------------------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=256,
            d_ff=0 if self.family == "ssm" else 512,
            vocab_size=512,
            num_heads=0 if self.num_heads == 0 else 4,
            num_kv_heads=0 if self.num_heads == 0 else min(self.num_kv_heads, 2),
            head_dim=64,
            num_patches=min(self.num_patches, 16),
            sliding_window=None if self.sliding_window is None else 64,
            dtype="float32",
            param_dtype="float32",
            remat="none",
        )
        if self.moe is not None:
            changes["moe"] = replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2)
            )
        if self.ssm is not None:
            changes["ssm"] = replace(self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        return replace(self, **changes)

    def with_opts(self, *opts: str) -> "ModelConfig":
        known = {"moe_dispatch", "decode_cache", "fsdp", "bf16_grads",
                 "serve_resident", "kv_fp8"}
        bad = set(opts) - known
        if bad:
            raise ValueError(f"unknown opts {bad}; known: {known}")
        return replace(self, opts=tuple(sorted(set(self.opts) | set(opts))))

    def with_sliding_window(self, window: int = 4096) -> "ModelConfig":
        """SWA variant used by full-attention archs for the long_500k shape."""
        if self.sliding_window is not None and self.sliding_window <= window:
            return self
        return replace(self, name=self.name + f"-swa{window}", sliding_window=window)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS/token = 6*N (dense) or 6*N_active (MoE) [Kaplan/Chinchilla]."""
    return 6.0 * cfg.active_param_count()


def human(n: float) -> str:
    for unit in ("", "K", "M", "B", "T", "P", "E"):
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Z"
