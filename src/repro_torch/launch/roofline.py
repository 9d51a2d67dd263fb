"""Roofline accounting for the port on NVIDIA H100 nodes (port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs            / (cards * PEAK_FLOPS)
    memory     = HBM bytes        / (cards * HBM_BW)
    collective = sum over the ops of a rank of link bytes / its line's rate

The constants are those of one ``NVIDIA H100 80GB HBM3, 700.00 W`` (the
SXM part) and of the nodes that hold it; none is measured here:

* ``PEAK_FLOPS`` 989e12 bf16 FLOP/s (dense, without sparsity) and
  ``HBM_BW`` 3.35e12 B/s: NVIDIA's H100 data sheet, SXM column, at the
  700 W power limit;
* ``NVLINK_BW`` 450e9 B/s a direction: the data sheet's 900 GB/s of
  fourth-generation NVLink a card, counted both ways; a line of ranks
  inside one node of :data:`repro_torch.launch.mesh.GPUS_PER_NODE` cards
  rides it;
* ``IB_BW`` 50e9 B/s a direction: one 400 Gb/s NDR InfiniBand port (a
  ConnectX-7) a card, as NVIDIA's DGX H100 system guide lays a node out;
  a line that crosses nodes rides it.

The FLOPs and HBM bytes are the reference's analytic workload model,
copied unchanged (framework-free arithmetic on the config; MODEL_FLOPS =
6·N_active·D is reported beside it as the useful-compute ratio). The
reference parses its compiled HLO for the collectives; the port has no
HLO, so the dry-run (:mod:`repro_torch.launch.dryrun`) records each
collective a rank's step issues (its op, its line, its payload) and
:class:`CollectiveOp` keeps the reference's per-op link-byte model:
all-reduce 2(n-1)/n x the buffer, all-gather (n-1) x the shard (that is
(n-1)/n x the gathered buffer), reduce-scatter and all-to-all (n-1)/n x
the buffer, permute 1x.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs.base import InputShape, ModelConfig

# one H100 SXM card and its node (see the module doc for the sources)
PEAK_FLOPS = 989e12        # bf16 FLOP/s a card
HBM_BW = 3.35e12           # B/s a card
NVLINK_BW = 450e9          # B/s a direction a card, inside a node
IB_BW = 50e9               # B/s a direction a card, between nodes


@dataclass
class CollectiveOp:
    """One collective a rank issues: ``kind`` (the reference's HLO names:
    ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), its per-rank payload (all-gather: the
    shard), its group's size, the mesh line it runs on (``data`` /
    ``model``) and whether that line crosses nodes."""

    kind: str
    bytes_payload: int
    group_size: int
    line: str = "data"
    crosses_nodes: bool = True
    multiplier: int = 1

    @property
    def link_bytes(self) -> float:
        """Per-card link traffic (the reference's model, see the module
        doc)."""
        n = max(self.group_size, 1)
        if self.kind == "all-reduce":
            f = 2.0 * (n - 1) / n
        elif self.kind == "all-gather":
            f = float(n - 1)
        elif self.kind in ("reduce-scatter", "all-to-all"):
            f = (n - 1) / n
        else:  # collective-permute
            f = 1.0
        return self.bytes_payload * f * self.multiplier

    @property
    def seconds(self) -> float:
        """Its link bytes over its line's rate (NVLink inside a node,
        InfiniBand across nodes)."""
        return self.link_bytes / (IB_BW if self.crosses_nodes
                                  else NVLINK_BW)


def collective_summary(ops: List[CollectiveOp]
                       ) -> Dict[str, Dict[str, float]]:
    """``{kind: {count, link_bytes}}`` and ``{"by_line": {line: {kind:
    {count, link_bytes}}}}`` (the reference's summary, and the lines)."""
    out: Dict[str, Dict[str, float]] = {}
    lines: Dict[str, Dict[str, Dict[str, float]]] = {}
    for op in ops:
        for d in (out.setdefault(op.kind, {"count": 0, "link_bytes": 0.0}),
                  lines.setdefault(op.line, {}).setdefault(
                      op.kind, {"count": 0, "link_bytes": 0.0})):
            d["count"] += op.multiplier
            d["link_bytes"] += op.link_bytes
    out["_by_line"] = lines
    return out


# ---------------------------------------------------------------------------
# analytic workload model (the reference's, unchanged)
# ---------------------------------------------------------------------------

def _attn_flops_fwd(cfg: ModelConfig, batch: int, seq: int,
                    kv_len: Optional[int] = None) -> float:
    if cfg.num_heads == 0:
        return 0.0
    kv_len = seq if kv_len is None else kv_len
    eff = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len
    if kv_len == seq and seq > 1:
        eff_avg = eff / 2 if cfg.sliding_window is None else (
            eff * (1 - eff / (2 * max(seq, 1))))  # causal and/or banded
    else:
        eff_avg = eff
    n_layers = (cfg.num_layers if cfg.family != "hybrid"
                else cfg.num_layers // cfg.hybrid_attn_every)
    # QK^T + PV
    return 4.0 * batch * seq * eff_avg * cfg.num_heads * cfg.head_dim * n_layers


def _ssd_flops_fwd(cfg: ModelConfig, batch: int, seq: int) -> float:
    if cfg.ssm is None:
        return 0.0
    c = cfg.ssm
    h = c.num_heads(cfg.d_model)
    n, p, ch = c.d_state, c.head_dim, c.chunk_size
    if seq == 1:
        return batch * h * (4.0 * n * p)  # recurrent step
    # per token: CB row (c*n), W@x (c*p), state in/out (2*n*p/c * c)
    per_tok = 2.0 * ch * n + 2.0 * ch * p + 4.0 * n * p
    return batch * seq * h * per_tok * cfg.num_layers


def analytic_flops(cfg: ModelConfig, shape: InputShape) -> Dict[str, float]:
    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = b * s
        matmul = 6.0 * n_active * tokens            # fwd(2) + bwd(4)
        attn = 3.0 * _attn_flops_fwd(cfg, b, s)
        ssd = 3.0 * _ssd_flops_fwd(cfg, b, s)
        # remat="dots" (selective recomputation) saves matmul outputs: the
        # re-forward repeats only cheap elementwise ops — no matmul FLOPs.
        no_refwd = cfg.remat in ("none", "dots")
        remat = 1.0 if no_refwd else (
            2.0 * n_active * tokens + _attn_flops_fwd(cfg, b, s)
            + _ssd_flops_fwd(cfg, b, s))            # re-run fwd
        total = matmul + attn + ssd + (0.0 if no_refwd else remat)
        model = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = b * s
        total = 2.0 * n_active * tokens + _attn_flops_fwd(cfg, b, s) \
            + _ssd_flops_fwd(cfg, b, s)
        model = 2.0 * n_active * tokens
    else:  # decode: one token against a seq_len cache
        tokens = b
        total = 2.0 * n_active * tokens \
            + _attn_flops_fwd(cfg, b, 1, kv_len=s) + _ssd_flops_fwd(cfg, b, 1)
        model = 2.0 * n_active * tokens
    return {"total": total, "model": model}


def analytic_hbm_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    """First-order HBM traffic model (per step, global)."""
    b, s = shape.global_batch, shape.seq_len
    pb = {"bfloat16": 2, "float32": 4}[cfg.param_dtype]
    ob = {"bfloat16": 2, "float32": 4}[cfg.optimizer_dtype]
    n_total = cfg.param_count()
    n_active = cfg.active_param_count()
    d = cfg.d_model
    act_b = 2  # bf16 activations
    if shape.kind == "train":
        # weights: fwd read + bwd read + grad write; opt: m,v read+write, p write
        w = n_total * (3 * pb + 4 * ob + pb)
        # activations: residual stream + block internals, written+read once
        # (remat recomputes instead of storing internals -> factor ~8 d_model)
        acts = b * s * d * cfg.num_layers * act_b * 8
        return w + acts
    if shape.kind == "prefill":
        w = n_total * pb
        acts = b * s * d * cfg.num_layers * act_b * 4
        kv = (0 if cfg.num_heads == 0 else
              b * s * cfg.kv_dim * 2 * act_b * _attn_layers(cfg))
        return w + acts + kv
    # decode: every ACTIVE weight read once; KV cache read; states
    w = n_active * pb
    eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
    kv_b = 1 if "kv_fp8" in cfg.opts else act_b  # OPT(kv_fp8): 1-byte cache
    kv = (0 if cfg.num_heads == 0 else
          b * eff * cfg.kv_dim * max(1, cfg.decode_kv_expand)
          * 2 * kv_b * _attn_layers(cfg))
    ssm = 0.0
    if cfg.ssm is not None:
        c = cfg.ssm
        h = c.num_heads(cfg.d_model)
        ssm = b * h * c.d_state * c.head_dim * 4 * 2 * cfg.num_layers
    return w + kv + ssm


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.num_heads == 0:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_total: float
    flops_model: float
    hbm_bytes: float
    link_bytes_per_chip: float
    collective_seconds: float
    collectives: Dict[str, Dict[str, float]]
    memory_per_chip: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops_total / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_seconds

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def model_ratio(self) -> float:
        return self.flops_model / max(self.flops_total, 1.0)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "flops_total": self.flops_total, "flops_model": self.flops_model,
            "model_ratio": self.model_ratio,
            "hbm_bytes": self.hbm_bytes,
            "link_bytes_per_chip": self.link_bytes_per_chip,
            "collectives": self.collectives,
            "memory_per_chip": self.memory_per_chip,
        }


def build_roofline(cfg: ModelConfig, shape: InputShape, mesh_name: str,
                   chips: int, ops: List[CollectiveOp],
                   mem: Optional[dict]) -> Roofline:
    """The row of one (arch x shape x mesh): the analytic FLOPs and bytes,
    the collectives one rank's step issued (``ops``)."""
    summ = collective_summary(ops)
    summ["_structure"] = {"collective_count": float(
        sum(op.multiplier for op in ops))}
    fl = analytic_flops(cfg, shape)
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_total=fl["total"], flops_model=fl["model"],
        hbm_bytes=analytic_hbm_bytes(cfg, shape),
        link_bytes_per_chip=sum(op.link_bytes for op in ops),
        collective_seconds=sum(op.seconds for op in ops),
        collectives=summ,
        memory_per_chip=mem,
    )
