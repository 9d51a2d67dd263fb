"""Each rank's inputs of every (arch x input-shape x mesh), on the meta
device (port of ``repro.launch.inputs``).

The reference builds ``ShapeDtypeStruct`` trees with ``NamedSharding``s
and lets XLA cut them. Here every tree is built by the port's own
``init_params``, ``train_state_init`` and ``init_cache`` on the meta
device (shapes and dtypes, no memory) and cut to one rank's slices by the
:class:`~repro_torch.dist.sharding.Sharder`'s rule table on a mesh that
has coordinates and no process groups (``Sharder(mesh, cfg, rank=r)``):
params and optimizer state, the batch's rows over the data line, and the
decode cache in the port's layout (:func:`repro_torch.serve.engine.
gspmd_cache`). :func:`argument_bytes` sums them, exactly.

The port lays out a decode cache by the reference's ``cache_shardings``
rule (:func:`repro_torch.serve.engine.gspmd_cache_layout`): where the KV
heads do not divide the model axis the sequence goes over ``model``, and
where the batch does not divide the data line (``long_500k``, batch 1)
over every axis, each rank attending its slice and combining the slices'
partial attention; an SSM state's conv channels and heads go over
``model``, where the port's Mamba2 block is tensor-parallel.
:func:`cache_layout` sets both side by side for a row, and they agree on
every production row.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.pipeline import batch_spec, batch_shardings
from repro_torch.dist.sharding import (
    P,
    PartitionSpec,
    Sharder,
    data_axes,
    dp_entry,
    param_shapes,
)
from repro_torch.models.attention import _stored_kv_heads
from repro_torch.models.transformer import DecodeCache
from repro_torch.serve.engine import gspmd_cache, gspmd_cache_layout
from repro_torch.tree import (
    tree_flatten,
    tree_flatten_with_paths,
    tree_leaves,
)
from repro_torch.train.trainer import TrainState, train_state_init


def nbytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _cache_bytes(cache: DecodeCache) -> int:
    return nbytes([cache.kv.k, cache.kv.v] if cache.kv is not None else []) \
        + nbytes(list(cache.ssm) if cache.ssm is not None else [])


# ---------------------------------------------------------------------------
# parameters / train state
# ---------------------------------------------------------------------------

def params_struct(cfg: ModelConfig):
    """The whole param tree on the meta device."""
    return param_shapes(cfg)


def rank_params(cfg: ModelConfig, mesh, rank: int = 0):
    """Rank ``rank``'s slices of every param leaf on ``mesh``, on the meta
    device (the rule table's cut, both dims)."""
    return Sharder(mesh, cfg, rank=rank).shard_params(param_shapes(cfg))


def train_state_struct(cfg: ModelConfig, mesh, rank: int = 0) -> TrainState:
    """Rank ``rank``'s ``comm="gspmd"`` train state on the meta device:
    its param slices and AdamW moments of their shapes in
    ``cfg.optimizer_dtype`` (the reference's ``train_state_struct`` under
    its ``train_state_shardings``)."""
    return train_state_init(cfg, params=rank_params(cfg, mesh, rank),
                            device="meta")


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_struct(cfg: ModelConfig, shape: InputShape, mesh, rank: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s rows of every input on the meta device (rows over
    the data line where they divide, as the reference's
    ``batch_struct_and_shardings``)."""
    split = batch_shardings(cfg, shape, mesh)
    out = {}
    for k, (shp, dt) in batch_spec(cfg, shape, mesh).items():
        rows = split[k].rows(rank, shp[0])
        out[k] = torch.empty((rows.stop - rows.start,) + tuple(shp[1:]),
                             dtype=dt, device="meta")
    return out


def decode_token_struct(cfg: ModelConfig, shape: InputShape, mesh,
                        rank: int = 0) -> torch.Tensor:
    """The decode step's tokens, ``(B, 1)`` (audio ``(B, K, 1)``), all
    rows: the step takes the whole batch and keeps its rows."""
    b = shape.global_batch
    shp = (b, cfg.num_codebooks, 1) if cfg.modality == "audio" else (b, 1)
    return torch.empty(shp, dtype=torch.int32, device="meta")


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, shape: InputShape, mesh,
                 dtype=torch.bfloat16, rank: int = 0,
                 sharder: Optional[Sharder] = None) -> DecodeCache:
    """This rank's decode cache of ``shape`` in the port's layout, on the
    meta device (``kv_fp8`` stores a bf16 cache as fp8). ``sharder`` (a
    step's live Sharder) carries a split sequence's gathers; by default
    the mesh's rank ``rank`` cut without process groups (shapes only)."""
    if sharder is None:
        sharder = Sharder(mesh, cfg, rank=rank)
    return gspmd_cache(cfg, sharder, shape.global_batch, shape.seq_len,
                       dtype=dtype, device="meta")


def _dp(mesh, cfg) -> Tuple[Tuple[str, ...], int]:
    dp = data_axes(mesh, cfg)
    sizes = dict(mesh.shape)
    return dp, int(np.prod([sizes[a] for a in dp]))


def port_cache_specs(cfg: ModelConfig, shape: InputShape, mesh
                     ) -> Dict[str, PartitionSpec]:
    """The port's layout of the stacked cache's leaves (``kv``: ``(L, B,
    S, KV, hd)``, ``conv``: ``(L, B, W-1, CH)``, ``ssd``: ``(L, B, H, N,
    P)``), as specs, read off :func:`gspmd_cache_layout`: rows over the
    data line where they divide, KV heads or the sequence over ``model``,
    or the sequence over every axis; an SSM state's conv channels and
    heads over ``model`` where its block is tensor-parallel."""
    dp, dpn = _dp(mesh, cfg)
    b = shape.global_batch
    lay = gspmd_cache_layout(cfg, Sharder(mesh, cfg, rank=0), b,
                             shape.seq_len)
    lead = dp_entry(dp) if b % dpn == 0 else None
    out = {}
    if cfg.num_heads and cfg.family != "ssm":
        head = "model" if lay.kv_heads < _stored_kv_heads(cfg) else None
        seq = {"model": "model", "mesh": tuple(dp) + ("model",)
               }.get(lay.seq)
        out["kv"] = P(None, lead, seq, head, None)
    if cfg.ssm is not None:
        split = "model" if lay.ssm_parts > 1 else None
        out["conv"] = P(None, lead, None, split)
        out["ssd"] = P(None, lead, split, None, None)
    return out


def reference_cache_specs(cfg: ModelConfig, shape: InputShape, mesh
                          ) -> Dict[str, PartitionSpec]:
    """The reference's ``cache_shardings`` rules for the same leaves:
    batch over the data axes when it divides; KV heads over ``model``
    when they divide, else the sequence; a batch too small: the sequence
    over every axis that divides it; SSM channels and heads over
    ``model``."""
    dp, dpn = _dp(mesh, cfg)
    tp = dict(mesh.shape).get("model", 1)
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.num_heads and cfg.family != "ssm":
        kv = cfg.num_kv_heads * max(1, cfg.decode_kv_expand)
        s_cache = s
        if cfg.sliding_window is not None and cfg.sliding_window < s:
            s_cache = cfg.sliding_window
        if b % dpn == 0 and b >= dpn:
            lead = dp_entry(dp)
            head = "model" if kv % tp == 0 else None
            if head is None and s_cache % tp == 0:
                out["kv"] = P(None, lead, "model", None, None)
            else:
                out["kv"] = P(None, lead, None, head, None)
        elif s_cache % (dpn * tp) == 0:
            out["kv"] = P(None, None, tuple(dp) + ("model",), None, None)
        elif s_cache % tp == 0:
            out["kv"] = P(None, None, "model", None, None)
        else:
            out["kv"] = P(None, None, None, None, None)
    if cfg.ssm is not None:
        c = cfg.ssm
        lead = dp_entry(dp) if b % dpn == 0 and b >= dpn else None
        ch = c.d_inner(cfg.d_model) + 2 * c.ngroups * c.d_state
        h = c.num_heads(cfg.d_model)
        out["conv"] = P(None, lead, None, "model" if ch % tp == 0 else None)
        out["ssd"] = P(None, lead, "model" if h % tp == 0 else None, None,
                       None)
    return out


def cache_layout(cfg: ModelConfig, shape: InputShape, mesh
                 ) -> Dict[str, object]:
    """The port's and the reference's cache specs side by side, and the
    leaves where they differ (``differs``: empty when the layouts
    agree)."""
    port = port_cache_specs(cfg, shape, mesh)
    ref = reference_cache_specs(cfg, shape, mesh)
    return {"port": {k: repr(v) for k, v in port.items()},
            "reference": {k: repr(v) for k, v in ref.items()},
            "differs": sorted(k for k in port if port[k] != ref.get(k))}


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

def argument_bytes(cfg: ModelConfig, shape: InputShape, mesh,
                   rank: int = 0) -> Dict[str, int]:
    """Rank ``rank``'s input bytes of the step of ``shape``, exactly:
    ``params`` and ``opt`` (train), ``batch`` and ``cache`` (prefill,
    decode), and their ``total``."""
    out: Dict[str, int] = {}
    if shape.kind == "train":
        st = train_state_struct(cfg, mesh, rank)
        out["params"] = nbytes(tree_flatten(st.params)[0])
        out["opt"] = nbytes([*tree_flatten(st.opt.m)[0],
                             *tree_flatten(st.opt.v)[0], st.opt.count,
                             st.step])
        out["batch"] = nbytes(list(batch_struct(cfg, shape, mesh,
                                                rank).values()))
    else:
        out["params"] = nbytes(tree_flatten(rank_params(cfg, mesh, rank))[0])
        if shape.kind == "prefill":
            out["batch"] = nbytes(list(batch_struct(cfg, shape, mesh,
                                                    rank).values()))
        else:
            out["batch"] = nbytes([decode_token_struct(cfg, shape, mesh)])
        out["cache"] = _cache_bytes(cache_struct(cfg, shape, mesh,
                                                 rank=rank))
    out["total"] = sum(out.values())
    return out


def param_slice_shapes(cfg: ModelConfig, mesh, rank: int = 0
                       ) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """``{path: shape}`` of rank ``rank``'s slice of every param leaf."""
    cut = Sharder(mesh, cfg, rank=rank)
    shapes = param_shapes(cfg)
    return {p: cut.local_shape(p) for p, _ in tree_flatten_with_paths(shapes)}


__all__ = [
    "argument_bytes",
    "batch_struct",
    "cache_layout",
    "cache_struct",
    "decode_token_struct",
    "nbytes",
    "param_slice_shapes",
    "params_struct",
    "port_cache_specs",
    "rank_params",
    "reference_cache_specs",
    "train_state_struct",
]
