"""Serving: prefill + batched decode with contiguous or paged KV caches.

Port of ``repro.serve.engine`` on one device. The ``ServeEngine`` is the
same host-side continuous-batching loop for the text attention archs:

* mixed-length prompts are LEFT-padded to a common width and prefilled with
  per-row pad masks + shifted RoPE positions, so a request's tokens are
  identical no matter what it is batched with;
* greedy or per-request temperature sampling, per-request ``stop_token``
  and ``max_new_tokens``;
* early slot recycling: a finished slot is re-filled mid-stream by
  prefilling the next request alone and splicing its K/V just below the
  shared write cursor (its ``start`` offset masks everything older);
* ``paged=True`` swaps the contiguous cache for the paged KV cache (page
  pool + per-slot page table, allocation in :mod:`repro_torch.serve.
  paging`): a finished slot's pages return to the pool immediately.

SSM and hybrid archs have no per-row pad mask, a ring cache (a
sliding-window arch whose window is shorter than ``max_len``) reuses its
slots modulo the window, and the audio family's prompts are ``(K, S)``
codebook frames, so none of them left-pads a batch. They take the
reference's grouped equal-length fallback instead: requests are grouped by
prompt length, each group of up to ``batch_size`` is prefilled together
into a fresh cache and decoded until every row stops (``paged=True`` is
turned off for them, as in the reference; audio ignores ``stop_token``, as
there).

The VLM family is not served by the engine: the reference's ``Request``
carries no image, so its engine cannot serve one either. A VLM is served
by :func:`make_prefill` on a batch with ``image_embeds``, then
:func:`make_serve_step` (see :func:`check_servable`).

``mesh`` (a :class:`~repro_torch.core.collectives.RankMesh` of ``(data,
model)`` ranks) with ``comm_plan`` (or ``num_vcis``) selects the manual-TP
path of :mod:`repro_torch.serve.comm`: every rank runs this same host loop
on its own Megatron shard of the params (``params`` is that shard), each
step's collectives ride per-purpose VCI streams along ``model``, and a
contiguous cache holds the rank's batch rows over ``data`` (the sampled
tokens are gathered over ``data`` inside the step, so every rank's loop
sees the whole batch); a paged pool replicates the batch over ``data``
and shards only its KV heads, which is what lets mid-stream admission run
under the mesh. ``cache_bytes_resident`` is then the rank's own cache
(the reference counts its global arrays).

``mesh`` without a comm plan is the reference's GSPMD route: every rank
runs ``Model(cfg, Sharder(mesh, cfg))`` on its slice of the params by the
rule table (:meth:`repro_torch.dist.sharding.Sharder.shard_params`: FSDP
over data, Megatron over model), each layer's data slices gathered where
it runs and every tensor-parallel collective on its model line's single
fallback group (against :class:`ServeCommPlan`'s VCI a purpose). It
serves every family the engine serves (dense and MoE text, paged and
contiguous; SSM, hybrid and audio grouped), and ``make_prefill`` /
``make_serve_step`` serve a VLM too. A contiguous cache splits its rows
over the data line where they divide (the sampled tokens are gathered back
over it) and its KV heads over ``model`` where the attention is
tensor-parallel. Where the KV heads do not divide the model axis (gemma's
one, yi-9b's four at model 8) it splits the sequence over ``model``
instead, and where the batch does not divide the data line (one long
request) over the data line and ``model`` together: the reference's
``cache_shardings`` rule (:func:`gspmd_cache_layout`). Each rank then
writes and attends its slice of the positions, and one gather a layer
combines the slices (:mod:`repro_torch.models.attention`). A paged pool
keeps every slot on every rank, so a layout that would split its sequence
is refused. A Mamba2 block is tensor-parallel where its heads and conv
channels divide ``model``, and its state then holds a rank's channels and
heads, as the reference's rule splits them. A mesh may have a pod axis:
its data line is ``pod x data``.

PyTorch runs eagerly, so the reference's ``jax.jit`` wrappers (and their
per-width trace caches) have no counterpart; caches are written in place
instead of being donated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import RankMesh
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Sharder
from repro_torch.dist.tp import line_gather
from repro_torch.models.attention import (
    KVCache,
    SeqSplit,
    _stored_kv_heads,
    is_ring,
    kv_cache_shape,
    paged_splice,
)
from repro_torch.models.transformer import (
    DecodeCache,
    Model,
    init_cache,
    init_paged_cache,
)
from repro_torch.serve.comm import (
    TP_AXIS,
    ServeCommPlan,
    local_size,
    serve_cache_specs,
    serve_tp_validate,
)
from repro_torch.serve.paging import (
    alloc_slot_pages,
    alloc_step_pages,
    free_slot_pages,
    page_state_init,
    pages_for_span,
)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, 1, V) or (B, K, 1, V) -> next token ids (B, 1) or
    (B, K, 1) int32 (first max wins)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def select_tokens(logits, temps=None, gen: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Greedy/temperature sampling with PER-ROW temperatures.

    ``temps`` — (B,) float; rows with ``temp <= 0`` take the argmax, rows
    with ``temp > 0`` sample from the tempered categorical by Gumbel-max
    with noise drawn from ``gen`` (a ``torch.Generator`` on the logits'
    device). ``temps=None`` is pure greedy. logits: (B, 1, V) or
    (B, K, 1, V).
    """
    greedy = greedy_sample(logits)
    if temps is None:
        return greedy
    if gen is None:
        raise ValueError("select_tokens: temps given without a generator — "
                         "pass gen=... or temps=None for greedy")
    b = logits.shape[0]
    t = temps.float().clamp(min=1e-4).reshape(
        (b,) + (1,) * (logits.ndim - 1))
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(logits.float() / t + gumbel, dim=-1)
    use = (temps > 0).reshape((b,) + (1,) * (greedy.ndim - 1))
    return torch.where(use, sampled.to(torch.int32), greedy)


def gspmd_validate(cfg: ModelConfig, mesh) -> None:
    """The GSPMD route's scope. The rule table guards every split by
    divisibility (a dim that does not divide an axis stays whole over it,
    and the model computes that site replicated), so every family and
    degree serves; what is refused is a mesh that is not a
    :class:`RankMesh` (the route needs its ranks' places)."""
    if not isinstance(mesh, RankMesh):
        raise ValueError(f"the GSPMD route needs a RankMesh, got {mesh!r}")


class CacheLayout(NamedTuple):
    """A GSPMD rank's part of a decode cache: its ``rows`` and stored
    ``kv_heads``, the mesh axes its sequence is split over: ``None``
    (whole), ``"model"``, or ``"mesh"`` (the data line and ``model``
    together, slice ``rank``), and the slices its SSM state's conv
    channels and heads are split into over ``model`` (``ssm_parts``; 1:
    whole)."""

    rows: int
    kv_heads: int
    seq: Optional[str]
    ssm_parts: int = 1


def gspmd_cache_layout(cfg: ModelConfig, sharder: Sharder, batch: int,
                       max_len: int, paged: bool = False) -> CacheLayout:
    """This rank's part of a ``batch`` x ``max_len`` decode cache on the
    GSPMD route of ``sharder``'s mesh, by the reference's
    ``cache_shardings`` rule (``S`` is the window of a ring cache):

    * the rows over the data line where the batch divides it; then the KV
      heads over ``model`` where the attention is tensor-parallel
      (:attr:`Sharder.attn_tp`), else the sequence over ``model`` where
      ``S`` divides it, else whole;
    * a batch that does not divide the data line keeps its rows and splits
      the sequence over the data line and ``model`` together where ``S``
      divides their product, else over ``model``, else keeps it whole.

    Whole KV heads beside a tensor-parallel attention (a batch too small
    for the data line) are gathered over ``model`` where they are written
    (:mod:`repro_torch.models.transformer`). A paged pool (``paged``) is
    shared by every slot, so it keeps all rows and every position, and
    its KV heads over ``model`` where the attention is tensor-parallel: a
    layout that would split its sequence raises. An SSM state keeps its
    rows as the KV cache does, and splits its conv channels ``(L, B, W-1,
    CH)`` and its SSD heads ``(L, B, H, N, P)`` over ``model`` where the
    Mamba2 block is tensor-parallel (:attr:`Sharder.ssm_tp`: both divide
    the axis), else keeps them whole with the replicated block. (Under
    ``decode_kv_expand`` the reference may split stored heads whose
    attention is not tensor-parallel here; the port splits the sequence
    instead.)"""
    n, tp = sharder.n, sharder.tp_size
    kvh = _stored_kv_heads(cfg)
    s = kv_cache_shape(cfg, 1, max_len)[1]
    rows, seq = batch, None
    if batch % n == 0:
        rows = batch // n
        if sharder.attn_tp:
            kvh //= tp
        elif tp > 1 and s % tp == 0:
            seq = "model"
    elif s % (n * tp) == 0:
        seq = "mesh"
    elif tp > 1 and s % tp == 0:
        seq = "model"
    if paged:
        kvh = _stored_kv_heads(cfg) // (tp if sharder.attn_tp else 1)
        if seq is not None:
            raise ValueError(
                f"{cfg.name}: a paged pool keeps every slot on every rank, "
                f"but this mesh ({n} data x {tp} model ranks, batch {batch}, "
                f"{_stored_kv_heads(cfg)} KV heads) splits the cache's "
                f"sequence over {seq!r}: serve it on the contiguous route "
                f"(paged=False), whose cache splits its sequence")
        rows = batch
    return CacheLayout(rows, kvh, seq, tp if sharder.ssm_tp else 1)


def _seq_split(sharder: Sharder, seq: Optional[str]) -> Optional[SeqSplit]:
    """The :class:`SeqSplit` of a cache split over ``seq``'s axes on
    ``sharder``'s mesh (its model line, or every rank)."""
    if seq is None:
        return None
    if seq == "model":
        return SeqSplit(sharder.model_rank, sharder.tp_size, sharder.tp)
    return SeqSplit(sharder.rank, sharder.size, sharder.world)


def gspmd_cache(cfg: ModelConfig, sharder: Sharder, batch: int, max_len: int,
                *, dtype=torch.bfloat16, device=None) -> DecodeCache:
    """This rank's contiguous decode cache on the GSPMD route of
    ``sharder``'s mesh, laid out by :func:`gspmd_cache_layout` (a split
    sequence gathers its slices' partial attention on ``sharder``'s
    lines: build it with the step's Sharder)."""
    lay = gspmd_cache_layout(cfg, sharder, batch, max_len)
    return init_cache(cfg, lay.rows, max_len, dtype=dtype, device=device,
                      kv_heads=lay.kv_heads,
                      seq_split=_seq_split(sharder, lay.seq),
                      ssm_parts=lay.ssm_parts)


def make_serve_step(cfg: ModelConfig, mesh=None, comm_plan=None,
                    lane: int = 0, sharder: Optional[Sharder] = None
                    ) -> Callable[..., Tuple]:
    """Returns ``serve_step(params, tokens, cache, start=None, temps=None,
    gen=None) -> (next_tokens, cache)``; tokens: (B,1) int (audio:
    (B,K,1)). ``comm_plan`` selects the manual-TP VCI-stream path (see
    :mod:`repro_torch.serve.comm`); ``mesh`` without it the GSPMD route
    (see the module doc; collective: every rank builds it at the same
    point)."""
    if comm_plan is not None:
        return _make_comm_call(cfg, mesh, comm_plan, lane, prefill=False)
    if mesh is not None:
        return _make_gspmd_call(cfg, mesh, False, sharder)
    model = Model(cfg)

    def serve_step(params, tokens, cache: DecodeCache, start=None,
                   temps=None, gen=None):
        logits, new_cache = model.decode_step(params, tokens, cache,
                                              start=start)
        return select_tokens(logits, temps, gen), new_cache

    return serve_step


def make_prefill(cfg: ModelConfig, mesh=None, comm_plan=None,
                 lane: int = 0, sharder: Optional[Sharder] = None
                 ) -> Callable[..., Tuple]:
    """Returns ``prefill(params, batch, cache, start=None, temps=None,
    gen=None) -> (next_tokens, cache)`` sampling the first new token.
    ``batch`` holds ``tokens`` (audio: (B,K,S)), and ``image_embeds``
    (B,P,1024) for a VLM, whose cache then holds P + S_txt positions.
    ``comm_plan`` selects the manual-TP VCI-stream path, ``mesh`` without
    it the GSPMD route."""
    if comm_plan is not None:
        return _make_comm_call(cfg, mesh, comm_plan, lane, prefill=True)
    if mesh is not None:
        return _make_gspmd_call(cfg, mesh, True, sharder)
    model = Model(cfg)

    def prefill(params, batch, cache: DecodeCache, start=None, temps=None,
                gen=None):
        logits, _, new_cache = model.forward(params, batch, cache=cache,
                                             start=start)
        return select_tokens(logits[..., -1:, :], temps, gen), new_cache

    return prefill


# ---------------------------------------------------------------------------
# the manual-TP (VCI stream) step builders
# ---------------------------------------------------------------------------

def _mesh_tp(mesh) -> int:
    return mesh.shape.get(TP_AXIS, 1)


def _data_rows(cache: DecodeCache, batch: int, mesh: RankMesh
               ) -> Optional[slice]:
    """This rank's rows of a ``batch`` whose contiguous cache shards its
    rows over ``data`` (the cache holds fewer rows than the batch), else
    ``None`` (a paged pool, or a batch replicated over data)."""
    kv = cache.kv
    if isinstance(kv, KVCache):
        b = kv.k.shape[1]
    elif kv is None and cache.ssm is not None:   # SSM: (L, B, W-1, CH/n)
        b = cache.ssm.conv.shape[1]
    else:                                        # a paged pool
        return None
    if b == batch:
        return None
    d = mesh.coords(dist.get_rank())[0]
    return slice(d * b, (d + 1) * b)


def _make_comm_call(cfg: ModelConfig, mesh, plan: ServeCommPlan, lane: int,
                    prefill: bool):
    """The manual-TP prefill (``prefill``) or decode step: this rank's
    rows through ``Model(cfg, comm=...)``, the streams drained before
    sampling, and rows sharded over ``data`` gathered back."""
    if not isinstance(mesh, RankMesh):
        raise ValueError(f"comm_plan needs a RankMesh with a 'model' axis, "
                         f"got {mesh!r}")
    serve_tp_validate(cfg, _mesh_tp(mesh))

    def call(params, inp, cache: DecodeCache, start=None, temps=None,
             gen=None):
        tokens = inp["tokens"] if prefill else inp
        rows = _data_rows(cache, tokens.shape[0], mesh)
        if rows is not None:
            tokens = tokens[rows]
            start = None if start is None else start[rows]
            temps = None if temps is None else temps[rows]
        comm = plan.comm(lane, mesh=mesh)
        model = Model(cfg, comm=comm)
        if prefill:
            logits, _, new_cache = model.forward(
                params, {"tokens": tokens}, cache=cache, start=start)
            logits = logits[..., -1:, :]
        else:
            logits, new_cache = model.decode_step(params, tokens, cache,
                                                  start=start)
        nxt = select_tokens(comm.drain(logits), temps, gen)
        if rows is not None:
            nxt = plan.gather_tokens(nxt, mesh)
        return nxt, new_cache

    return call


def _make_gspmd_call(cfg: ModelConfig, mesh, prefill: bool,
                     shard: Optional[Sharder] = None):
    """The GSPMD route's prefill (``prefill``) or decode step: this rank's
    rows through ``Model(cfg, Sharder(mesh, cfg))``, rows split over data
    gathered back over the data line. ``shard`` (default a new one) is
    the Sharder, also ``call.sharder``; its ``tally`` counts the
    collectives (the token gathers under ``"tokens"``)."""
    gspmd_validate(cfg, mesh)
    if shard is None:
        shard = Sharder(mesh, cfg)
    model = Model(cfg, shard)

    def call(params, inp, cache: DecodeCache, start=None, temps=None,
             gen=None):
        batch = inp if prefill else {"tokens": inp}
        rows = _data_rows(cache, batch["tokens"].shape[0], mesh)
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
            start = None if start is None else start[rows]
            temps = None if temps is None else temps[rows]
        if prefill:
            logits, _, new_cache = model.forward(params, batch, cache=cache,
                                                 start=start)
            logits = logits[..., -1:, :]
        else:
            logits, new_cache = model.decode_step(params, batch["tokens"],
                                                  cache, start=start)
        nxt = select_tokens(logits, temps, gen)
        if rows is not None:
            nxt = line_gather(nxt, 0, mesh.data_size, shard._data_group)
            shard.tally["tokens"] = shard.tally.get("tokens", 0) + 1
        return nxt, new_cache

    call.sharder = shard
    return call


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt: np.ndarray                    # (S,) or (K,S) token ids
    max_new_tokens: int = 32
    temperature: Optional[float] = None   # None -> engine default; 0 = greedy
    stop_token: Optional[int] = None      # finish early when sampled
    generated: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = True

    def activate(self, req: Request):
        self.req, self.tokens, self.done = req, [], False

    def finish(self):
        self.done = True
        if self.req is not None:
            self.req.generated = np.asarray(self.tokens, np.int32)


def check_servable(cfg: ModelConfig) -> None:
    """Raise for the VLM family, which :class:`ServeEngine` does not
    serve."""
    if cfg.modality == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: ServeEngine does not serve a VLM, as the "
            f"reference's does not: its Request carries no image. Serve it "
            f"with make_prefill(cfg) on a batch holding 'image_embeds' "
            f"(B, P, 1024), then make_serve_step(cfg)")


# admission prompts pad to multiples of this — kept from the reference so
# an admitted request is prefilled at the same padded width as there
_ADMIT_ALIGN = 8


class ServeEngine:
    """Continuous-batching serving loop (see module doc).

    ``device`` — ``None`` means CUDA (raises when it is absent); the CPU
    runs only when asked for with ``device="cpu"``. ``params`` must already
    live on that device (under a mesh: this rank's shard).
    ``cache_bytes_resident`` is the largest resident decode-cache footprint
    of the last ``generate()`` (this rank's); ``decode_steps`` the number
    of batched decode steps it ran.

    ``mesh`` + ``comm_plan`` (or ``num_vcis``) select the manual-TP decode
    whose collectives ride per-purpose VCI streams; ``mesh`` alone the
    GSPMD route (``params``: this rank's slice by the rule table,
    ``Sharder(mesh, cfg, rank=r).shard_params(full)``). Every rank of the
    mesh must build its engine at the same point of its program (the
    process groups are created here) and run the same requests.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch_size: int,
                 max_len: int, device=None, mesh=None,
                 cache_dtype=torch.float32,
                 comm_plan: Optional[ServeCommPlan] = None,
                 num_vcis: Optional[int] = None, vci_policy: str = "fcfs",
                 progress: str = "hybrid", token_impl: str = "barrier",
                 temperature: float = 0.0, seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None):
        if comm_plan is None and num_vcis is not None:
            if mesh is None or _mesh_tp(mesh) <= 1:
                raise ValueError("num_vcis needs a mesh with a 'model' axis "
                                 ">1 (the TP streams live there)")
            comm_plan = ServeCommPlan(num_vcis=num_vcis,
                                      vci_policy=vci_policy,
                                      progress=progress,
                                      token_impl=token_impl)
        if comm_plan is not None and not isinstance(mesh, RankMesh):
            raise ValueError(f"comm_plan needs a RankMesh with a 'model' "
                             f"axis, got {mesh!r}")
        check_servable(cfg)
        self.device = resolve_device(device)
        emb = params["embed"]["tok"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.mesh = mesh
        self.comm_plan = comm_plan
        self.temperature = temperature
        # the GSPMD route's rule table, shared by its prefill and decode
        # step and laying out its caches (None on one rank or under a plan)
        self._sharder = None
        if mesh is not None and comm_plan is None:
            gspmd_validate(cfg, mesh)
            self._sharder = Sharder(mesh, cfg)
        self._prefill = make_prefill(cfg, mesh, comm_plan,
                                     sharder=self._sharder)
        self._step = make_serve_step(cfg, mesh, comm_plan,
                                     sharder=self._sharder)
        if comm_plan is not None:
            comm_plan.create_groups(mesh)
        self._cache_dtype = cache_dtype
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._ring = is_ring(cfg, max_len)
        # left-padded mixed-length batching needs per-row attention masks;
        # SSM/hybrid state, ring caches and non-text frontends can't
        # provide them -> equal-length grouped batches for those
        self._padded_ok = (cfg.family in ("dense", "moe")
                           and cfg.modality == "text" and not self._ring)
        # paged cache: attention archs on the continuous path only
        self._paged = bool(paged) and self._padded_ok
        self._page_size = int(page_size)
        self._max_pages = -(-max_len // self._page_size)
        self._num_pages = (1 + batch_size * self._max_pages
                           if num_pages is None else int(num_pages))
        if self._paged and self._num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the trash "
                             f"page), got {self._num_pages}")
        if self._paged and self._sharder is not None:
            # a pool whose sequence this mesh would split is refused here
            gspmd_cache_layout(cfg, self._sharder, batch_size, max_len,
                               paged=True)
        self._pages = None        # PageState (host), paged mode
        # mid-stream admission re-prefills single requests. The contiguous
        # splice is single-rank only (B=1 doesn't shard over data); the
        # PAGED admission prefill runs replicated over data under the
        # running batch's TP shards, so it works on any mesh.
        self._can_admit = mesh is None or self._paged
        self.cache_bytes_resident = 0
        self.decode_steps = 0

    # -- small helpers ---------------------------------------------------
    def _temp_of(self, r: Request) -> float:
        return self.temperature if r.temperature is None else r.temperature

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _validate(self, requests: List[Request]) -> None:
        for i, r in enumerate(requests):
            plen = int(r.prompt.shape[-1])
            if self.cfg.modality == "audio":
                k = self.cfg.num_codebooks
                if r.prompt.ndim != 2 or r.prompt.shape[0] != k:
                    raise ValueError(f"request {i}: an audio prompt is "
                                     f"({k}, S) codebook tokens, got "
                                     f"{r.prompt.shape}")
            elif r.prompt.ndim != 1:
                raise ValueError(f"request {i}: prompt must be 1-D token ids")
            if plen < 1:
                raise ValueError(f"request {i}: empty prompt")
            if r.max_new_tokens < 1:
                raise ValueError(f"request {i}: max_new_tokens < 1")
            if plen + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {i}: prompt_len {plen} + max_new_tokens "
                    f"{r.max_new_tokens} exceeds the cache depth "
                    f"(max_len={self.max_len}); decode would write past the "
                    f"cache — shorten the request or raise max_len")
            if self._paged:
                need = pages_for_span(0, plen + r.max_new_tokens,
                                      self._page_size)
                if need > self._num_pages - 1:
                    raise ValueError(
                        f"request {i}: needs {need} pages alone but the "
                        f"pool holds {self._num_pages - 1} allocatable "
                        f"pages (num_pages={self._num_pages}, page_size="
                        f"{self._page_size}) — grow the pool")

    def _note_cache(self, cache: DecodeCache) -> None:
        self.cache_bytes_resident = max(self.cache_bytes_resident,
                                        cache.nbytes())

    def _local_cache(self, paged: bool, batch: int) -> Tuple[int, int]:
        """(rows, KV heads) of this rank's cache for a ``batch``: all of
        both on one rank; on the GSPMD route, :func:`gspmd_cache_layout`'s;
        under a comm plan, as :func:`serve_cache_specs` shards them."""
        kvh = _stored_kv_heads(self.cfg)
        if self.mesh is None:
            return batch, kvh
        if self._sharder is not None:
            lay = gspmd_cache_layout(self.cfg, self._sharder, batch,
                                     self.max_len, paged)
            return lay.rows, lay.kv_heads
        spec = serve_cache_specs(paged, batch, kvh, _mesh_tp(self.mesh),
                                 self.mesh.data_size)["kv"]
        rows = batch if paged else local_size(batch, spec[1], self.mesh)
        return rows, local_size(kvh, spec[3], self.mesh)

    def _new_cache(self, batch: int, max_len: int) -> DecodeCache:
        """A contiguous cache for ``batch`` rows (this rank's part; on the
        GSPMD route laid out by :func:`gspmd_cache`)."""
        if self._sharder is not None:
            return gspmd_cache(self.cfg, self._sharder, batch, max_len,
                               dtype=self._cache_dtype, device=self.device)
        rows, kvh = self._local_cache(False, batch)
        return init_cache(self.cfg, rows, max_len, dtype=self._cache_dtype,
                          device=self.device, kv_heads=kvh)

    # -- public API ------------------------------------------------------
    def generate(self, requests: List[Request]) -> List[Request]:
        self._validate(requests)
        self.cache_bytes_resident = 0
        self.decode_steps = 0
        with torch.inference_mode():
            if self._padded_ok:
                pending = list(requests)
                while pending:
                    batch = self._take_batch(pending)
                    self._run_continuous(batch, pending)
            else:
                # grouped fallback: equal prompt lengths per batch
                groups: Dict[int, List[Request]] = {}
                for r in requests:
                    groups.setdefault(int(r.prompt.shape[-1]), []).append(r)
                for _, rs in sorted(groups.items()):
                    for i in range(0, len(rs), self.batch_size):
                        self._run_grouped(rs[i: i + self.batch_size])
        return requests

    # -- batch formation -------------------------------------------------
    def _take_batch(self, pending: List[Request]) -> List[Request]:
        """Pop up to ``batch_size`` requests whose LEFT-PADDED runway fits:
        with pad width P = max(prompt lens), every member still needs
        ``P + max_new <= max_len``. Paged: additionally, the members'
        worst-case page spans must fit the pool together."""
        batch: List[Request] = []
        pad = 0
        i = 0
        while i < len(pending) and len(batch) < self.batch_size:
            r = pending[i]
            p_new = max(pad, int(r.prompt.shape[-1]))
            members = batch + [r]
            fits = all(p_new + q.max_new_tokens <= self.max_len
                       for q in members)
            if fits and self._paged:
                fits = sum(
                    pages_for_span(p_new - int(q.prompt.shape[-1]),
                                   p_new + q.max_new_tokens,
                                   self._page_size)
                    for q in members) <= self._num_pages - 1
            if fits:
                batch.append(pending.pop(i))
                pad = p_new
            else:
                i += 1
        assert batch, "a validated request always fits alone"
        return batch

    # -- continuous (left-padded) path ------------------------------------
    def _run_continuous(self, batch: List[Request],
                        pending: List[Request]) -> None:
        cfg = self.cfg
        B = self.batch_size
        PS = self._page_size
        slots = [_Slot() for _ in range(B)]
        for s, r in zip(slots, batch):
            s.activate(r)
        # empty slots replay batch[0]'s prompt, as the reference does
        plens = [int(s.req.prompt.shape[-1]) if s.req is not None
                 else int(batch[0].prompt.shape[-1]) for s in slots]
        pad = max(plens)
        tokens = np.zeros((B, pad), np.int32)
        for i, s in enumerate(slots):
            tokens[i, pad - plens[i]:] = (s.req or batch[0]).prompt
        start = np.asarray([pad - p for p in plens], np.int32)
        temps = np.asarray([self._temp_of(s.req) if s.req else 0.0
                            for s in slots], np.float32)
        reserved: Dict[int, int] = {}  # slot -> worst-case page span
        if self._paged:
            cache = init_paged_cache(cfg, B, self.max_len, page_size=PS,
                                     num_pages=self._num_pages,
                                     dtype=self._cache_dtype,
                                     device=self.device,
                                     kv_heads=self._local_cache(True, B)[1])
            self._pages = page_state_init(self._num_pages, B,
                                          self._max_pages)
            for i, s in enumerate(slots):
                if s.req is None:
                    continue  # empty slot: writes land in the trash page
                self._palloc(cache, i, int(start[i]) // PS, (pad - 1) // PS)
                reserved[i] = pages_for_span(
                    int(start[i]), pad + s.req.max_new_tokens, PS)
        else:
            cache = self._new_cache(B, self.max_len)
        self._note_cache(cache)
        nxt, cache = self._prefill(self.params, {"tokens": self._dev(tokens)},
                                   cache, self._dev(start), self._dev(temps),
                                   self._gen)
        cur = pad

        def record(s: _Slot, t: int) -> None:
            if s.req.stop_token is not None and t == s.req.stop_token:
                s.finish()
                return
            s.tokens.append(t)
            if len(s.tokens) >= s.req.max_new_tokens:
                s.finish()

        def reclaim(i: int, s: _Slot) -> None:
            """The instant a slot finishes its pages go back to the pool
            (its decode writes re-route to the trash page through the
            cleared table row)."""
            if not (self._paged and s.done and i in reserved):
                return
            free_slot_pages(self._pages, i)
            reserved.pop(i, None)
            self._sync_table(cache)

        while True:
            toks = nxt.cpu().numpy().copy()  # admission may overwrite a row
            admitted = False
            for i, s in enumerate(slots):
                if not s.done and s.req is not None:
                    record(s, int(toks[i, 0]))
                    reclaim(i, s)
            # early slot recycling: prefill the next request into a finished
            # slot just below the shared cursor (start masks older rows)
            if self._can_admit and pending:
                for i, s in enumerate(slots):
                    if not s.done or not pending:
                        continue
                    j = self._admittable(pending, cur, reserved)
                    if j is None:
                        continue
                    r = pending.pop(j)
                    plen = int(r.prompt.shape[-1])
                    if self._paged:
                        self._palloc(cache, i, (cur - plen) // PS,
                                     (cur - 1) // PS)
                        reserved[i] = pages_for_span(
                            cur - plen, cur + r.max_new_tokens, PS)
                    tok0 = self._admit(r, cache, i, cur)
                    s.activate(r)
                    start[i] = cur - plen
                    temps[i] = self._temp_of(r)
                    toks[i, 0] = tok0
                    record(s, tok0)  # the admission prefill's first token
                    reclaim(i, s)
                    admitted = True
            if all(s.done or s.req is None for s in slots):
                break
            if admitted:
                nxt = self._dev(toks)
            if cur >= self.max_len:  # defensive: budgets guarantee this
                for s in slots:      # never trips (validated runways)
                    if not s.done:
                        s.finish()
                break
            if self._paged and cur % PS == 0:
                # the shared cursor crosses into a fresh logical page: every
                # live slot gets one (reservation makes this infallible)
                act = [i for i, s in enumerate(slots) if not s.done]
                if act:
                    _, ok = alloc_step_pages(self._pages, act, cur // PS)
                    if not ok:  # reservations make this unreachable
                        raise RuntimeError(
                            "page pool exhausted at the decode boundary — "
                            "reservation accounting broken")
                    self._sync_table(cache)
            nxt, cache = self._step(self.params, nxt, cache, self._dev(start),
                                    self._dev(temps), self._gen)
            self.decode_steps += 1
            cur += 1

    # -- grouped (equal prompt length) fallback ---------------------------
    def _run_grouped(self, reqs: List[Request]) -> None:
        """Prefill ``reqs`` (one prompt length) together, then decode until
        every row has stopped or made its ``max_new_tokens``; each row's
        tokens are cut at its first stop token. Audio rows make ``(K,
        steps)`` tokens and have no stop token, as in the reference."""
        cfg = self.cfg
        b = len(reqs)
        prompts = np.stack([r.prompt for r in reqs])
        cache = self._new_cache(b, self.max_len)
        self._note_cache(cache)
        temps = self._dev(np.asarray([self._temp_of(r) for r in reqs],
                                     np.float32))
        nxt, cache = self._prefill(self.params,
                                   {"tokens": self._dev(prompts)}, cache,
                                   None, temps, self._gen)
        text = cfg.modality == "text"
        gen = [nxt.cpu().numpy()]
        stopped = [False] * b

        def update_stops():
            if not text:
                return
            for i, r in enumerate(reqs):
                if r.stop_token is not None and \
                        int(gen[-1][i, 0]) == r.stop_token:
                    stopped[i] = True

        update_stops()
        while any(not stopped[i] and len(gen) < r.max_new_tokens
                  for i, r in enumerate(reqs)):
            nxt, cache = self._step(self.params, nxt, cache, None, temps,
                                    self._gen)
            self.decode_steps += 1
            gen.append(nxt.cpu().numpy())
            update_stops()
        toks = np.concatenate(gen, axis=-1)  # (B,steps) or (B,K,steps)
        for i, r in enumerate(reqs):
            seq = toks[i][..., : r.max_new_tokens]
            if text and r.stop_token is not None:
                hits = np.nonzero(seq == r.stop_token)[0]
                if hits.size:
                    seq = seq[: int(hits[0])]
            r.generated = seq

    def _admittable(self, pending: List[Request], cur: int,
                    reserved: Dict[int, int]) -> Optional[int]:
        """Index of the first pending request that fits at cursor ``cur``:
        its prompt must fit below the cursor and its token budget inside the
        remaining cache depth — and, paged, its worst-case page span must
        fit next to the live slots' reservations."""
        for j, r in enumerate(pending):
            plen = int(r.prompt.shape[-1])
            if plen > cur or cur + r.max_new_tokens > self.max_len:
                continue
            if self._paged:
                need = pages_for_span(cur - plen, cur + r.max_new_tokens,
                                      self._page_size)
                if sum(reserved.values()) + need > self._num_pages - 1:
                    continue
            return j
        return None

    # -- page-pool bookkeeping (paged mode) --------------------------------
    def _sync_table(self, cache: DecodeCache) -> None:
        """Copy the host allocator's table into the device cache."""
        cache.kv.table.copy_(self._pages.table)

    def _palloc(self, cache: DecodeCache, slot: int, lo_page: int,
                hi_page: int) -> None:
        """Map fresh pool pages at ``slot``'s logical pages [lo, hi]."""
        _, ok = alloc_slot_pages(self._pages, slot,
                                 range(lo_page, hi_page + 1))
        if not ok:  # reservations make this unreachable
            raise RuntimeError("page pool exhausted at prefill/admission — "
                               "reservation accounting broken")
        self._sync_table(cache)

    def _admit(self, r: Request, cache: DecodeCache, slot: int,
               cur: int) -> int:
        """Prefill ``r`` alone and splice its K/V into ``slot``'s cache at
        virtual positions ``[cur - p_adm, cur)``, in place; returns the
        first token. Contiguous: a slice assignment into the slot's row.
        Paged: a page-table splice into the slot's freshly allocated
        pages; under a mesh the prefill runs replicated over data on the
        running batch's TP shards (the rank's KV heads), the admission the
        contiguous splice cannot do there."""
        plen = int(r.prompt.shape[-1])
        p_adm = min(-(-plen // _ADMIT_ALIGN) * _ADMIT_ALIGN, cur)
        tokens = np.zeros((1, p_adm), np.int32)
        tokens[0, p_adm - plen:] = r.prompt
        dest = cur - p_adm
        if self._paged:   # one row of the pool's layout, every position
            tmp = init_cache(self.cfg, 1, p_adm, dtype=self._cache_dtype,
                             device=self.device,
                             kv_heads=cache.kv.k.shape[-2])
        else:
            tmp = self._new_cache(1, p_adm)
        nxt, tmp = self._prefill(
            self.params, {"tokens": self._dev(tokens)}, tmp,
            self._dev(np.asarray([p_adm - plen], np.int32)),
            self._dev(np.asarray([self._temp_of(r)], np.float32)), self._gen)
        if self._paged:
            paged_splice(cache.kv, slot, dest, tmp.kv.k[:, 0], tmp.kv.v[:, 0])
        else:
            cache.kv.k[:, slot, dest:cur] = tmp.kv.k[:, 0]
            cache.kv.v[:, slot, dest:cur] = tmp.kv.v[:, 0]
        return int(nxt[0, 0])
