"""PipelinedSearch: the overlapped crude/refine executor (twin of
``repro.index.pipelined``).

The engines are split at the crude/refine boundary into phase pairs
over ``(qs | carry, env)``: ``flat.two_step_phase_fns``,
``flat.adc_phase_fns`` and ``ivf.ivf_phase_fns``, over the borrowed
index state of ``flat.two_step_phase_env`` / ``ivf.ivf_phase_env``.
This module runs a pair over query tiles so that the crude phase of
tile t+1 overlaps the threshold bootstrap and refine of tile t:

    crude(0) | refine(0)   refine(1)   refine(2) ...
             | crude(1)    crude(2)    crude(3)

On the card the overlap is CUDA concurrency: the crude phases run on
one ``torch.cuda.Stream`` and the refine phases on a second, one pair
per device shared by every plan (the kernel wrappers launch on the
current stream).  One pair, not one per plan: PyTorch keeps a cuBLAS
workspace (32 MiB on an H100) for every stream a matrix product has run
on, for the life of the process, so a pair per plan left 64 MiB behind
every plan made (F6).  The order is held by events:
  - the crude stream waits on the caller's stream at entry, where the
    tiles are padded and the crude carry allocated;
  - refine(t) waits on crude(t)'s event;
  - the crude carry is two preallocated slots of the dense (tile, n)
    crude matrix (the slab's (tile, nc) for IVF), written through the
    crude kernels' ``out=``; the crude kernel of tile t+2 waits on
    refine(t)'s event before it writes slot t % 2 again.  The slots
    take the place of the reference's ``donate_argnums``;
  - the refine kernel of tile t waits for the crude phase of tile t+1:
    each scan kernel is sized to one full wave of the SMs, and run side
    by side each would need a second wave (with the two free to overlap,
    a two-step batch of 512 queries took 23.7 ms against 15.9 ms
    sequential on an H100).  So the two scan kernels alternate, and
    what overlaps them is the other stream's small ops: the bootstrap of
    tile t beside the crude kernel of tile t+1, the LUT build of tile
    t+2 beside the refine kernel of tile t (``before_launch`` hooks, run
    between a stage's operands and its kernel);
  - every other tensor one stream allocates and the other reads is
    marked with ``Tensor.record_stream``, so the caching allocator
    cannot hand its memory out again while the reader still runs;
  - the caller's stream waits on both streams before the tiles'
    results are concatenated (and on the way out of a failed tile), so
    the engine's ``synchronize`` covers everything.
The host enqueues crude(t+1) before refine(t), so the crude kernel of
the next tile can run while the host still launches the bootstrap's
small ops.  A failed launch inside a tile raises out of the executor;
nothing falls back.  Single-phase plans (one-step ADC, the crude rung)
have nothing to overlap and run their tiles in order on the caller's
stream; on the CPU every plan runs its tiles in order on the plain
versions.

Results equal the sequential search over the same tiles bit for bit:
every row of every phase output depends only on that query's row (the
eq. 2 threshold bootstraps from the query's own crude top-k), the tiles
are the sequential path's ``query_chunk`` blocks (zero-padded the same
way), and the accounting folds the same per-query vectors.  Across tile
shapes the LUT build's matrix product may round differently (BLAS on
the CPU, cuBLAS on the card pick their algorithm by shape), so a
sequential call at another block size agrees on rankings, not on every
last bit.

``maybe_pipelined`` is the routing entry the indexes call: "tiles"
always engages (even for a single tile), "auto" declines batches of one
tile or less (returning None: the sequential path serves).  An
``AnnEngine`` with ``query_tile`` cuts a batch before the index sees it,
so a pipelined index behind a tiled engine gets one tile per call and
has nothing to overlap, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.index.base import (SearchResult, resolve_backend,
                                    resolve_lut_dtype)
from repro_torch.kernels.stages import pad_to

PIPELINE_MODES = ("off", "tiles", "auto")
# a tile is one kernel query block on the card (the reference's
# block_q), a small cache-friendly block for the plain versions
_DEFAULT_TILE_CUDA = 64
_DEFAULT_TILE_PLAIN = 16


def resolve_pipeline(value: str) -> str:
    if value not in PIPELINE_MODES:
        raise ValueError(f"unknown pipeline mode {value!r}; expected one "
                         f"of {PIPELINE_MODES}")
    return value


def resolve_tile(pipeline_tile: Optional[int], backend: str) -> int:
    """The query-tile size: an explicit ``pipeline_tile`` wins; otherwise
    64 on the kernels (a resolved backend of the card) and 16 on the
    plain versions ("torch")."""
    if pipeline_tile is not None:
        tile = int(pipeline_tile)
        if tile < 1:
            raise ValueError(f"pipeline_tile must be a positive int, "
                             f"got {pipeline_tile!r}")
        return tile
    return _DEFAULT_TILE_PLAIN if backend == "torch" else _DEFAULT_TILE_CUDA


def compose(crude_fn, refine_fn, env):
    """One query block through a phase pair: ``refine(crude(qs))``, or
    the crude phase alone for a single-phase engine."""
    if refine_fn is None:
        return functools.partial(crude_fn, env=env)
    return lambda qs: refine_fn(crude_fn(qs, env), env)


def _read_by(tensors, stream) -> None:
    """Mark the tensors of a phase's output as used on ``stream``."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            t.record_stream(stream)


@dataclasses.dataclass
class PipelinedSearch:
    """A bound pipelined-search plan: the phase pair, the borrowed index
    state it reads, the tile size, the finalizer that folds the
    concatenated per-query outputs into a ``SearchResult``, and the
    columns of the dense crude carry (n, or the slab's nc).  ``pred``
    (the optional filter predicate, a jnp-engine option) is the one
    per-call operand besides the queries."""
    crude_fn: Callable
    refine_fn: Optional[Callable]
    env: dict
    tile: int
    finalize: Callable
    carry_cols: int = 0

    def __call__(self, queries, pred=None) -> SearchResult:
        env = self.env if pred is None else dict(self.env, pred=pred)
        nq = queries.shape[0]
        n_tiles = max(-(-nq // self.tile), 1)
        tiles = torch.split(pad_to(queries, n_tiles * self.tile), self.tile)
        if self.refine_fn is not None and queries.is_cuda:
            outs = self._overlapped(tiles, env)
        else:
            block = compose(self.crude_fn, self.refine_fn, env)
            outs = [block(tq) for tq in tiles]
        return self.finalize(*(torch.cat(parts)[:nq]
                               for parts in zip(*outs)))

    def streams(self, device) -> tuple:
        """The (crude, refine) stream pair of ``device``, made at first
        use and shared by every plan (module docstring)."""
        device = torch.device(device)
        idx = (device.index if device.index is not None
               else torch.cuda.current_device())
        pair = _STREAMS.get(idx)
        if pair is None:
            pair = _STREAMS[idx] = (torch.cuda.Stream(idx),
                                    torch.cuda.Stream(idx))
        return pair

    def _overlapped(self, tiles, env) -> list:
        """The two-stream schedule (module docstring)."""
        dev = tiles[0].device
        caller = torch.cuda.current_stream(dev)
        crude_s, refine_s = self.streams(dev)
        slots = torch.empty((2, self.tile, self.carry_cols),
                            dtype=torch.float32, device=dev)
        refined = []                    # refine(t)'s event, by t

        def crude(t):
            # slot t % 2 is free once refine(t-2) has run; waiting just
            # before the kernel lets the LUT build run beside it
            wait = (functools.partial(crude_s.wait_event, refined[t - 2])
                    if t >= 2 else None)
            with torch.cuda.stream(crude_s):
                carry = self.crude_fn(tiles[t], env, out=slots[t % 2],
                                      before_launch=wait)
                _read_by(carry, refine_s)
                return carry, crude_s.record_event()

        def refine(carry, crude_done, next_done):
            # the bootstrap runs beside the next tile's crude kernel; the
            # refine kernel waits for that kernel to finish
            wait = (None if next_done is None
                    else functools.partial(refine_s.wait_event, next_done))
            with torch.cuda.stream(refine_s):
                refine_s.wait_event(crude_done)
                res = self.refine_fn(carry, env, before_launch=wait)
                _read_by(res, caller)
                refined.append(refine_s.record_event())
                return res

        outs = []
        crude_s.wait_stream(caller)
        try:
            nxt = crude(0)
            for t in range(len(tiles)):
                cur = nxt
                # enqueue crude(t+1) before refine(t): its crude kernel
                # runs while the host launches the bootstrap's small ops
                nxt = crude(t + 1) if t + 1 < len(tiles) else None
                outs.append(refine(*cur, None if nxt is None else nxt[1]))
        finally:
            caller.wait_stream(crude_s)
            caller.wait_stream(refine_s)
        return outs


# device index -> the (crude, refine) stream pair every plan shares
_STREAMS: dict = {}


def _plan(index, topk: int, *, crude_only: bool, has_filter: bool,
          n_probe: Optional[int]) -> PipelinedSearch:
    """Bind an index's configuration to a PipelinedSearch plan."""
    from repro_torch.index import flat, ivf

    be = resolve_backend(index.backend, index.device)
    opts = dict(topk=topk,
                quantized=resolve_lut_dtype(index.lut_dtype) == "int8",
                code_bits=flat._check_fastscan_geometry(index.code_bits,
                                                        index.C.shape[1]))
    K = index.C.shape[0]
    tile = resolve_tile(index.pipeline_tile, be)
    refine_cap = None if crude_only else getattr(index, "refine_cap", None)
    flat._check_refine_cap(refine_cap, be)

    if isinstance(index, ivf.IVFTwoStep):
        np_ = n_probe if n_probe is not None else index.n_probe
        n_lists = ivf.check_n_probe(index.ivf, np_)
        fns = ivf.ivf_phase_fns(n_probe=np_, refine_cap=refine_cap,
                                crude_only=crude_only,
                                has_filter=has_filter, **opts)
        env = ivf.ivf_phase_env(index.codes, index.C, index.structure,
                                index.ivf, list_codes=index.list_codes)
        finalize = functools.partial(
            ivf.ivf_ops_result, n=index.codes.shape[0], n_lists=n_lists,
            K=K, kf=flat._fast_count(index.structure))
        # the slab's width: the probed lists, padded up to topk columns
        nc = max(np_ * index.ivf.lists.shape[1], topk)
        return PipelinedSearch(*fns, env, tile, finalize, nc)

    if isinstance(index, flat.FlatADC):
        fns = flat.adc_phase_fns(has_filter=has_filter, **opts)
        env = {"codes": index.codes, "C": index.C, "pred": None}
        return PipelinedSearch(*fns, env, tile,
                               functools.partial(flat.adc_result, K=K))

    kf = flat._fast_count(index.structure)
    if refine_cap is not None:
        refine_cap = min(max(refine_cap, topk), index.codes.shape[0])
    fns = flat.two_step_phase_fns(refine_cap=refine_cap,
                                  crude_only=crude_only,
                                  has_filter=has_filter, **opts)
    env = flat.two_step_phase_env(index.codes, index.C, index.structure)
    finalize = (functools.partial(flat.crude_result, kf=kf) if crude_only
                else functools.partial(flat.two_step_result, K=K, kf=kf))
    return PipelinedSearch(*fns, env, tile, finalize, index.codes.shape[0])


def plan_for(index, topk: int, *, crude_only: bool = False,
             has_filter: bool = False,
             n_probe: Optional[int] = None) -> PipelinedSearch:
    """The per-index plan cache, keyed by (topk, crude_only, has_filter,
    n_probe).  Plans hold the index's tensors and their stream pair, so
    they are cached on the instance: ``dataclasses.replace`` and
    ``Index.add`` return new objects and therefore new plans, and a
    cached plan never serves stale state."""
    key = (topk, crude_only, has_filter, n_probe)
    cache = index.__dict__.get("_pipeline_plans")
    if cache is None:
        cache = {}
        object.__setattr__(index, "_pipeline_plans", cache)
    plan = cache.get(key)
    if plan is None:
        plan = _plan(index, topk, crude_only=crude_only,
                     has_filter=has_filter, n_probe=n_probe)
        cache[key] = plan
    return plan


def maybe_pipelined(index, queries, topk: int, *, filter=None,
                    crude_only: bool = False,
                    n_probe: Optional[int] = None
                    ) -> Optional[SearchResult]:
    """Route a search through the pipelined executor if the index's
    ``pipeline`` mode engages; returns None to fall back to the
    sequential path ("off", or "auto" with a batch of one tile or
    less)."""
    from repro_torch.index.flat import _check_filter

    mode = resolve_pipeline(index.pipeline)
    if mode == "off":
        return None
    be = resolve_backend(index.backend, index.device)
    if mode == "auto" and \
            queries.shape[0] <= resolve_tile(index.pipeline_tile, be):
        return None
    pred = _check_filter(filter, index.codes.shape[0], be, index.device)
    plan = plan_for(index, topk, crude_only=crude_only,
                    has_filter=pred is not None, n_probe=n_probe)
    return plan(queries, pred)
