"""Flat (exhaustive) indexes (twin of ``repro.index.flat``): one-step
ADC and the ICQ two-step engine, both scanning every database point.

Each search is a composition of the stages in ``kernels/stages.py``:
``FlatADC`` is one crude stage over the full tables (no fast mask, no
dense output); ``TwoStep`` runs crude -> threshold bootstrap -> refine,
the reference's fused-kernel composition.  On a CUDA device the crude
and refine stages launch the hand-written kernels; on the CPU they run
the kernels' plain PyTorch versions.

"Average Ops", the paper's speed metric, counts LUT adds per point:
|K_fast| + pass_rate * (K - |K_fast|), against K for one-step ADC.

The degradation ladder's crude floor (``search_crude``) ranks by the
crude pass alone: the crude kernel's candidate list with no dense
matrix (``want_crude=False``), the exact crude top-k the full path
bootstraps its threshold from; ``pass_rate`` 0, ``avg_ops`` |K_fast|.

``filter`` (a per-row predicate) and ``refine_cap`` (the static
survivor compaction) are the reference's jnp-engine options, served in
the reference's jnp composition through the kernels: the crude kernel
with the predicate (filtered rows +inf before any top-k, its candidate
list the two-key top-k of the masked crude matrix), the jnp bootstrap
rule over that list (``ThresholdStage.from_dense_candidates``), then the
refine kernel or, with ``refine_cap``, the survivor selection and its
re-rank (``CappedStage``).  They are served under ``backend="jnp"`` on
the card (resolved "cuda-jnp") and under every backend on the CPU
(where the same composition runs on the plain versions); the fused
engine (auto | pallas on the card, resolved "cuda") raises the
reference's ``ValueError`` for them, as its Pallas engine does.

Each engine is a phase pair (``two_step_phase_fns``, ``adc_phase_fns``
over ``two_step_phase_env``): the sequential searches compose it block
by block, and ``pipeline="tiles" | "auto"`` runs the same pair through
the pipelined executor (``index/pipelined.py``; queue 1 item 7, done):
on the card the crude phase of tile t+1 on one CUDA stream beside the
refine of tile t on another.

``add`` grows an index without retraining: the new rows are encoded by
the ICM engine (``core.encode.icm_encode``, the ICM kernel on the card)
and appended, so a grown index equals one built over all rows at once.
``shard(mesh)`` returns the sharded serving clone (``index/sharded.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.encode import icm_encode, pack_nibbles
from repro_torch.index.base import (SearchResult, as_filter, as_torch,
                                    build_lut, chunked_over_queries,
                                    mask_filtered_ids, resolve_backend,
                                    resolve_code_bits, resolve_lut_dtype)
from repro_torch.index.pipelined import (compose, maybe_pipelined,
                                         resolve_pipeline)
from repro_torch.kernels.stages import (CappedStage, CrudeStage,
                                        RefineStage, ThresholdStage)


def _check_fastscan_geometry(code_bits: int, m: int) -> int:
    """``code_bits=4`` stores two codes per byte: m <= 16 codewords."""
    code_bits = resolve_code_bits(code_bits)
    if code_bits == 4 and m > 16:
        raise ValueError(f"code_bits=4 requires codebook_size <= 16 "
                         f"codewords (4-bit codes), got m={m}")
    return code_bits


def _check_filter(filter, n: int, backend: str, device):
    """The row predicate of a filtered search, or None.  A jnp-engine
    option, as in the reference: the fused engine (resolved backend
    "cuda") raises the reference's words."""
    if filter is None:
        return None
    if backend == "cuda":
        raise ValueError("filtered search requires backend='jnp' (the "
                         "fused kernels cannot mask rows by predicate; "
                         "like refine_cap, filter is a jnp-engine "
                         "option)")
    return as_filter(filter, n, device)


def _check_refine_cap(refine_cap, backend: str):
    """``refine_cap`` is a jnp-engine option: the fused engine
    (resolved backend "cuda") raises the reference's words."""
    if refine_cap is not None and backend == "cuda":
        raise ValueError("refine_cap compaction requires backend='jnp'"
                         " (the fused kernels bound phase-2 work with"
                         " the in-kernel top-k merge instead)")


# -------------------------------------------------------------- engines ----
# Each engine is a phase pair over ``(qs | carry, env)``: ``env`` is the
# borrowed index state (``*_phase_env``), the carry the crude phase's
# outputs that the refine phase is the last reader of.  The sequential
# searches below compose a pair block by block (``chunked_over_queries``);
# ``index/pipelined.py`` runs the same pair over query tiles, the crude
# phase of tile t+1 beside the refine phase of tile t.  Single-phase
# engines (one-step ADC, the crude rung) have no refine phase.

def _crude_list(qs, env, *, topk: int, quantized: bool, code_bits: int,
                fast, has_filter: bool):
    """A single-phase search over one query block: the crude stage's
    candidate list (no dense matrix), filtered rows +inf in the kernel
    and their slots reported as id -1.  Returns (ids (nq, topk), dist
    (nq, topk), pf = 0)."""
    pred = env["pred"] if has_filter else None
    stage = CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits,
                       want_crude=False)
    out = stage(env["codes"], build_lut(qs, env["C"]), fast, pred=pred)
    ids = (out.cand_idx if pred is None
           else mask_filtered_ids(out.cand_idx, out.cand_vals))
    zeros = torch.zeros(qs.shape[0], dtype=torch.float32, device=qs.device)
    return ids, out.cand_vals, zeros


def _adc_phase(qs, env, *, topk: int, quantized: bool, code_bits: int,
               has_filter: bool = False):
    """One-step ADC over one query block: a single crude stage over the
    full tables.  Returns (ids (nq, topk), dist (nq, topk), pf = 0)."""
    return _crude_list(qs, env, topk=topk, quantized=quantized,
                       code_bits=code_bits, fast=None, has_filter=has_filter)


def adc_phase_fns(*, topk: int, quantized: bool = False, code_bits: int = 8,
                  has_filter: bool = False):
    """One-step ADC as a phase pair: the whole search is its crude
    phase, so the refine slot is None."""
    return functools.partial(_adc_phase, topk=topk, quantized=quantized,
                             code_bits=code_bits,
                             has_filter=has_filter), None


def adc_result(idx, dist, pf, *, K: int) -> SearchResult:
    """One-step ADC's accounting: K LUT adds a point, everything
    'refined'."""
    one = torch.ones((), dtype=torch.float32, device=idx.device)
    return SearchResult(idx, dist, one * K, one)


def adc_search(queries, codes, C, topk: int, *, backend: str = "auto",
               query_chunk: Optional[int] = None, lut_dtype: str = "f32",
               code_bits: int = 8, filter=None) -> SearchResult:
    """Baseline one-step ADC: the full K-codebook LUT sum of every point.
    queries (nq, d) f32; codes (n, Kc) stored rows; C (K, m, d) f32.
    ``filter``: optional (n,) bool row predicate (a jnp-engine option,
    refused by the fused engine): excluded rows never appear; slots with
    no eligible row left report id -1 at distance +inf."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    crude_fn, _ = adc_phase_fns(
        topk=topk, quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]),
        has_filter=pred is not None)
    env = {"codes": codes, "C": C, "pred": pred}
    out = chunked_over_queries(functools.partial(crude_fn, env=env),
                               queries, query_chunk)
    return adc_result(*out, K=C.shape[0])


def two_step_phase_env(codes, C, structure, pred=None) -> dict:
    """The borrowed index state of the flat two-step phases: stored
    codes, codebooks, the ICQ structure's fast mask and margin, and the
    optional filter predicate."""
    return {"codes": codes, "C": C, "fast": structure.fast_mask,
            "sigma": structure.sigma, "pred": pred}


def _flat_crude_phase(qs, env, *, topk: int, quantized: bool,
                      code_bits: int, has_filter: bool = False, out=None,
                      before_launch=None):
    """Phase 1: per-query LUTs and the crude stage, filtered rows +inf
    under ``has_filter`` (``out``, optional, receives the dense crude
    matrix; ``before_launch``, optional, runs just before the kernel).
    Returns the carry (luts, crude, cand_vals, cand_idx) the refine
    phase reads."""
    luts = build_lut(qs, env["C"])                       # (nq, K, m)
    res = CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits)(
        env["codes"], luts, env["fast"], out=out, before_launch=before_launch,
        pred=env["pred"] if has_filter else None)
    return luts, res.crude, res.cand_vals, res.cand_idx


def _pass_frac(passed):
    # a count of passes is exact in any order; one rounding divides it
    return passed.sum(dim=1).to(torch.float32) / passed.shape[1]


def _flat_refine_phase(carry, env, *, topk: int, quantized: bool,
                       code_bits: int, refine_cap: Optional[int] = None,
                       has_filter: bool = False, before_launch=None):
    """Phases 2 and 3: the threshold bootstrap from the crude top-k (the
    fused engine's rule, ``from_candidates``; under the jnp engine's
    options the reference's jnp rule, ``from_dense_candidates``), then
    the refine stage or, with ``refine_cap``, the survivor selection and
    re-rank (``CappedStage``); ``before_launch``, optional, runs just
    before the first kernel.  Returns (idx, dist, passed_frac (nq,))."""
    luts, crude, cand_vals, cand_idx = carry
    codes, fast = env["codes"], env["fast"]
    tstage = ThresholdStage(topk=topk, quantized=quantized,
                            code_bits=code_bits)
    bootstrap = (tstage.from_dense_candidates
                 if has_filter or refine_cap is not None
                 else tstage.from_candidates)
    thr = bootstrap(luts, codes, cand_vals, cand_idx, fast, env["sigma"])
    if refine_cap is None:
        idx, dist, passed = RefineStage(topk=topk, code_bits=code_bits)(
            codes, luts, crude, thr, fast, before_launch=before_launch)
    else:
        idx, dist = CappedStage(topk=topk, cap=refine_cap,
                                code_bits=code_bits)(
            codes, luts, crude, thr, before_launch=before_launch)
        passed = crude < thr[:, None]
    if has_filter:
        idx = mask_filtered_ids(idx, dist)
    return idx, dist, _pass_frac(passed)


def _flat_crude_only_phase(qs, env, *, topk: int, quantized: bool,
                           code_bits: int, has_filter: bool = False):
    """The crude rung over one query block: the crude stage with the
    refine dropped, its candidate list (no dense matrix), filtered rows
    +inf in the kernel.  Returns (idx, dist, pf = 0)."""
    return _crude_list(qs, env, topk=topk, quantized=quantized,
                       code_bits=code_bits, fast=env["fast"],
                       has_filter=has_filter)


def two_step_phase_fns(*, topk: int, quantized: bool = False,
                       code_bits: int = 8, refine_cap: Optional[int] = None,
                       crude_only: bool = False, has_filter: bool = False):
    """The flat two-step engine as a ``(crude_fn, refine_fn)`` phase
    pair over ``(qs | carry, env)``.  ``crude_only`` is the crude rung
    (refine_fn None; crude_fn returns the final (idx, dist, pf));
    ``filter`` and ``refine_cap`` (the jnp engine's options) take the
    reference's jnp bootstrap rule, otherwise the fused engine's; the
    crude phase takes ``out=`` for its dense crude matrix and both
    phases a ``before_launch`` hook.  ``refine_cap`` arrives clamped
    into [topk, n]."""
    opts = dict(topk=topk, quantized=quantized, code_bits=code_bits,
                has_filter=has_filter)
    if crude_only:
        return functools.partial(_flat_crude_only_phase, **opts), None
    return (functools.partial(_flat_crude_phase, **opts),
            functools.partial(_flat_refine_phase, refine_cap=refine_cap,
                              **opts))


def two_step_result(idx, dist, pf, *, K: int, kf) -> SearchResult:
    """Fold per-query pass fractions into pass_rate and Average Ops
    (|K_fast| + pass_rate * (K - |K_fast|))."""
    pass_rate = torch.mean(pf)
    return SearchResult(idx, dist, kf + pass_rate * (K - kf), pass_rate)


def crude_result(idx, dist, pf, *, kf) -> SearchResult:
    """The crude rung's accounting: |K_fast| adds a point, nothing
    refined."""
    return SearchResult(idx, dist, kf, torch.mean(pf))


def _fast_count(structure) -> torch.Tensor:
    return torch.sum(structure.fast_mask.to(torch.float32))


def two_step_search(queries, codes, C, structure, topk: int, *,
                    backend: str = "auto",
                    query_chunk: Optional[int] = None,
                    refine_cap: Optional[int] = None,
                    lut_dtype: str = "f32", code_bits: int = 8,
                    filter=None) -> SearchResult:
    """ICQ two-step search (eq. 2 crude test -> eq. 1 refinement).

    structure: core.icq.ICQStructure (xi, fast_mask, sigma).
    code_bits: 8 (byte codes) | 4 (codes nibble-packed (n, ceil(K/2))
               uint8, codebook_size <= 16).
    lut_dtype: "f32" | "int8" (per-query quantized crude tables; the
               refine pass is always f32).
    refine_cap: the static survivor compaction (a jnp-engine option,
               refused by the fused engine): at most
               ``min(max(refine_cap, topk), n)`` best-crude survivors
               per query are re-ranked by one full-table sum.
    filter:    optional (n,) bool row predicate (a jnp-engine option):
               excluded rows get crude +inf before the eq. 2 bootstrap;
               unfilled slots report id -1 at distance +inf.
    query_chunk bounds the dense (chunk, n) crude matrix."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    _check_refine_cap(refine_cap, be)
    cap = (None if refine_cap is None
           else min(max(refine_cap, topk), codes.shape[0]))
    fns = two_step_phase_fns(
        topk=topk, quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]),
        refine_cap=cap, has_filter=pred is not None)
    env = two_step_phase_env(codes, C, structure, pred)
    out = chunked_over_queries(compose(*fns, env), queries, query_chunk)
    return two_step_result(*out, K=C.shape[0], kf=_fast_count(structure))


def two_step_search_compact(queries, codes, C, structure, topk: int,
                            refine_cap: int, *,
                            query_chunk: Optional[int] = None):
    """The reference's back-compat wrapper: ``two_step_search`` with
    the ``refine_cap`` survivor compaction under ``backend="jnp"``."""
    return two_step_search(queries, codes, C, structure, topk,
                           backend="jnp", query_chunk=query_chunk,
                           refine_cap=refine_cap)


def two_step_crude_search(queries, codes, C, structure, topk: int, *,
                          backend: str = "auto",
                          query_chunk: Optional[int] = None,
                          lut_dtype: str = "f32", code_bits: int = 8,
                          filter=None) -> SearchResult:
    """The degradation ladder's crude floor: rank by the fast-subset
    crude distance only, skipping eq. 2 and the refine pass; equal bit
    for bit to the crude top-k the full path bootstraps from.
    ``pass_rate`` is 0 (nothing refined), ``avg_ops`` |K_fast|.
    ``filter`` (a jnp-engine option) masks rows before the top-k."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    fns = two_step_phase_fns(
        topk=topk, quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]),
        crude_only=True, has_filter=pred is not None)
    env = two_step_phase_env(codes, C, structure, pred)
    out = chunked_over_queries(compose(*fns, env), queries, query_chunk)
    return crude_result(*out, kf=_fast_count(structure))


# -------------------------------------------------------------- indexes ----

def _encode_new_rows(new_vectors, C, codes_dtype, *, icm_iters: int,
                     encode_backend: str, point_chunk: Optional[int],
                     code_bits: int = 8) -> torch.Tensor:
    """The encode step of ``add``: ICM over the new embeddings (PQ warm
    start) on C's device, packed to the stored format (``codes_dtype``
    for byte codes, nibble rows under ``code_bits=4``)."""
    x = as_torch(new_vectors).to(C.device, torch.float32)
    new = icm_encode(x, C, icm_iters, backend=encode_backend,
                     point_chunk=point_chunk)
    if code_bits == 4:
        return pack_nibbles(new, C.shape[0])
    return new.to(codes_dtype)


@dataclasses.dataclass(frozen=True)
class _FlatBase:
    """Shared options, ``add`` and ``shard`` of the port's indexes
    (flat, two-step and IVF).  The CUDA kernels choose
    their own tiles, so the reference's ``block_q``/``block_n``/
    ``interpret`` options have no counterpart.  ``pipeline`` ("off" |
    "tiles" | "auto") routes ``search`` and ``search_crude`` through the
    pipelined executor (``index/pipelined.py``) in tiles of
    ``pipeline_tile`` queries."""
    topk: int = 50
    backend: str = "auto"
    query_chunk: Optional[int] = None
    lut_dtype: str = "f32"
    code_bits: int = 8
    pipeline: str = "off"
    pipeline_tile: Optional[int] = None

    def __post_init__(self):
        resolve_pipeline(self.pipeline)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def add(self, new_vectors, *, icm_iters: int = 3,
            encode_backend: str = "auto",
            point_chunk: Optional[int] = 8192):
        """Encode ``new_vectors`` ((n_new, d) embeddings, numpy or torch)
        and append their rows: an incremental build, no retraining.
        Returns a new index; the new rows get ids [n, n + n_new)."""
        new = _encode_new_rows(new_vectors, self.C, self.codes.dtype,
                               icm_iters=icm_iters,
                               encode_backend=encode_backend,
                               point_chunk=point_chunk,
                               code_bits=self.code_bits)
        return dataclasses.replace(self, codes=torch.cat([self.codes, new]))

    def shard(self, mesh):
        """The sharded serving clone over ``mesh``'s ``data`` axis
        (``index/sharded.py``): rows sharded for the flat kinds, lists
        for IVF; it serves ``pipeline="off"``."""
        from repro_torch.index.sharded import shard_index
        return shard_index(self, mesh)


@dataclasses.dataclass(frozen=True)
class FlatADC(_FlatBase):
    """One-step exhaustive ADC index (baseline; no pruning).
    codes (n, Kc) stored rows, C (K, m, d) f32, on one device."""
    codes: torch.Tensor = None
    C: torch.Tensor = None

    @classmethod
    def build(cls, codes, C, structure=None, **opts) -> "FlatADC":
        return cls(codes=codes, C=C, **opts)

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        k = topk if topk is not None else self.topk
        res = maybe_pipelined(self, queries, k, filter=filter)
        if res is not None:
            return res
        return adc_search(queries, self.codes, self.C, k,
                          backend=self.backend, query_chunk=self.query_chunk,
                          lut_dtype=self.lut_dtype, code_bits=self.code_bits,
                          filter=filter)

    def search_crude(self, queries, topk: Optional[int] = None, *,
                     filter=None) -> SearchResult:
        """One-step ADC has no crude/refine split: the crude floor of
        the degradation ladder is the full search itself."""
        return self.search(queries, topk, filter=filter)


@dataclasses.dataclass(frozen=True)
class TwoStep(_FlatBase):
    """Exhaustive ICQ two-step index (eq. 2 pruning, optional int8
    crude tables)."""
    codes: torch.Tensor = None
    C: torch.Tensor = None
    structure: object = None            # core.icq.ICQStructure
    refine_cap: Optional[int] = None

    @classmethod
    def build(cls, codes, C, structure, **opts) -> "TwoStep":
        return cls(codes=codes, C=C, structure=structure, **opts)

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        k = topk if topk is not None else self.topk
        res = maybe_pipelined(self, queries, k, filter=filter)
        if res is not None:
            return res
        return two_step_search(queries, self.codes, self.C, self.structure,
                               k, backend=self.backend,
                               query_chunk=self.query_chunk,
                               refine_cap=self.refine_cap,
                               lut_dtype=self.lut_dtype,
                               code_bits=self.code_bits, filter=filter)

    def search_crude(self, queries, topk: Optional[int] = None, *,
                     filter=None) -> SearchResult:
        """The crude floor of the degradation ladder: the fast-subset
        crude ranking, equal bit for bit to the crude top-k the full
        path bootstraps from.  Under a pipeline, the single-phase
        pipeline (the refine dropped)."""
        k = topk if topk is not None else self.topk
        res = maybe_pipelined(self, queries, k, filter=filter,
                              crude_only=True)
        if res is not None:
            return res
        return two_step_crude_search(
            queries, self.codes, self.C, self.structure, k,
            backend=self.backend,
            query_chunk=self.query_chunk, lut_dtype=self.lut_dtype,
            code_bits=self.code_bits, filter=filter)
