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
survivor compaction) are the reference's jnp-engine options: the plain
versions serve them on the CPU through the reference's jnp composition
(the dense crude matrix, filtered rows +inf before any top-k, the
bootstrap from it), and on the card they raise the reference's
``ValueError``: the kernels cannot mask rows by predicate or compact
survivors, as the fused Pallas kernels cannot.

``add`` grows an index without retraining: the new rows are encoded by
the ICM engine (``core.encode.icm_encode``, the ICM kernel on the card)
and appended, so a grown index equals one built over all rows at once.
``pipeline`` (queue 1, item 7) and ``shard`` (item 10) raise, naming
their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.encode import icm_encode, pack_nibbles
from repro_torch.index import base
from repro_torch.index.base import (SearchResult, as_filter, as_torch,
                                    build_lut, chunked_over_queries,
                                    mask_filtered_ids, resolve_backend,
                                    resolve_code_bits, resolve_lut_dtype)
from repro_torch.kernels.stages import (CrudeStage, RefineStage,
                                        ThresholdStage, topk_two_key,
                                        two_step_stages, widen_codes)

_INF = float("inf")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, {item})")


def _check_fastscan_geometry(code_bits: int, m: int) -> int:
    """``code_bits=4`` stores two codes per byte: m <= 16 codewords."""
    code_bits = resolve_code_bits(code_bits)
    if code_bits == 4 and m > 16:
        raise ValueError(f"code_bits=4 requires codebook_size <= 16 "
                         f"codewords (4-bit codes), got m={m}")
    return code_bits


def _check_filter(filter, n: int, backend: str, device):
    """The row predicate of a filtered search, or None.  A jnp-engine
    option, as in the reference: the kernels cannot mask rows by
    predicate, so on the card it raises by name."""
    if filter is None:
        return None
    if backend == "cuda":
        raise ValueError("filtered search requires backend='jnp' (the "
                         "fused kernels cannot mask rows by predicate; "
                         "like refine_cap, filter is a jnp-engine "
                         "option)")
    return as_filter(filter, n, device)


def _check_refine_cap(refine_cap, backend: str):
    if refine_cap is not None and backend == "cuda":
        raise ValueError("refine_cap compaction requires backend='jnp'"
                         " (the fused kernels bound phase-2 work with"
                         " the in-kernel top-k merge instead)")


def _masked_crude(crude, pred):
    """Filtered rows score +inf before any top-k."""
    return crude if pred is None else torch.where(
        pred[None, :], crude, torch.full_like(crude, _INF))


def _dense_topk(crude, topk: int, pred):
    """The top-k of a dense crude matrix (ids, dist), filtered slots
    reported as id -1."""
    dist, idx = topk_two_key(_masked_crude(crude, pred), topk)
    return (idx if pred is None else mask_filtered_ids(idx, dist)), dist


def capped_refine(luts, codes, crude, thr, topk: int, cap: int, *,
                  code_bits: int):
    """The static survivor compaction (the reference's jnp ``refine_cap``
    tail): the ``cap`` best-crude margin-test survivors of each row are
    gathered (``codes`` (n, Kc) shared or (nq, n, Kc) per query) and
    re-ranked by one full-table sum.  Returns (positions (nq, topk),
    dist (nq, topk)); +inf past the survivors."""
    K = luts.shape[1]
    passed = crude < thr[:, None]
    s_vals, surv = topk_two_key(
        torch.where(passed, crude, torch.full_like(crude, _INF)), cap)
    surv = surv.long()
    if codes.ndim == 2:
        surv_codes = codes[surv]                          # (nq, cap, Kc)
    else:
        surv_codes = torch.gather(
            codes, 1, surv[:, :, None].expand(-1, -1, codes.shape[2]))
    full = base.lut_sum(luts, widen_codes(surv_codes, K, code_bits))
    ranked = torch.where(torch.isfinite(s_vals), full,
                         torch.full_like(full, _INF))
    dist, pos = topk_two_key(ranked, topk)
    return surv.gather(1, pos.long()), dist


# -------------------------------------------------------------- engines ----

def _adc_block(qs, codes, C, *, topk: int, quantized: bool,
               code_bits: int, pred=None):
    """One-step ADC over one query block: a single crude stage over the
    full tables (with a filter, its dense crude matrix ranked here).
    Returns (ids (nq, topk), dist (nq, topk))."""
    stage = CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits,
                       want_crude=pred is not None)
    out = stage(codes, build_lut(qs, C), None)
    if pred is None:
        return out.cand_idx, out.cand_vals
    return _dense_topk(out.crude, topk, pred)


def adc_search(queries, codes, C, topk: int, *, backend: str = "auto",
               query_chunk: Optional[int] = None, lut_dtype: str = "f32",
               code_bits: int = 8, filter=None) -> SearchResult:
    """Baseline one-step ADC: the full K-codebook LUT sum of every point.
    queries (nq, d) f32; codes (n, Kc) stored rows; C (K, m, d) f32.
    ``filter``: optional (n,) bool row predicate (plain versions only):
    excluded rows never appear; slots with no eligible row left report
    id -1 at distance +inf."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    K = C.shape[0]
    fn = functools.partial(
        _adc_block, codes=codes, C=C, topk=topk,
        quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]),
        pred=pred)
    idx, vals = chunked_over_queries(fn, queries, query_chunk)
    one = torch.ones((), dtype=torch.float32, device=codes.device)
    return SearchResult(idx, vals, one * K, one)


def _flat_crude_phase(qs, env, *, topk: int, quantized: bool,
                      code_bits: int):
    """Phase 1: per-query LUTs and the crude stage.  Returns the carry
    (luts, crude, cand_vals, cand_idx) the refine phase reads."""
    crude_stage, _, _ = two_step_stages(topk=topk, quantized=quantized,
                                        code_bits=code_bits)
    luts = build_lut(qs, env["C"])                       # (nq, K, m)
    out = crude_stage(env["codes"], luts, env["fast"])
    return luts, out.crude, out.cand_vals, out.cand_idx


def _pass_frac(passed):
    # a count of passes is exact in any order; one rounding divides it
    return passed.sum(dim=1).to(torch.float32) / passed.shape[1]


def _flat_refine_phase(carry, env, *, topk: int, quantized: bool,
                       code_bits: int):
    """Phases 2 and 3: the threshold bootstrap from the crude top-k and
    the refine stage.  Returns (idx, dist, passed_frac (nq,))."""
    luts, crude, cand_vals, cand_idx = carry
    codes, fast = env["codes"], env["fast"]
    _, tstage, rstage = two_step_stages(topk=topk, quantized=quantized,
                                        code_bits=code_bits)
    thr = tstage.from_candidates(luts, codes, cand_vals, cand_idx, fast,
                                 env["sigma"])
    idx, dist, passed = rstage(codes, luts, crude, thr, fast)
    return idx, dist, _pass_frac(passed)


def _two_step_block(qs, env, *, topk: int, quantized: bool, code_bits: int):
    """The crude and refine phases back to back over one query block."""
    opts = dict(topk=topk, quantized=quantized, code_bits=code_bits)
    return _flat_refine_phase(_flat_crude_phase(qs, env, **opts), env,
                              **opts)


def _two_step_block_dense(qs, env, *, topk: int, quantized: bool,
                          code_bits: int, refine_cap: Optional[int],
                          pred=None):
    """The reference's jnp two-step over one query block, for the plain
    versions' options: the dense crude matrix with filtered rows +inf,
    the bootstrap from it (``ThresholdStage.from_dense``), then the
    refine stage or, with ``refine_cap``, the survivor compaction."""
    codes, fast = env["codes"], env["fast"]
    luts = build_lut(qs, env["C"])
    crude = CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits)(
        codes, luts, fast).crude
    crude = _masked_crude(crude, pred)
    thr = ThresholdStage(topk=topk, quantized=quantized,
                         code_bits=code_bits).from_dense(
        luts, codes, crude, fast, env["sigma"])
    if refine_cap is None:
        idx, dist, passed = RefineStage(topk=topk, code_bits=code_bits)(
            codes, luts, crude, thr, fast)
    else:
        idx, dist = capped_refine(luts, codes, crude, thr, topk, refine_cap,
                                  code_bits=code_bits)
        passed = crude < thr[:, None]
    if pred is not None:
        idx = mask_filtered_ids(idx, dist)
    return idx, dist, _pass_frac(passed)


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
    refine_cap: the static survivor compaction (plain versions only):
               at most ``min(max(refine_cap, topk), n)`` best-crude
               survivors per query are refined.
    filter:    optional (n,) bool row predicate (plain versions only):
               excluded rows get crude +inf before the eq. 2 bootstrap;
               unfilled slots report id -1 at distance +inf.
    query_chunk bounds the dense (chunk, n) crude matrix."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    _check_refine_cap(refine_cap, be)
    K = C.shape[0]
    fast = structure.fast_mask
    kf = torch.sum(fast.to(torch.float32))
    env = {"codes": codes, "C": C, "fast": fast, "sigma": structure.sigma}
    opts = dict(env=env, topk=topk,
                quantized=resolve_lut_dtype(lut_dtype) == "int8",
                code_bits=_check_fastscan_geometry(code_bits, C.shape[1]))
    if pred is None and refine_cap is None:
        fn = functools.partial(_two_step_block, **opts)
    else:
        cap = (None if refine_cap is None
               else min(max(refine_cap, topk), codes.shape[0]))
        fn = functools.partial(_two_step_block_dense, refine_cap=cap,
                               pred=pred, **opts)
    idx, dist, pf = chunked_over_queries(fn, queries, query_chunk)
    pass_rate = torch.mean(pf)
    return SearchResult(idx, dist, kf + pass_rate * (K - kf), pass_rate)


def _two_step_crude_block(qs, env, *, topk: int, quantized: bool,
                          code_bits: int, pred=None):
    """The crude rung over one query block: the crude stage with the
    refine dropped.  Unfiltered, its candidate list (no dense matrix);
    filtered (plain versions), the dense crude matrix masked and
    ranked.  Returns (idx, dist, pf = 0)."""
    stage = CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits,
                       want_crude=pred is not None)
    out = stage(env["codes"], build_lut(qs, env["C"]), env["fast"])
    zeros = torch.zeros(qs.shape[0], dtype=torch.float32, device=qs.device)
    if pred is None:
        return out.cand_idx, out.cand_vals, zeros
    return (*_dense_topk(out.crude, topk, pred), zeros)


def two_step_crude_search(queries, codes, C, structure, topk: int, *,
                          backend: str = "auto",
                          query_chunk: Optional[int] = None,
                          lut_dtype: str = "f32", code_bits: int = 8,
                          filter=None) -> SearchResult:
    """The degradation ladder's crude floor: rank by the fast-subset
    crude distance only, skipping eq. 2 and the refine pass; equal bit
    for bit to the crude top-k the full path bootstraps from.
    ``pass_rate`` is 0 (nothing refined), ``avg_ops`` |K_fast|.
    ``filter`` (plain versions only) masks rows before the top-k."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    fast = structure.fast_mask
    env = {"codes": codes, "C": C, "fast": fast}
    fn = functools.partial(
        _two_step_crude_block, env=env, topk=topk,
        quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]),
        pred=pred)
    idx, dist, pf = chunked_over_queries(fn, queries, query_chunk)
    return SearchResult(idx, dist, torch.sum(fast.to(torch.float32)),
                        torch.mean(pf))


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
    """Shared options, ``add`` and the not-yet-ported verbs of the
    port's indexes (flat, two-step and IVF).  The CUDA kernels choose
    their own tiles, so the reference's ``block_q``/``block_n``/
    ``interpret`` options have no counterpart."""
    topk: int = 50
    backend: str = "auto"
    query_chunk: Optional[int] = None
    lut_dtype: str = "f32"
    code_bits: int = 8
    pipeline: str = "off"
    pipeline_tile: Optional[int] = None

    def __post_init__(self):
        if self.pipeline != "off":
            raise _not_ported(f"serve.pipeline={self.pipeline!r} (the "
                              "pipelined executor)", "queue 1, item 7")

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
        raise _not_ported("Index.shard (sharded serving)",
                          "queue 1, item 10")


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
        return adc_search(queries, self.codes, self.C,
                          topk if topk is not None else self.topk,
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
        return two_step_search(queries, self.codes, self.C, self.structure,
                               topk if topk is not None else self.topk,
                               backend=self.backend,
                               query_chunk=self.query_chunk,
                               refine_cap=self.refine_cap,
                               lut_dtype=self.lut_dtype,
                               code_bits=self.code_bits, filter=filter)

    def search_crude(self, queries, topk: Optional[int] = None, *,
                     filter=None) -> SearchResult:
        """The crude floor of the degradation ladder: the fast-subset
        crude ranking, equal bit for bit to the crude top-k the full
        path bootstraps from."""
        return two_step_crude_search(
            queries, self.codes, self.C, self.structure,
            topk if topk is not None else self.topk, backend=self.backend,
            query_chunk=self.query_chunk, lut_dtype=self.lut_dtype,
            code_bits=self.code_bits, filter=filter)
