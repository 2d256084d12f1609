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

``add`` grows an index without retraining: the new rows are encoded by
the ICM engine (``core.encode.icm_encode``, the ICM kernel on the card)
and appended, so a grown index equals one built over all rows at once.

Options of the reference still to be ported raise by name, each naming
its ROADMAP.md item: ``refine_cap`` (queue 1, the jnp-only capped
refine), ``filter`` (queue 1, filtered search), ``pipeline`` (queue 1,
item 7), ``search_crude`` (queue 1, the degradation ladder) and
``shard`` (queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.encode import icm_encode, pack_nibbles
from repro_torch.index.base import (SearchResult, as_torch, build_lut,
                                    chunked_over_queries, resolve_backend,
                                    resolve_code_bits, resolve_lut_dtype)
from repro_torch.kernels.stages import CrudeStage, two_step_stages


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


def _check_filter(filter):
    if filter is not None:
        raise _not_ported("filtered search (filter=)", "queue 1, item 2")


# -------------------------------------------------------------- engines ----

def _adc_block(qs, codes, C, *, topk: int, quantized: bool,
               code_bits: int):
    """One-step ADC over one query block: a single crude stage over the
    full tables.  Returns (ids (nq, topk), dist (nq, topk))."""
    stage = CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits,
                       want_crude=False)
    out = stage(codes, build_lut(qs, C), None)
    return out.cand_idx, out.cand_vals


def adc_search(queries, codes, C, topk: int, *, backend: str = "auto",
               query_chunk: Optional[int] = None, lut_dtype: str = "f32",
               code_bits: int = 8, filter=None) -> SearchResult:
    """Baseline one-step ADC: the full K-codebook LUT sum of every point.
    queries (nq, d) f32; codes (n, Kc) stored rows; C (K, m, d) f32."""
    resolve_backend(backend, codes.device)
    _check_filter(filter)
    K = C.shape[0]
    fn = functools.partial(
        _adc_block, codes=codes, C=C, topk=topk,
        quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]))
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
    # a count of passes is exact in any order; one rounding divides it
    frac = passed.sum(dim=1).to(torch.float32) / passed.shape[1]
    return idx, dist, frac


def _two_step_block(qs, env, *, topk: int, quantized: bool, code_bits: int):
    """The crude and refine phases back to back over one query block."""
    opts = dict(topk=topk, quantized=quantized, code_bits=code_bits)
    return _flat_refine_phase(_flat_crude_phase(qs, env, **opts), env,
                              **opts)


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
    query_chunk bounds the dense (chunk, n) crude matrix."""
    resolve_backend(backend, codes.device)
    _check_filter(filter)
    if refine_cap is not None:
        raise _not_ported("refine_cap (the capped refine)", "queue 1, item 2")
    K = C.shape[0]
    fast = structure.fast_mask
    kf = torch.sum(fast.to(torch.float32))
    env = {"codes": codes, "C": C, "fast": fast, "sigma": structure.sigma}
    fn = functools.partial(
        _two_step_block, env=env, topk=topk,
        quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]))
    idx, dist, pf = chunked_over_queries(fn, queries, query_chunk)
    pass_rate = torch.mean(pf)
    return SearchResult(idx, dist, kf + pass_rate * (K - kf), pass_rate)


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

    def search_crude(self, queries, topk=None, *, filter=None):
        raise _not_ported("search_crude (the crude rung of the "
                          "degradation ladder)", "queue 1, item 4")

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


@dataclasses.dataclass(frozen=True)
class TwoStep(_FlatBase):
    """Exhaustive ICQ two-step index (eq. 2 pruning, optional int8
    crude tables)."""
    codes: torch.Tensor = None
    C: torch.Tensor = None
    structure: object = None            # core.icq.ICQStructure
    refine_cap: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()
        if self.refine_cap is not None:
            raise _not_ported("index.refine_cap (the capped refine)",
                              "queue 1, item 2")

    @classmethod
    def build(cls, codes, C, structure, **opts) -> "TwoStep":
        return cls(codes=codes, C=C, structure=structure, **opts)

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        return two_step_search(queries, self.codes, self.C, self.structure,
                               topk if topk is not None else self.topk,
                               backend=self.backend,
                               query_chunk=self.query_chunk,
                               lut_dtype=self.lut_dtype,
                               code_bits=self.code_bits, filter=filter)
