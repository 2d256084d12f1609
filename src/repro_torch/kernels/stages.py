"""The two-step search as three stages (twin of ``repro.kernels.stages``
for the kernel paths):

    CrudeStage      fast-subset LUT sums and the crude top-k (eq. 2,
                    phase 1), through ``ops.batched_crude_topk`` (flat)
                    or ``ops.ivf_crude_topk`` (``slab``: IVF candidates).
    ThresholdStage  the eq. 2 threshold bootstrap: among the crude top-k
                    take the candidate furthest by full distance; its
                    crude value plus sigma is the threshold.  Tiny
                    (nq, topk) PyTorch code over the kernels' candidate
                    lists: the fused engine's rule (``from_candidates``,
                    crude + slow) on the served path, the reference's
                    jnp rule (``from_dense_candidates``: one full-table
                    sum in f32, every slot in the far-element argmax on
                    the flat path) under the jnp engine's options
                    (``filter``, ``refine_cap``).
    RefineStage     slow-codebook sums for margin-test survivors and the
                    final top-k (eq. 1: full = crude + slow), through
                    ``ops.batched_refine_topk`` or ``ops.ivf_refine_topk``
                    (``slab``).
    CappedStage     the jnp engine's ``refine_cap`` tail: the cap
                    best-crude survivors (``ops.select_topk``) re-ranked
                    by one full-table f32 sum (``ops.rerank_topk``).

The ops wrappers launch the CUDA kernels for tensors on the card and run
the kernels' plain PyTorch versions for tensors on the CPU, so both
devices compose exactly the same stages.

Also here: the shared helpers of the kernel wrappers (``pad_to``, the
two-key top-k order, nibble unpack, geometry and operand checks) and the
LUT operands of both passes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.encode import unpack_nibbles
from repro_torch.index import base


# ------------------------------------------------------- shared helpers ----

def pad_to(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading axis of ``x`` up to ``rows`` (a query batch
    up to its serving tile)."""
    if x.shape[0] == rows:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, rows - x.shape[0]))


def topk_two_key(ranked: torch.Tensor, topk: int):
    """The top-k of each row in ascending (distance, column index)
    order: the reference's ``merge_topk`` / ``jax.lax.top_k`` order,
    where the lowest index wins a tie and a +inf tail carries the lowest
    indices among the +inf columns.  ``torch.topk`` promises no tie
    order, so this is a stable sort over index-ordered columns.
    Returns (vals (nq, topk) f32, idx (nq, topk) int32)."""
    vals, idx = torch.sort(ranked, dim=1, stable=True)
    return vals[:, :topk].contiguous(), idx[:, :topk].to(torch.int32)


def unpack_nibble_tile(packed: torch.Tensor) -> torch.Tensor:
    """(..., Kp) nibble bytes -> (..., 2*Kp) int64 codes, byte kp ->
    codebooks (2kp, 2kp+1), the odd-K sentinel column kept (its LUT
    column is zero)."""
    p = packed.long()
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])


def resolve_kernel_code_bits(code_bits: int, Kc: int, Km: int):
    """Stored code columns ``Kc`` -> codebook columns ``K`` (2*Kc under
    the nibble format) and codewords ``m`` of a flattened (nq, Km) LUT."""
    if code_bits not in (8, 4):
        raise ValueError(f"unknown code_bits {code_bits!r}; "
                         f"expected one of (8, 4)")
    K = 2 * Kc if code_bits == 4 else Kc
    if Km % K:
        raise ValueError(
            f"lut_flat width {Km} is not a multiple of K={K}"
            + (" (pad odd-K tables with index.base.pad_luts_even)"
               if code_bits == 4 else ""))
    return K, Km // K


def check_quantized_args(lut_flat, lut_scale, lut_offset) -> bool:
    """int8 LUTs need the per-query affine columns; f32 forbids them."""
    if lut_flat.dtype == torch.int8:
        if lut_scale is None or lut_offset is None:
            raise ValueError("int8 lut_flat requires lut_scale and "
                             "lut_offset (see index.base.quantize_lut)")
        return True
    if lut_scale is not None or lut_offset is not None:
        raise ValueError("lut_scale/lut_offset are only valid with an "
                         "int8 lut_flat")
    return False


def widen_codes(codes: torch.Tensor, K: int, code_bits: int):
    """Stored codes -> int32 codebook indices: plain widening for byte
    codes, nibble unpack (sentinel dropped) for ``code_bits=4``."""
    if code_bits == 4:
        return unpack_nibbles(codes, K)
    return codes.to(torch.int32)


# ---------------------------------------------------- kernel LUT operands ----

def crude_lut_operands(luts: torch.Tensor, fast=None, *, quantized: bool,
                       code_bits: int = 8):
    """The crude kernel's operands ``(lut_flat, lut_scale, lut_offset)``
    from (nq, K, m) f32 tables and the optional fast mask: f32 masks the
    tables; int8 calibrates the per-query affine (even-K padded under
    the nibble format)."""
    nibble = code_bits == 4
    if quantized:
        return (base.fastscan_kernel_operands(luts, fast) if nibble
                else base.quantized_kernel_operands(luts, fast))
    lut = luts if fast is None else luts * fast.to(luts.dtype)[None, :, None]
    lut = base.pad_luts_even(lut) if nibble else lut
    return lut.reshape(luts.shape[0], -1), None, None


def slow_lut_operand(luts: torch.Tensor, fast, *, code_bits: int = 8):
    """The refine kernel's flattened slow-masked f32 tables (the refine
    pass is never quantized)."""
    lut_slow = luts * (1.0 - fast.to(luts.dtype)[None, :, None])
    if code_bits == 4:
        lut_slow = base.pad_luts_even(lut_slow)
    return lut_slow.reshape(luts.shape[0], -1)


def full_lut_operand(luts: torch.Tensor, *, code_bits: int = 8):
    """The re-rank's flattened f32 tables: every codebook (even-K padded
    under the nibble format)."""
    lut = base.pad_luts_even(luts) if code_bits == 4 else luts
    return lut.reshape(luts.shape[0], -1)


# --------------------------------------------------------------- stages ----

def _call(hook) -> None:
    if hook is not None:
        hook()


class CrudeOut(NamedTuple):
    """``crude`` is the dense (nq, n) or slab (nq, nc) crude matrix
    (None when ``want_crude=False``); ``cand_vals``/``cand_idx`` the
    crude top-k (global indices, or slab positions for ``slab``)."""
    crude: Optional[torch.Tensor]
    cand_vals: torch.Tensor
    cand_idx: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CrudeStage:
    """Phase 1 of eq. 2: fast-subset crude distances and their top-k."""
    topk: int = 50
    quantized: bool = False
    code_bits: int = 8
    want_crude: bool = True

    def __call__(self, codes, luts, fast=None, *, out=None,
                 before_launch=None, pred=None) -> CrudeOut:
        """codes (n, Kc) stored rows, luts (nq, K, m) f32, fast optional
        (K,) bool (None = full-table one-step ADC); ``out`` (nq, n) f32,
        optional, receives the dense crude matrix; ``before_launch``,
        optional, is called between the LUT operands and the kernel
        (the pipelined executor's stream waits); ``pred`` (n,) bool,
        optional (a filter), makes the rows it excludes +inf in the
        crude matrix and the candidate list."""
        from repro_torch.kernels import ops
        lut_flat, scale, offset = crude_lut_operands(
            luts, fast, quantized=self.quantized, code_bits=self.code_bits)
        _call(before_launch)
        return CrudeOut(*ops.batched_crude_topk(
            codes, lut_flat, self.topk, want_crude=self.want_crude,
            lut_scale=scale, lut_offset=offset, code_bits=self.code_bits,
            out=out, pred=pred))

    def slab(self, cand_codes, cand_ids, luts, fast, *, out=None,
             before_launch=None) -> CrudeOut:
        """IVF crude pass over the gathered candidate slab.  cand_codes
        (nq, nc, Kc) stored rows, cand_ids (nq, nc) global ids (-1 =
        invalid; invalid columns are +inf in the dense crude output, so
        the refine pass inherits the mask); ``out`` (nq, nc) f32,
        optional, receives it; ``before_launch`` as in ``__call__``."""
        from repro_torch.kernels import ops
        lut_flat, scale, offset = crude_lut_operands(
            luts, fast, quantized=self.quantized, code_bits=self.code_bits)
        _call(before_launch)
        return CrudeOut(*ops.ivf_crude_topk(
            cand_codes, cand_ids, lut_flat, self.topk, lut_scale=scale,
            lut_offset=offset, code_bits=self.code_bits, out=out))


@dataclasses.dataclass(frozen=True)
class ThresholdStage:
    """The eq. 2 threshold bootstrap."""
    topk: int = 50
    quantized: bool = False
    code_bits: int = 8

    def _cand_codes(self, codes, cand, K):
        cand_codes = codes[cand.long()]                     # (nq, topk, Kc)
        return widen_codes(cand_codes, K, self.code_bits)

    def from_dense(self, luts, codes, crude, fast, sigma):
        """Bootstrap from the dense crude matrix (the reference's jnp
        path): ``from_dense_candidates`` over its two-key top-k."""
        cand_c, cand = topk_two_key(crude, self.topk)
        return self.from_dense_candidates(luts, codes, cand_c, cand, fast,
                                          sigma)

    def from_dense_candidates(self, luts, codes, cand_c, cand, fast,
                              sigma):
        """The reference's jnp bootstrap rule over the crude top-k
        (the crude kernel's candidate list, the two-key top-k of the
        dense matrix): f32 ranks candidates by one full-table sum, int8
        by quantized crude + exact slow.  Every slot takes part in the
        far-element argmax, the +inf slots of filtered rows included
        (their full-table sums are finite, so a filtered search with
        fewer eligible rows than topk can get a finite threshold), as in
        the reference."""
        cand_codes = self._cand_codes(codes, cand, luts.shape[1])
        if not self.quantized:
            full_cand = base.lut_sum(luts, cand_codes)
        else:
            full_cand = cand_c + base.lut_sum(luts, cand_codes, ~fast)
        far = torch.argmax(full_cand, dim=1)
        return cand_c.gather(1, far[:, None])[:, 0] + sigma

    def from_dense_slab(self, luts, cand_codes, crude, fast, sigma):
        """Bootstrap from the dense slab crude (the reference's jnp IVF
        path): ``from_dense_slab_candidates`` over its two-key top-k."""
        cand_c, cand = topk_two_key(crude, self.topk)
        return self.from_dense_slab_candidates(luts, cand_codes, cand_c,
                                               cand, fast, sigma)

    def from_dense_slab_candidates(self, luts, cand_codes, cand_c, cand,
                                   fast, sigma):
        """The reference's jnp IVF bootstrap rule over the slab crude
        top-k of slab positions (the slab crude kernel's candidate
        list): f32 ranks candidates by one full-table sum, int8 by
        quantized crude + exact slow; the +inf candidates (slabs thinner
        than topk, filtered candidates) are left out of the far-element
        argmax."""
        cand_top = torch.gather(
            cand_codes, 1,
            cand.long()[:, :, None].expand(-1, -1, cand_codes.shape[2]))
        cand_top = widen_codes(cand_top, luts.shape[1], self.code_bits)
        if not self.quantized:
            full_cand = base.lut_sum(luts, cand_top)
        else:
            full_cand = cand_c + base.lut_sum(luts, cand_top, ~fast)
        far = torch.argmax(torch.where(
            torch.isfinite(cand_c), full_cand,
            torch.full_like(full_cand, -float("inf"))), dim=1)
        return cand_c.gather(1, far[:, None])[:, 0] + sigma

    def from_candidates(self, luts, codes, cand_vals, cand_idx, fast,
                        sigma):
        """Bootstrap from the crude kernel's top-k (the served path):
        candidate full distance = crude + exact slow on either LUT
        dtype (``cand_vals`` are already true-distance f32)."""
        cand_codes = self._cand_codes(codes, cand_idx, luts.shape[1])
        full_cand = cand_vals + base.lut_sum(luts, cand_codes, ~fast)
        far = torch.argmax(full_cand, dim=1)
        return cand_vals.gather(1, far[:, None])[:, 0] + sigma

    def from_slab_candidates(self, luts, cand_codes, cand_vals, cand_pos,
                             fast, sigma):
        """Bootstrap from the slab crude kernel's top-k of slab
        positions; the +inf slots of slabs thinner than topk are left
        out of the far-element argmax."""
        ok = torch.isfinite(cand_vals)
        pos = torch.where(ok, cand_pos, torch.zeros_like(cand_pos)).long()
        cand_top = torch.gather(
            cand_codes, 1,
            pos[:, :, None].expand(-1, -1, cand_codes.shape[2]))
        cand_top = widen_codes(cand_top, luts.shape[1], self.code_bits)
        full_cand = cand_vals + base.lut_sum(luts, cand_top, ~fast)
        far = torch.argmax(torch.where(
            ok, full_cand, torch.full_like(full_cand, -float("inf"))), dim=1)
        return cand_vals.gather(1, far[:, None])[:, 0] + sigma


@dataclasses.dataclass(frozen=True)
class RefineStage:
    """Phase 2 of eq. 2: slow sums for margin-test survivors and the
    final full-distance top-k."""
    topk: int = 50
    code_bits: int = 8

    def __call__(self, codes, luts, crude, thr, fast, *,
                 before_launch=None):
        """Returns (idx, dist, passed): ``passed`` is the (nq, n) margin
        test mask recomputed from crude (the kernel evaluates the same
        expression), the pass-rate input.  ``before_launch``, optional,
        is called just before the kernel."""
        from repro_torch.kernels import ops
        lut_slow = slow_lut_operand(luts, fast, code_bits=self.code_bits)
        _call(before_launch)
        dist, idx = ops.batched_refine_topk(codes, lut_slow, crude, thr,
                                            self.topk,
                                            code_bits=self.code_bits)
        return idx, dist, crude < thr[:, None]

    def slab(self, cand_codes, luts, crude, thr, fast, safe, *,
             before_launch=None):
        """IVF refine over the candidate slab.  ``safe`` (nq, nc) maps
        slab positions to global ids (0 at invalid columns), through
        ``safe[min(pos, nc - 1)]`` as the reference does, so the +inf
        tail carries the same ids.  Returns (ids, dist, passed).
        ``before_launch`` as in ``__call__``."""
        from repro_torch.kernels import ops
        lut_slow = slow_lut_operand(luts, fast, code_bits=self.code_bits)
        _call(before_launch)
        dist, pos = ops.ivf_refine_topk(cand_codes, lut_slow, crude, thr,
                                        self.topk, code_bits=self.code_bits)
        pos = torch.clamp(pos.long(), max=safe.shape[1] - 1)
        return safe.gather(1, pos), dist, crude < thr[:, None]


@dataclasses.dataclass(frozen=True)
class CappedStage:
    """The jnp engine's ``refine_cap`` tail (the reference's
    ``_two_step_block_compact``): the ``cap`` best-crude margin-test
    survivors of each query, re-ranked by one full-table f32 sum."""
    topk: int = 50
    cap: int = 64
    code_bits: int = 8

    def __call__(self, codes, luts, crude, thr, *, before_launch=None):
        """codes (n, Kc) shared rows (flat) or (nq, nc, Kc) each query's
        slab, luts (nq, K, m) f32, crude (nq, n | nc), thr (nq,).
        Returns (positions (nq, topk) int64: rows, or slab positions;
        dist (nq, topk)), +inf past the survivors.  ``before_launch``,
        optional, is called just before the selection kernel."""
        from repro_torch.kernels import ops
        _call(before_launch)
        s_vals, surv = ops.select_topk(crude, thr, self.cap)
        surv = surv.long()
        if codes.ndim == 2:
            surv_codes = codes[surv]                      # (nq, cap, Kc)
        else:
            surv_codes = torch.gather(
                codes, 1, surv[:, :, None].expand(-1, -1, codes.shape[2]))
        dist, pos = ops.rerank_topk(
            surv_codes.contiguous(),
            full_lut_operand(luts, code_bits=self.code_bits),
            torch.isfinite(s_vals), self.topk, code_bits=self.code_bits)
        return surv.gather(1, pos.long()), dist


def two_step_stages(*, topk: int, quantized: bool = False,
                    code_bits: int = 8, want_crude: bool = True):
    """The crude -> threshold -> refine triple of one configuration."""
    return (CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits,
                       want_crude=want_crude),
            ThresholdStage(topk=topk, quantized=quantized,
                           code_bits=code_bits),
            RefineStage(topk=topk, code_bits=code_bits))
