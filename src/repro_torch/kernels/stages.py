"""The two-step search as three stages (twin of ``repro.kernels.stages``
for the kernel paths):

    CrudeStage      fast-subset LUT sums and the crude top-k (eq. 2,
                    phase 1), through ``ops.batched_crude_topk`` (flat)
                    or ``ops.ivf_crude_topk`` (``slab``: IVF candidates).
    ThresholdStage  the eq. 2 threshold bootstrap: among the crude top-k
                    take the candidate furthest by full distance; its
                    crude value plus sigma is the threshold.  Tiny
                    (nq, topk) PyTorch code.
    RefineStage     slow-codebook sums for margin-test survivors and the
                    final top-k (eq. 1: full = crude + slow), through
                    ``ops.batched_refine_topk`` or ``ops.ivf_refine_topk``
                    (``slab``).

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


# --------------------------------------------------------------- stages ----

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

    def __call__(self, codes, luts, fast=None) -> CrudeOut:
        """codes (n, Kc) stored rows, luts (nq, K, m) f32, fast optional
        (K,) bool (None = full-table one-step ADC)."""
        from repro_torch.kernels import ops
        lut_flat, scale, offset = crude_lut_operands(
            luts, fast, quantized=self.quantized, code_bits=self.code_bits)
        return CrudeOut(*ops.batched_crude_topk(
            codes, lut_flat, self.topk, want_crude=self.want_crude,
            lut_scale=scale, lut_offset=offset, code_bits=self.code_bits))

    def slab(self, cand_codes, cand_ids, luts, fast) -> CrudeOut:
        """IVF crude pass over the gathered candidate slab.  cand_codes
        (nq, nc, Kc) stored rows, cand_ids (nq, nc) global ids (-1 =
        invalid; invalid columns are +inf in the dense crude output, so
        the refine pass inherits the mask)."""
        from repro_torch.kernels import ops
        lut_flat, scale, offset = crude_lut_operands(
            luts, fast, quantized=self.quantized, code_bits=self.code_bits)
        return CrudeOut(*ops.ivf_crude_topk(
            cand_codes, cand_ids, lut_flat, self.topk, lut_scale=scale,
            lut_offset=offset, code_bits=self.code_bits))


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
        path): f32 ranks candidates by one full-table sum, int8 by
        quantized crude + exact slow."""
        cand_c, cand = topk_two_key(crude, self.topk)
        cand_codes = self._cand_codes(codes, cand, luts.shape[1])
        if not self.quantized:
            full_cand = base.lut_sum(luts, cand_codes)
        else:
            full_cand = cand_c + base.lut_sum(luts, cand_codes, ~fast)
        far = torch.argmax(full_cand, dim=1)
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

    def __call__(self, codes, luts, crude, thr, fast):
        """Returns (idx, dist, passed): ``passed`` is the (nq, n) margin
        test mask recomputed from crude (the kernel evaluates the same
        expression), the pass-rate input."""
        from repro_torch.kernels import ops
        lut_slow = slow_lut_operand(luts, fast, code_bits=self.code_bits)
        dist, idx = ops.batched_refine_topk(codes, lut_slow, crude, thr,
                                            self.topk,
                                            code_bits=self.code_bits)
        return idx, dist, crude < thr[:, None]

    def slab(self, cand_codes, luts, crude, thr, fast, safe):
        """IVF refine over the candidate slab.  ``safe`` (nq, nc) maps
        slab positions to global ids (0 at invalid columns), through
        ``safe[min(pos, nc - 1)]`` as the reference does, so the +inf
        tail carries the same ids.  Returns (ids, dist, passed)."""
        from repro_torch.kernels import ops
        lut_slow = slow_lut_operand(luts, fast, code_bits=self.code_bits)
        dist, pos = ops.ivf_refine_topk(cand_codes, lut_slow, crude, thr,
                                        self.topk, code_bits=self.code_bits)
        pos = torch.clamp(pos.long(), max=safe.shape[1] - 1)
        return safe.gather(1, pos), dist, crude < thr[:, None]


def two_step_stages(*, topk: int, quantized: bool = False,
                    code_bits: int = 8, want_crude: bool = True):
    """The crude -> threshold -> refine triple of one configuration."""
    return (CrudeStage(topk=topk, quantized=quantized, code_bits=code_bits,
                       want_crude=want_crude),
            ThresholdStage(topk=topk, quantized=quantized,
                           code_bits=code_bits),
            RefineStage(topk=topk, code_bits=code_bits))
