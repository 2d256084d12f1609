"""Public entry points of the port's kernels (twin of
``repro.kernels.ops``).  Each one launches the CUDA kernel for tensors
on the card and runs the kernel's plain PyTorch version for tensors on
the CPU; nothing falls back from one to the other.  ``LAUNCHES`` counts
the kernel launches of each wrapper."""
from __future__ import annotations

from repro_torch.kernels import batched_search as bs
from repro_torch.kernels import kmeans as km
from repro_torch.kernels.build import LAUNCHES  # noqa: F401


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the kernels run on cuda or cpu tensors, got "
                     f"{t.device}")


def batched_crude_topk(codes, lut_flat, topk: int, *,
                       want_crude: bool = True, lut_scale=None,
                       lut_offset=None, code_bits: int = 8):
    """Phase 1: crude LUT sums of every (query, point) pair and their
    top-k.  codes (n, Kc) stored rows (nibble rows under
    ``code_bits=4``, against an even-K lut_flat), lut_flat (nq, K*m)
    fast-masked f32, or int8 with ``lut_scale``/``lut_offset`` (nq,)
    -> (crude (nq, n) | None, vals (nq, topk), idx (nq, topk))."""
    fn = bs.crude_topk_cuda if _on_card(codes) else bs.crude_topk_torch
    return fn(codes, lut_flat, topk, lut_scale, lut_offset,
              want_crude=want_crude, code_bits=code_bits)


def batched_refine_topk(codes, lut_flat, crude, thresholds, topk: int, *,
                        code_bits: int = 8):
    """Phase 2: eq. 2 margin test, slow-codebook sum of survivors and
    their top-k.  codes (n, Kc), lut_flat (nq, K*m) f32 slow-masked,
    crude (nq, n), thresholds (nq,) -> (dist (nq, topk), idx (nq, topk))."""
    fn = bs.refine_topk_cuda if _on_card(codes) else bs.refine_topk_torch
    return fn(codes, lut_flat, crude, thresholds, topk, code_bits=code_bits)


def ivf_crude_topk(cand_codes, cand_ids, lut_flat, topk: int, *,
                   lut_scale=None, lut_offset=None, code_bits: int = 8):
    """IVF phase 1 over each query's candidate slab.  cand_codes
    (nq, nc, Kc) stored rows, cand_ids (nq, nc) int32 (-1 = invalid),
    lut_flat (nq, K*m) fast-masked f32, or int8 with
    ``lut_scale``/``lut_offset`` -> (crude (nq, nc) with invalid columns
    +inf, vals (nq, topk), pos (nq, topk) slab positions)."""
    fn = (bs.ivf_crude_topk_cuda if _on_card(cand_codes)
          else bs.ivf_crude_topk_torch)
    return fn(cand_codes, cand_ids, lut_flat, topk, lut_scale, lut_offset,
              code_bits=code_bits)


def ivf_fastscan_crude_topk(packed_cand_codes, cand_ids, lut_flat,
                            topk: int, *, lut_scale=None, lut_offset=None):
    """``ivf_crude_topk`` over a nibble-packed slab (nq, nc, ceil(K/2))
    against an even-K lut_flat (``index.base.fastscan_kernel_operands``
    or ``pad_luts_even``)."""
    return ivf_crude_topk(packed_cand_codes, cand_ids, lut_flat, topk,
                          lut_scale=lut_scale, lut_offset=lut_offset,
                          code_bits=4)


def ivf_refine_topk(cand_codes, lut_flat, crude, thresholds, topk: int, *,
                    code_bits: int = 8):
    """IVF phase 2 over the slab: margin test, slow sum of survivors,
    top-k of slab positions.  -> (dist (nq, topk), pos (nq, topk))."""
    fn = (bs.ivf_refine_topk_cuda if _on_card(cand_codes)
          else bs.ivf_refine_topk_torch)
    return fn(cand_codes, lut_flat, crude, thresholds, topk,
              code_bits=code_bits)


def kmeans_assign(x, cent):
    """Nearest centroid of every point: x (n, d) f32, cent (L, d) f32 ->
    (ids (n,) int32, first index of the minimum; dist (n,) f32 squared
    distance)."""
    fn = km.kmeans_assign_cuda if _on_card(x) else km.kmeans_assign_torch
    return fn(x, cent)
