"""Public entry points of the search kernels (twin of
``repro.kernels.ops`` for the flat path).  Each one launches the CUDA
kernel for tensors on the card and runs the kernel's plain PyTorch
version for tensors on the CPU; nothing falls back from one to the
other.  ``LAUNCHES`` counts the kernel launches of each wrapper."""
from __future__ import annotations

from repro_torch.kernels import batched_search as bs
from repro_torch.kernels.batched_search import LAUNCHES  # noqa: F401


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the search kernels run on cuda or cpu tensors, got "
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
