"""Public entry points of the port's kernels (twin of
``repro.kernels.ops``).  Each one launches the CUDA kernel for tensors
on the card and runs the kernel's plain PyTorch version for tensors on
the CPU; nothing falls back from one to the other.  ``LAUNCHES`` counts
the kernel launches of each wrapper.

Every entry point first calls the fault hook with its stage name
(``"kernels.<op>"``), the resilience layer's injection point: a seeded
``resilience.faults.FaultInjector`` installed there fails chosen stages
deterministically, so tests and ``chip_smoke.py`` can drive the
engine's retries.  No hook (the default) costs one ``is None`` test."""
from __future__ import annotations

import torch

from repro_torch.core.encode import pack_nibbles, unpack_nibbles  # noqa: F401
from repro_torch.kernels import adc as adc_mod
from repro_torch.kernels import batched_search as bs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import icm_encode as icm
from repro_torch.kernels import kmeans as km
from repro_torch.kernels import two_step as ts
from repro_torch.kernels.build import LAUNCHES  # noqa: F401


_FAULT_HOOK = None


def set_fault_hook(hook):
    """Install ``hook(stage: str)`` (or None to clear).  Returns the
    previous hook so callers can restore it."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    return prev


def _check_faults(stage: str) -> None:
    if _FAULT_HOOK is not None:
        _FAULT_HOOK("kernels." + stage)


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the kernels run on cuda or cpu tensors, got "
                     f"{t.device}")


def adc(codes, lut):
    """ADC LUT sum over one LUT: codes (n, K) uint8 or int32 in [0, m),
    lut (K, m) f32 -> dists (n,) f32."""
    _check_faults("adc")
    fn = adc_mod.adc_cuda if _on_card(codes) else adc_mod.adc_torch
    return fn(codes, lut)


def two_step(codes, lut, fast_mask, threshold):
    """Fused phase 1 over one LUT: the crude ADC over the fast-masked
    LUT and the eq. 2 mask.  codes (n, K), lut (K, m) f32, fast_mask (K,)
    bool, threshold a scalar -> (crude (n,) f32, passed (n,) int32)."""
    _check_faults("two_step")
    fn = ts.two_step_cuda if _on_card(codes) else ts.two_step_torch
    return fn(codes, lut, fast_mask, threshold)


def batched_crude_topk(codes, lut_flat, topk: int, *,
                       want_crude: bool = True, lut_scale=None,
                       lut_offset=None, code_bits: int = 8, out=None,
                       pred=None):
    """Phase 1: crude LUT sums of every (query, point) pair and their
    top-k.  codes (n, Kc) stored rows (nibble rows under
    ``code_bits=4``, against an even-K lut_flat), lut_flat (nq, K*m)
    fast-masked f32, or int8 with ``lut_scale``/``lut_offset`` (nq,)
    -> (crude (nq, n) | None, vals (nq, topk), idx (nq, topk)).
    ``out`` (nq, n) f32, optional, receives the crude matrix; ``pred``
    (n,) bool, optional (a filter), makes the rows it excludes +inf."""
    _check_faults("batched_crude_topk")
    return _crude_topk(codes, lut_flat, topk, want_crude=want_crude,
                       lut_scale=lut_scale, lut_offset=lut_offset,
                       code_bits=code_bits, out=out, pred=pred)


def _crude_topk(codes, lut_flat, topk, *, want_crude, lut_scale,
                lut_offset, code_bits, out=None, pred=None):
    fn = bs.crude_topk_cuda if _on_card(codes) else bs.crude_topk_torch
    return fn(codes, lut_flat, topk, lut_scale, lut_offset,
              want_crude=want_crude, code_bits=code_bits, out=out,
              pred=pred)


def batched_refine_topk(codes, lut_flat, crude, thresholds, topk: int, *,
                        code_bits: int = 8):
    """Phase 2: eq. 2 margin test, slow-codebook sum of survivors and
    their top-k.  codes (n, Kc), lut_flat (nq, K*m) f32 slow-masked,
    crude (nq, n), thresholds (nq,) -> (dist (nq, topk), idx (nq, topk))."""
    _check_faults("batched_refine_topk")
    fn = bs.refine_topk_cuda if _on_card(codes) else bs.refine_topk_torch
    return fn(codes, lut_flat, crude, thresholds, topk, code_bits=code_bits)


def fastscan_crude_topk(packed_codes, lut_flat, topk: int, *,
                        want_crude: bool = True, lut_scale=None,
                        lut_offset=None):
    """The 4-bit fast-scan crude pass: ``batched_crude_topk`` over
    nibble-packed codes (n, ceil(K/2)) uint8 against an even-K lut_flat
    (``index.base.fastscan_kernel_operands`` or ``pad_luts_even``)."""
    _check_faults("fastscan_crude_topk")
    return _crude_topk(packed_codes, lut_flat, topk, want_crude=want_crude,
                       lut_scale=lut_scale, lut_offset=lut_offset,
                       code_bits=4)


def ivf_crude_topk(cand_codes, cand_ids, lut_flat, topk: int, *,
                   lut_scale=None, lut_offset=None, code_bits: int = 8,
                   out=None):
    """IVF phase 1 over each query's candidate slab.  cand_codes
    (nq, nc, Kc) stored rows, cand_ids (nq, nc) int32 (-1 = invalid),
    lut_flat (nq, K*m) fast-masked f32, or int8 with
    ``lut_scale``/``lut_offset`` -> (crude (nq, nc) with invalid columns
    +inf, vals (nq, topk), pos (nq, topk) slab positions).  ``out``
    (nq, nc) f32, optional, receives the crude matrix."""
    _check_faults("ivf_crude_topk")
    return _ivf_crude_topk(cand_codes, cand_ids, lut_flat, topk,
                           lut_scale=lut_scale, lut_offset=lut_offset,
                           code_bits=code_bits, out=out)


def _ivf_crude_topk(cand_codes, cand_ids, lut_flat, topk, *, lut_scale,
                    lut_offset, code_bits, out=None):
    fn = (bs.ivf_crude_topk_cuda if _on_card(cand_codes)
          else bs.ivf_crude_topk_torch)
    return fn(cand_codes, cand_ids, lut_flat, topk, lut_scale, lut_offset,
              code_bits=code_bits, out=out)


def ivf_fastscan_crude_topk(packed_cand_codes, cand_ids, lut_flat,
                            topk: int, *, lut_scale=None, lut_offset=None):
    """``ivf_crude_topk`` over a nibble-packed slab (nq, nc, ceil(K/2))
    against an even-K lut_flat (``index.base.fastscan_kernel_operands``
    or ``pad_luts_even``)."""
    _check_faults("ivf_fastscan_crude_topk")
    return _ivf_crude_topk(packed_cand_codes, cand_ids, lut_flat, topk,
                           lut_scale=lut_scale, lut_offset=lut_offset,
                           code_bits=4)


def ivf_refine_topk(cand_codes, lut_flat, crude, thresholds, topk: int, *,
                    code_bits: int = 8):
    """IVF phase 2 over the slab: margin test, slow sum of survivors,
    top-k of slab positions.  -> (dist (nq, topk), pos (nq, topk))."""
    _check_faults("ivf_refine_topk")
    fn = (bs.ivf_refine_topk_cuda if _on_card(cand_codes)
          else bs.ivf_refine_topk_torch)
    return fn(cand_codes, lut_flat, crude, thresholds, topk,
              code_bits=code_bits)


def select_topk(crude, thresholds, cap: int):
    """The ``refine_cap`` survivor selection over a flat or slab crude
    matrix: crude (nq, n), thresholds (nq,) -> (vals (nq, cap), idx
    (nq, cap)), the cap best-crude rows with ``crude < thr``, +inf
    after them."""
    _check_faults("select_topk")
    fn = bs.select_topk_cuda if _on_card(crude) else bs.select_topk_torch
    return fn(crude, thresholds, cap)


def rerank_topk(cand_codes, lut_flat, valid, topk: int, *,
                code_bits: int = 8):
    """The survivors' re-rank by one full-table f32 sum: cand_codes
    (nq, c, Kc) gathered stored rows, lut_flat (nq, K*m) f32 full
    tables, valid (nq, c) bool -> (dist (nq, topk), pos (nq, topk)
    survivor positions)."""
    _check_faults("rerank_topk")
    fn = bs.rerank_topk_cuda if _on_card(cand_codes) \
        else bs.rerank_topk_torch
    return fn(cand_codes, lut_flat, valid, topk, code_bits=code_bits)


def kmeans_assign(x, cent):
    """Nearest centroid of every point: x (n, d), cent (L, d), f32 or
    bf16 (widened to f32, exactly) -> (ids (n,) int32, first index of
    the minimum; dist (n,) f32 squared distance)."""
    _check_faults("kmeans_assign")
    fn = km.kmeans_assign_cuda if _on_card(x) else km.kmeans_assign_torch
    return fn(x, cent)


def icm_encode(x, init_codes, C, *, iters: int):
    """ICM sweeps from a warm start: x (n, d) f32, init_codes (n, K)
    int32, C (K, m, d) f32 -> codes (n, K) int32 (each step's argmin
    takes the first index of the minimum)."""
    _check_faults("icm_encode")
    fn = icm.icm_encode_cuda if _on_card(x) else icm.icm_encode_torch
    return fn(x, init_codes, C, iters=iters)


class _FlashAttention(torch.autograd.Function):
    """The card's differentiable flash attention: the forward kernel
    writing each row's log-sum-exp, the backward kernels recomputing P
    from it (``flash_attention.flash_attention_bwd_cuda``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_valid, q_offset, mask):
        masks = dict(causal=causal, window=window, kv_valid=kv_valid,
                     q_offset=q_offset, mask=mask)
        out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **masks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = masks
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd_cuda(
            q, k, v, out, dout.contiguous(), lse, **ctx.masks)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_valid: int = 0, q_offset: int = 0, mask=None,
                    with_lse: bool = False):
    """Flash attention with GQA and MQA: q (b, sq, H, dqk), k (b, sk,
    KVH, dqk), v (b, sk, KVH, dv), f32 or bf16, H a multiple of KVH ->
    (b, sq, H, dv) in v's type, scaled by dqk ** -0.5 (on the card
    (dqk, dv) one of ``flash_attention.HEAD_DIMS``).  Query row i sits
    at q_pos = i + ``q_offset``, key j at k_pos = j; ``causal`` masks
    q_pos < k_pos; ``window`` > 0 also masks q_pos - k_pos >= window;
    ``kv_valid`` > 0 masks keys at k_pos >= kv_valid (a non-causal call
    with no window and no mask only); ``mask`` (bool, broadcastable to
    (b, H, sq, sk)) masks where it is False.  A row that keeps no key
    gets the mean of v over all keys (the reference's softmax of all
    ``NEG_INF`` scores).  ``with_lse``: (out, lse), lse each row's
    log-sum-exp (b, H, sq) f32 (what a merge of calls over key blocks
    reads).

    Differentiable on both devices.  On the card, when autograd records
    (``torch.is_grad_enabled()`` and q, k or v requires grad), the
    forward kernel also writes the rows' log-sum-exp and the backward
    runs the backward kernels; otherwise the forward kernel alone runs,
    exactly as for inference.  The backward takes no gradient of
    ``lse`` (the reference's attention has no such output; MLA's
    block-wise path differentiates its merge itself,
    ``models.mla._MLABlockwise``), so ``with_lse`` under autograd on the
    card raises.  On the CPU autograd differentiates the plain version.
    On the meta device (the dry run's shapes) nothing is computed: the
    outputs are empty meta tensors
    (``flash_attention.flash_attention_meta``)."""
    _check_faults("flash_attention")
    masks = dict(causal=causal, window=window, kv_valid=kv_valid,
                 q_offset=q_offset, mask=mask)
    if q.device.type == "meta":
        return fa.flash_attention_meta(q, k, v, with_lse=with_lse, **masks)
    if not _on_card(q):
        return fa.flash_attention_torch(q, k, v, with_lse=with_lse, **masks)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if with_lse:
            raise NotImplementedError(
                "flash_attention(with_lse=True) under autograd on the "
                "card: the backward kernels take no gradient of the "
                "log-sum-exp, which the reference's attention does not "
                "return; a caller that merges calls by their log-sum-exp "
                "differentiates the merge itself (models.mla."
                "_MLABlockwise)")
        return _FlashAttention.apply(q, k, v, causal, window, kv_valid,
                                     q_offset, mask)
    return fa.flash_attention_cuda(q, k, v, with_lse=with_lse, **masks)


def flash_attention_bwd(q, k, v, o, do, lse, **masks):
    """The flash backward where the operands lie, for a caller that
    differentiates a merge of flash calls itself (``models.mla.
    _MLABlockwise``): (dq, dk, dv) from the forward's output ``o``, the
    output gradient ``do`` and the rows' log-sum-exp ``lse`` (the
    merged ones, for a call over one key block of a merge).  The two
    backward kernels on the card, the plain version on the CPU, the meta
    op on the meta device (the dry run); ``masks`` as
    ``flash_attention``'s."""
    _check_faults("flash_attention_bwd")
    if q.device.type == "meta":
        return fa.flash_attention_meta_bwd(q, k, v, o, do, lse, **masks)
    fn = (fa.flash_attention_bwd_cuda if _on_card(q)
          else fa.flash_attention_bwd_torch)
    return fn(q, k, v, o, do, lse, **masks)
