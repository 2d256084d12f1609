"""Flash attention (twin of ``repro.kernels.flash_attention`` with the
GQA head folding of ``repro.kernels.ops.flash_attention``) and its
backward: the CUDA kernels of ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward) beside their plain PyTorch
versions.

Both take q (b, sq, H, dqk), k (b, sk, KVH, dqk) and v (b, sk, KVH, dv)
of one type, f32 or bf16, with H a multiple of KVH (MHA, GQA, MQA: query
head h attends with key/value head h // (H / KVH)), and return (b, sq,
H, dv) in v's type.  The value width may differ from the query/key
width, as in DeepSeek-V2's MLA prefill (192 = 128 nope + 64 rope, v
128), which the reference's ``full_attention`` serves with one einsum.
Scores are ``(q . k^T in f32) * dqk ** -0.5``; query row i sits at
position ``q_pos = i + q_offset`` and key j at ``k_pos = j`` (the
reference's ``q_offset``; 0: top-left aligned, also when sq != sk; sk -
sq: the triangular scan's prefix keys).  Under ``causal`` the mask is
the reference's finite ``NEG_INF`` where ``q_pos < k_pos``, and with
``window`` > 0 also where ``q_pos - k_pos >= window`` (the reference's
sliding band, ``models/attention.py``: recurrentgemma's local layers),
and with ``kv_valid`` > 0 where ``k_pos >= kv_valid`` (the key-padding
bound of the reference's padded cross attention,
``chunked_attention(kv_valid=)``; only in a non-causal call with no
window and no mask, so that every row keeps keys [0, kv_valid)), and
where the boolean ``mask`` (any shape that broadcasts to (b, H, sq, sk):
batch, query head, query row, key; the reference's ``full_attention(
mask=)``) is False.  The softmax weights are cast to v's type before
the P . V product (f32 sums), and the output is ``o / max(l, 1e-30)``.
A row that sees no key (possible under ``mask``, a negative offset with
``causal``, or a window past the last key) takes the reference's
softmax of all-``NEG_INF`` scores, uniform: the mean of V over all sk
keys, log-sum-exp ``NEG_INF``.  The kernel keeps a running max and sum
over key tiles and skips tiles above the diagonal, left of the band and
past ``kv_valid`` (the padded rows are read in place, never copied; the
mask skips no tile: it is read per element, as a uint8 operand with four
element strides, 0 over a broadcast dimension); the plain version takes
each head's full softmax at once.  They agree to rounding: 2e-5 in f32
and 2e-2 in bf16, the reference's own tolerances.

The kernel compiles the (dqk, dv) pairs of ``HEAD_DIMS``, each in both
bodies; another pair raises a ``ValueError``.  The type picks the body
(``PATHS``), both on ``mma.sync`` tensor cores: bf16 m16n8k16 with f32
sums; f32 m16n8k8 TF32 with the 3xTF32 split of every operand of both
products (hi = x rounded to TF32, lo = x - hi rounded to TF32, a . b as
lo_a hi_b + hi_a lo_b + hi_a hi_b in f32), each key tile's P . V summed
from zero and added to the running output in f32; neither falls back to
the other.

Training: with ``with_lse`` the forward also returns each row's
log-sum-exp ``m + log(l)`` (b, H, sq) f32 (the reference kernel's ``m``
and ``l`` outputs), its output bit for bit the same.  The backward
(``flash_attention_bwd_cuda``: two kernels, dQ with D = rowsum(dO * O),
then dK and dV over the G query heads of each KV head, no atomics, so
two launches are equal bit for bit) recomputes P = exp(s * scale - LSE)
tile by tile under the forward's masks (0 exactly where masked) and
returns (dq, dk, dv) in the operands' types; dV takes P cast to v's type
as the forward's P . V does.  A row that saw no key (its log-sum-exp
below ``NEG_INF / 2``) adds nothing to dq and dk and dO / sk (1 / sk cast
to v's type) to every key's dv, as the reference's uniform softmax
does.  It takes every call the forward takes (both types, every
``HEAD_DIMS`` pair, causal or not, ``window``, ``kv_valid``,
``q_offset``, ``mask``, GQA / MQA), on ``mma.sync`` tensor cores with
the forward's arithmetic in each type (``PATHS``); bf16 also rounds dS
to bf16 before it multiplies K (dq) or Q (dk), so that each product
takes bf16 operands, and f32's 3xTF32 products are ~2^-21 of a
product, within the 2e-5 gate, which one-pass TF32 is not.  Both hold
2e-5 (f32) / 2e-2 (bf16) of each gradient's largest magnitude against
``flash_attention_bwd_torch``, its plain version (tests and
``chip_smoke.py``; nothing on the card calls it).  The reference trains
through its jnp ``chunked_attention``, whose ``jax.checkpoint``'ed
chunks make XLA recompute the probabilities in the backward: the same
gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.index.base import full_f32_matmul
from repro_torch.kernels import build

NEG_INF = -1e30
MAX_OFFSET = 1 << 30      # the kernels' bound on |q_offset|
# the kernel's compiled (dqk, dv) pairs: the square widths, and MLA's
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = {torch.float32: "mma.sync 3xTF32 f32",
         torch.bfloat16: "mma.sync bf16"}


def _compiled(dqk: int, dv: int):
    if (dqk, dv) not in HEAD_DIMS:
        square = tuple(a for a, b in HEAD_DIMS if a == b)
        other = [p for p in HEAD_DIMS if p[0] != p[1]]
        raise ValueError(
            f"head dims (dqk={dqk}, dv={dv}) are not compiled; the kernel "
            f"takes dh in {square} with dv = dqk, or (dqk, dv) in {other}")


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: int = 0, kv_valid: int = 0,
            q_offset: int = 0, mask=None):
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError(f"q, k and v must be 4-d (b, s, heads, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, H, dqk = q.shape
    _, sk, KVH, _ = k.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (b, sk, KVH, dqk) \
            or tuple(v.shape[:3]) != (b, sk, KVH) or H % KVH != 0:
        raise ValueError(f"k must be (b={b}, sk, KVH, dqk={dqk}) and v (b, "
                         f"sk, KVH, dv) with H={H} a multiple of KVH, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not 0 <= kv_valid <= sk or (kv_valid and (causal or window
                                                 or mask is not None)):
        raise ValueError(f"kv_valid must be in [0, sk={sk}] and is taken only "
                         f"by a non-causal call with no window and no mask; "
                         f"got kv_valid={kv_valid}, causal={causal}, "
                         f"window={window}")
    if abs(q_offset) > MAX_OFFSET:
        raise ValueError(f"|q_offset| must be at most {MAX_OFFSET}, got "
                         f"{q_offset}")
    if mask is not None:
        _mask_view(mask, b, H, sq, sk, q.device)
    return b, sq, sk, H, KVH, dqk, dv


def _mask_view(mask: torch.Tensor, b: int, H: int, sq: int, sk: int,
               device) -> torch.Tensor:
    """``mask`` (bool, broadcastable to (b, H, sq, sk)) as a (b, H, sq, sk)
    view of it (stride 0 over a broadcast dimension), on q's device."""
    if mask.dtype != torch.bool or mask.device != torch.device(device):
        raise ValueError(f"mask must be a bool tensor on q's device "
                         f"({device}), got {mask.dtype} on {mask.device}")
    try:
        return mask.expand(b, H, sq, sk)
    except RuntimeError:
        raise ValueError(f"mask {tuple(mask.shape)} does not broadcast to "
                         f"(b, H, sq, sk) = {(b, H, sq, sk)}") from None


def _visible(sq: int, sk: int, causal: bool, window: int, kv_valid: int,
             device, q_offset: int = 0):
    """(sq, sk) bool: the (query, key) pairs the static masks keep."""
    gap = (torch.arange(sq, device=device)[:, None] + q_offset
           - torch.arange(sk, device=device)[None, :])   # q_pos - k_pos
    visible = torch.ones_like(gap, dtype=torch.bool)
    if causal:
        visible &= gap >= 0
    if window:
        visible &= gap < window
    if kv_valid:
        visible &= torch.arange(sk, device=device)[None, :] < kv_valid
    return visible


def general_instance(sq: int, sk: int, window: int = 0, q_offset: int = 0,
                     mask=None) -> bool:
    """Whether a call runs the kernels' general instance (a query offset,
    a mask, or a window past the last key: every call that can leave a
    row with no key), which reads the offset and the mask and holds the
    no-key rule; every other call runs the instance compiled with no
    offset and neither.  Asked of the built library, whose launches make
    the same choice (``csrc/flash_mma.cuh``, ``general_instance``)."""
    lib = build.library("flash_attention")
    return bool(lib.icq_flash_general_instance(
        int(mask is not None), int(window), int(q_offset), sq, sk))


def _kept(visible, mask, bi: int, h: int):
    """The (sq, sk) pairs of batch ``bi``, head ``h`` that every mask
    keeps: the static ``visible`` and the (b, H, sq, sk) ``mask`` view."""
    return visible if mask is None else visible & mask[bi, h]


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, kv_valid: int = 0,
                          q_offset: int = 0, mask=None,
                          with_lse: bool = False):
    """Plain version (the reference's oracle ``flash_attention_ref``,
    with the reference's band mask under ``window``, key-padding mask
    under ``kv_valid``, positions shifted by ``q_offset`` and ``mask``
    ANDed in), one (b, head) at a time so that only one (sq, sk) score
    matrix is alive: the full f32 softmax, p cast to v's type before P .
    V, the row sum applied after the product, as the kernel does (a row
    that sees no key: every score NEG_INF, the uniform softmax).
    ``with_lse``: also each row's log-sum-exp (b, H, sq) f32."""
    b, sq, sk, H, KVH, dqk, dv = _shapes(q, k, v, causal, window, kv_valid,
                                         q_offset, mask)
    g = H // KVH
    scale = dqk ** -0.5
    out = torch.empty((b, sq, H, dv), dtype=v.dtype, device=q.device)
    lse = torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
    visible = _visible(sq, sk, causal, window, kv_valid, q.device, q_offset)
    if mask is not None:
        mask = _mask_view(mask, b, H, sq, sk, q.device)
    masked = causal or bool(window) or bool(kv_valid) or mask is not None
    with full_f32_matmul():
        for bi in range(b):
            for h in range(H):
                s = (q[bi, :, h].float() @ k[bi, :, h // g].float().T) \
                    * scale
                if masked:
                    s = torch.where(_kept(visible, mask, bi, h), s,
                                    torch.full_like(s, NEG_INF))
                m = s.max(dim=1, keepdim=True).values
                p = torch.exp(s - m)
                l = p.sum(dim=1, keepdim=True)
                o = p.to(v.dtype).float() @ v[bi, :, h // g].float()
                out[bi, :, h] = (o / torch.clamp(l, min=1e-30)).to(v.dtype)
                lse[bi, h] = (m + torch.log(l))[:, 0]
    return (out, lse) if with_lse else out


# the flash call on the meta device as two custom ops, forward and
# backward, with shapes-only implementations: a dispatch mode (the dry
# run's cost count, ``launch.hlo_cost``) sees each call as one op and its
# arguments, trailing (q, k, v, causal, window, kv_valid, q_offset, mask)
# in both
@torch.library.custom_op("repro_torch::flash_attention_meta",
                         mutates_args=())
def _meta_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, kv_valid: int, q_offset: int,
              mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError("the meta flash call takes meta tensors")


@_meta_fwd.register_fake
def _(q, k, v, causal, window, kv_valid, q_offset, mask):
    b, sq, H, _ = q.shape
    return (v.new_empty((b, sq, H, v.shape[-1])),
            q.new_empty((b, H, sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_meta_bwd",
                         mutates_args=())
def _meta_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, causal: bool, window: int, kv_valid: int,
              q_offset: int, mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise NotImplementedError("the meta flash call takes meta tensors")


@_meta_bwd.register_fake
def _(dout, q, k, v, causal, window, kv_valid, q_offset, mask):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _meta_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3])
    ctx.flags = inputs[3:]


def _meta_grad(ctx, dout, dlse):
    return _meta_bwd(dout, *ctx.saved_tensors, *ctx.flags) + (None,) * 5


_meta_fwd.register_autograd(_meta_grad, setup_context=_meta_setup)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_valid: int = 0, q_offset: int = 0, mask=None,
                         with_lse: bool = False):
    """The flash call on the meta device (the dry run traces shapes):
    the operands checked as the kernel's wrappers check them, and empty
    outputs of the kernel's shapes (differentiable: the gradients are
    empty too), through the custom ops ``repro_torch::
    flash_attention_meta`` and ``_bwd``, so that a cost count takes the
    call as one attention op forward and one backward and not as the
    plain version's per-head products."""
    _shapes(q, k, v, causal, window, kv_valid, q_offset, mask)
    out, lse = _meta_fwd(q, k, v, causal, window, kv_valid, q_offset, mask)
    return (out, lse) if with_lse else out


def flash_attention_meta_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0, kv_valid: int = 0,
                             q_offset: int = 0, mask=None):
    """The backward on the meta device: the custom op
    ``repro_torch::flash_attention_meta_bwd``'s empty (dq, dk, dv), one
    op of the cost count (``o`` and ``lse`` are not read)."""
    _shapes(q, k, v, causal, window, kv_valid, q_offset, mask)
    return _meta_bwd(do, q, k, v, causal, window, kv_valid, q_offset, mask)


def flash_attention_bwd_torch(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, kv_valid: int = 0,
                              q_offset: int = 0, mask=None):
    """Plain version of the backward: per (b, head), P = exp(s * scale -
    LSE) under the masks (0 where masked), D = rowsum(dO * O), dV += (P
    cast to v's type)^T dO, dS = P (dO V^T - D), dQ = scale dS K, dK +=
    scale dS^T Q, all in f32; a row whose LSE is below ``NEG_INF / 2``
    (it saw no key: the forward's uniform softmax) takes P = 1 / sk on
    every key in dV and 0 in dS.  Returns (dq, dk, dv) in the operands'
    types.  ``lse`` (b, H, sq) f32 is the forward's (``with_lse``)."""
    b, sq, sk, H, KVH, dqk, dv = _shapes(q, k, v, causal, window, kv_valid,
                                         q_offset, mask)
    g = H // KVH
    scale = dqk ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, H, dqk), **f32)
    dk = torch.zeros((b, sk, KVH, dqk), **f32)
    dvv = torch.zeros((b, sk, KVH, dv), **f32)
    visible = _visible(sq, sk, causal, window, kv_valid, q.device, q_offset)
    if mask is not None:
        mask = _mask_view(mask, b, H, sq, sk, q.device)
    with full_f32_matmul():
        for bi in range(b):
            for h in range(H):
                qf, kf = q[bi, :, h].float(), k[bi, :, h // g].float()
                vf, dof = v[bi, :, h // g].float(), do[bi, :, h].float()
                s = (qf @ kf.T) * scale
                p = torch.where(_kept(visible, mask, bi, h),
                                torch.exp(s - lse[bi, h][:, None]),
                                torch.zeros_like(s))
                d = (dof * o[bi, :, h].float()).sum(dim=1, keepdim=True)
                empty = (lse[bi, h] < NEG_INF / 2)[:, None]
                pv = torch.where(empty, torch.full_like(p, 1.0 / sk), p)
                dvv[bi, :, h // g] += pv.to(v.dtype).float().T @ dof
                ds = p * (dof @ vf.T - d)
                dq[bi, :, h] = (ds @ kf) * scale
                dk[bi, :, h // g] += (ds.T @ qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def _check_operands(dtype, device, **tensors):
    """Each tensor a contiguous, 16-byte aligned CUDA tensor of ``dtype``
    on ``device``; the operands' type f32 or bf16."""
    for name, t in tensors.items():
        if not (t.is_cuda and t.device == device and t.dtype == dtype
                and (dtype in DTYPES) and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"CUDA tensor on q's device of type {dtype} (q, "
                             "k, v and their gradients float32 or bfloat16, "
                             f"all of v's type), got {t.dtype} on {t.device}")


def _check_sizes(b, sq, sk, H, dqk, dv):
    _compiled(dqk, dv)
    if max(b, H) > 65535 or min(b, sq, sk) < 1:
        raise ValueError(f"b={b}, H={H} must be at most 65535 and b, sq={sq},"
                         f" sk={sk} at least 1")


def _mask_operand(mask, b, H, sq, sk, device) -> tuple:
    """The kernels' mask arguments: (pointer, four element strides) of
    ``mask``'s (b, H, sq, sk) view, or (None, 0, 0, 0, 0)."""
    if mask is None:
        return (ctypes.c_void_p(None), 0, 0, 0, 0)
    m = _mask_view(mask, b, H, sq, sk, device)
    return (ctypes.c_void_p(m.data_ptr()), *m.stride())


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: int = 0, kv_valid: int = 0,
                         q_offset: int = 0, mask=None,
                         with_lse: bool = False):
    """Launch the flash attention kernel; same operands and output as
    ``flash_attention_torch`` (with ``with_lse``, (out, lse): the kernel
    also writes each row's log-sum-exp, the output unchanged).  A call
    with an offset, a mask or rows with no key runs the body's general
    instance (``general_instance``)."""
    b, sq, sk, H, KVH, dqk, dv = _shapes(q, k, v, causal, window, kv_valid,
                                         q_offset, mask)
    _check_operands(v.dtype, q.device, q=q, k=k, v=v)
    _check_sizes(b, sq, sk, H, dqk, dv)
    out = torch.empty((b, sq, H, dv), dtype=v.dtype, device=q.device)
    lse = (torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):     # the launch's device is q's
        err = lib.icq_flash_attention(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lse.data_ptr() if with_lse else None),
            DTYPES[v.dtype], b, sq, sk, H, KVH, dqk, dv, dqk ** -0.5,
            int(causal), int(window), int(kv_valid), int(q_offset),
            *_mask_operand(mask, b, H, sq, sk, q.device),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")
    build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


BWD_KERNELS = ("dq", "dkdv")


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0, kv_valid: int = 0,
                             q_offset: int = 0, mask=None):
    """Launch the backward kernels (dQ and D, then dK and dV); same
    operands and outputs as ``flash_attention_bwd_torch``.  o and do
    (b, sq, H, dv) of v's type and lse (b, H, sq) f32 must be
    contiguous and 16-byte aligned on q's card; anything else raises."""
    masks = dict(causal=causal, window=window, kv_valid=kv_valid,
                 q_offset=q_offset, mask=mask)
    b, sq, _, H, _, _, _ = _shapes(q, k, v, **masks)
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    dbuf = torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
    for kernel in BWD_KERNELS:
        flash_attention_bwd_kernel(kernel, q, k, v, o, do, lse, *grads, dbuf,
                                   **masks)
    return grads


def flash_attention_bwd_kernel(kernel: str, q, k, v, o, do, lse, dq, dk, dv,
                               dbuf, *, causal: bool = True, window: int = 0,
                               kv_valid: int = 0, q_offset: int = 0,
                               mask=None):
    """One backward kernel on the current stream: ``"dq"`` writes dq and
    D = rowsum(dO * O) (b, H, sq) f32 into dbuf; ``"dkdv"`` reads dbuf
    and writes dk and dv (so it runs after ``"dq"``).  Outputs are
    allocated by the caller (``torch.empty``: every element is
    written)."""
    b, sq, sk, H, KVH, dqk, dvw = _shapes(q, k, v, causal, window, kv_valid,
                                          q_offset, mask)
    _check_operands(v.dtype, q.device, q=q, k=k, v=v, o=o, do=do, dq=dq,
                    dk=dk, dv=dv)
    _check_operands(torch.float32, q.device, lse=lse, dbuf=dbuf)
    want = {"o": (b, sq, H, dvw), "do": (b, sq, H, dvw), "lse": (b, H, sq),
            "dbuf": (b, H, sq), "dq": tuple(q.shape), "dk": tuple(k.shape),
            "dv": tuple(v.shape)}
    got = {"o": o, "do": do, "lse": lse, "dbuf": dbuf, "dq": dq, "dk": dk,
           "dv": dv}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(got[name].shape)}")
    _check_sizes(b, sq, sk, H, dqk, dvw)
    which = BWD_KERNELS.index(kernel)
    lib = build.library("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):     # the launch's device is q's
        err = lib.icq_flash_attention_bwd(
            which, *(ctypes.c_void_p(t.data_ptr())
                     for t in (q, k, v, o, do, lse, dq, dk, dv, dbuf)),
            DTYPES[v.dtype], b, sq, sk, H, KVH, dqk, dvw, dqk ** -0.5,
            int(causal), int(window), int(kv_valid), int(q_offset),
            *_mask_operand(mask, b, H, sq, sk, q.device),
            ctypes.c_void_p(stream))
    name = f"flash_attention_bwd_{kernel}"
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")
    build.LAUNCHES[name] += 1


def kernel_attributes(dtype: torch.dtype, dqk: int, dv=None,
                      kernel: str = "forward", general: bool = False) -> dict:
    """The body that runs for ``dtype`` at (``dqk``, ``dv``; ``dv``
    defaults to ``dqk``), the forward or a backward kernel (``"dq"``,
    ``"dkdv"``), under ``general`` the general instance
    (``general_instance``: a call with an offset, a mask or rows with no
    key): its path, registers per thread and local-memory bytes per
    thread (spills and local arrays), as ``cudaFuncGetAttributes``
    reports them."""
    dv = dqk if dv is None else dv
    if dtype not in DTYPES:
        raise ValueError(f"no kernel for {dtype}")
    _compiled(dqk, dv)
    regs, local = ctypes.c_int(), ctypes.c_int()
    if kernel == "forward":
        path = PATHS[dtype]
        lib = build.library("flash_attention")
        err = lib.icq_flash_attention_attributes(
            DTYPES[dtype], dqk, dv, int(general), ctypes.byref(regs),
            ctypes.byref(local))
    else:
        path = f"backward {kernel}, {PATHS[dtype]}"
        lib = build.library("flash_attention_bwd")
        err = lib.icq_flash_attention_bwd_attributes(
            DTYPES[dtype], BWD_KERNELS.index(kernel), dqk, dv, int(general),
            ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError("flash_attention attributes failed: "
                           f"{lib.icq_error_string(err).decode()}")
    if general:
        path += ", general instance"
    return dict(path=path, registers=regs.value, local_bytes=local.value)
