"""Forward flash attention (twin of ``repro.kernels.flash_attention``
with the GQA head folding of ``repro.kernels.ops.flash_attention``): the
CUDA kernel of ``csrc/flash_attention.cu`` beside its plain PyTorch
version.

Both take q (b, sq, H, dqk), k (b, sk, KVH, dqk) and v (b, sk, KVH, dv)
of one type, f32 or bf16, with H a multiple of KVH (MHA, GQA, MQA: query
head h attends with key/value head h // (H / KVH)), and return (b, sq,
H, dv) in v's type.  The value width may differ from the query/key
width, as in DeepSeek-V2's MLA prefill (192 = 128 nope + 64 rope, v
128), which the reference's ``full_attention`` serves with one einsum.
Scores are ``(q . k^T in f32) * dqk ** -0.5``; under ``causal`` the mask
is the reference's finite ``NEG_INF`` where ``q_pos < k_pos``, top-left
aligned (both counted from 0, also when sq != sk); the softmax weights
are cast to v's type before the P . V product (f32 sums), and the output
is ``o / max(l, 1e-30)``.  The kernel keeps a running max and sum over
key tiles and skips tiles above the diagonal; the plain version takes
each head's full softmax at once.  They agree to rounding: 2e-5 in f32
and 2e-2 in bf16, the reference's own tolerances.

The kernel compiles the (dqk, dv) pairs of ``HEAD_DIMS``, each in both
bodies; another pair raises a ``ValueError``.  The type picks the body
(``PATHS``): bf16 runs both products on the tensor cores (``mma.sync``
m16n8k16, f32 accumulate), f32 runs f32 FMAs on the SIMT cores; neither
falls back to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.index.base import full_f32_matmul
from repro_torch.kernels import build

NEG_INF = -1e30
# the kernel's compiled (dqk, dv) pairs: the square widths, and MLA's
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = {torch.float32: "FMA f32", torch.bfloat16: "mma.sync bf16"}


def _compiled(dqk: int, dv: int):
    if (dqk, dv) not in HEAD_DIMS:
        square = tuple(a for a, b in HEAD_DIMS if a == b)
        other = [p for p in HEAD_DIMS if p[0] != p[1]]
        raise ValueError(
            f"head dims (dqk={dqk}, dv={dv}) are not compiled; the kernel "
            f"takes dh in {square} with dv = dqk, or (dqk, dv) in {other}")


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
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
    return b, sq, sk, H, KVH, dqk, dv


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True):
    """Plain version (the reference's oracle ``flash_attention_ref``),
    one (b, head) at a time so that only one (sq, sk) score matrix is
    alive: the full f32 softmax, p cast to v's type before P . V, the
    row sum applied after the product, as the kernel does."""
    b, sq, sk, H, KVH, dqk, dv = _shapes(q, k, v)
    g = H // KVH
    scale = dqk ** -0.5
    out = torch.empty((b, sq, H, dv), dtype=v.dtype, device=q.device)
    visible = (torch.arange(sq, device=q.device)[:, None]
               >= torch.arange(sk, device=q.device)[None, :])
    with full_f32_matmul():
        for bi in range(b):
            for h in range(H):
                s = (q[bi, :, h].float() @ k[bi, :, h // g].float().T) \
                    * scale
                if causal:
                    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
                p = torch.exp(s - s.max(dim=1, keepdim=True).values)
                l = p.sum(dim=1, keepdim=True)
                o = p.to(v.dtype).float() @ v[bi, :, h // g].float()
                out[bi, :, h] = (o / torch.clamp(l, min=1e-30)).to(v.dtype)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True):
    """Launch the flash attention kernel; same operands and output as
    ``flash_attention_torch``."""
    b, sq, sk, H, KVH, dqk, dv = _shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda and t.device == q.device and t.dtype == v.dtype
                and t.dtype in DTYPES and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "float32 or bfloat16 CUDA tensor of v's type on "
                             f"q's device, got {t.dtype} on {t.device}")
    _compiled(dqk, dv)
    if max(b, H) > 65535 or min(b, sq, sk) < 1:
        raise ValueError(f"b={b}, H={H} must be at most 65535 and b, sq={sq},"
                         f" sk={sk} at least 1")
    out = torch.empty((b, sq, H, dv), dtype=v.dtype, device=q.device)
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.icq_flash_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        DTYPES[v.dtype], b, sq, sk, H, KVH, dqk, dv, dqk ** -0.5,
        int(causal), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")
    build.LAUNCHES["flash_attention"] += 1
    return out


def kernel_attributes(dtype: torch.dtype, dqk: int, dv=None) -> dict:
    """The body that runs for ``dtype`` at (``dqk``, ``dv``; ``dv``
    defaults to ``dqk``): its path (``PATHS``), registers per thread and
    local-memory bytes per thread (spills and local arrays), as
    ``cudaFuncGetAttributes`` reports them."""
    dv = dqk if dv is None else dv
    if dtype not in DTYPES:
        raise ValueError(f"no kernel for {dtype}")
    _compiled(dqk, dv)
    lib = build.library("flash_attention")
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.icq_flash_attention_attributes(
        DTYPES[dtype], dqk, dv, ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError("flash_attention attributes failed: "
                           f"{lib.icq_error_string(err).decode()}")
    return dict(path=PATHS[dtype], registers=regs.value,
                local_bytes=local.value)
