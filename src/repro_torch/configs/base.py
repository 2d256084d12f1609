"""Config dataclasses (twin of ``repro.configs.base``): the ICQ
hyper-parameter record ``ICQConfig``, the input-shape cell ``ShapeSpec``
and the architecture description ``ArchConfig``.  Every architecture
module of this package exports ``CONFIG: ArchConfig``."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ICQConfig:
    """Hyper-parameters of Interleaved Composite Quantization (paper §3).

    K codebooks of m codewords over a d-dimensional embedding space; the
    fast group |K_fast| quantizes the learned high-variance subspace psi.
    """
    d: int = 16                  # embedding dim (paper fixes d=16 for synthetic)
    num_codebooks: int = 8       # K
    codebook_size: int = 256     # m  (paper: C_k = 256 -> 8-bit codes)
    num_fast: int = 2            # |K_fast| codebooks for crude comparisons
    # Prior P(Lambda) = pi1*N(0,s1) + pi2*SN(mu2,s2,alpha2)   (paper eq. 4)
    pi1: float = 0.9
    pi2: float = 0.1
    alpha2: float = -10.0        # fixed negative skew (paper §3.3)
    # Loss weights (paper's gamma_1, gamma_2) + CQ inner-product penalty
    gamma_p: float = 0.2         # weight of L^P
    gamma_icq: float = 2.0       # weight of L^ICQ
    gamma_cq: float = 0.1        # weight of the CQ constant-inner-product term
    # Search
    margin_scale: float = 1.0    # scales sigma = sum_{i in psi_bar} lambda_i (eq. 11)
    # Training
    icm_iters: int = 3           # iterated conditional modes rounds for encoding
    learn_embedding: bool = True


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell: lowers train_step or serve_step."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Unified architecture description covering all assigned families."""
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    # ---- MoE ----
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim
    first_k_dense: int = 0       # leading dense layers before MoE stack
    dense_d_ff: int = 0          # d_ff used by those dense layers
    router_aux_weight: float = 0.001

    # ---- MLA (DeepSeek) ----
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- SSM (Mamba2 SSD) ----
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # ---- Hybrid (RecurrentGemma: RG-LRU + local attention) ----
    hybrid: bool = False
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","local")
    local_window: int = 0
    lru_width: int = 0

    # ---- Encoder-decoder (Whisper) ----
    encdec: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0     # fixed source length (audio frames)
    learned_pos_emb: bool = False

    # ---- Modality frontend stubs ----
    frontend: str = "none"       # none | audio_stub | vision_stub
    num_vision_tokens: int = 0   # prepended patch-embedding tokens (vlm)
    vision_dim: int = 0

    # ---- Training-time knobs (per-arch defaults, shape-overridable) ----
    remat: bool = True
    remat_block: int = 0               # >0: two-level (sqrt-L) remat blocks
    scan_layers: bool = True
    optimizer_dtype: str = "float32"   # bf16 moments for the largest archs
    grad_accum_dtype: str = "float32"  # microbatch grad accumulator dtype
    microbatch_size: int = 8           # per train-step accumulation slice
    param_dtype: str = "float32"       # bf16 at scale (dry-run overrides)
    compute_dtype: str = "float32"
    attn_chunk: int = 1024             # KV-chunk for online-softmax attention
    moe_dispatch: str = "ragged"       # ragged (1-device) | einsum (GSPMD/EP)
    capacity_factor: float = 1.25      # einsum dispatch capacity
    moe_token_chunk: int = 16384       # dispatch chunk (bounds (E,C,d) bufs)
    ce_chunk: int = 2048               # token-chunked fused head+CE (0 = off)
    seq_shard_acts: bool = False       # Megatron-SP: shard seq dim of the
                                       # residual stream over "model" between
                                       # layers (activation-memory bound)
    vocab_pad: int = 256               # pad embed/head rows to a multiple so
                                       # the vocab dim shards over "model"
                                       # (indivisible vocabs otherwise force
                                       # replicated logits); logits masked/
                                       # sliced back to the true vocab

    # ---- ICQ integration flags ----
    icq_kv: bool = False         # ICQ-quantized KV cache at decode
    icq_grad: bool = False       # ICQ gradient compression across pods

    # ---- long-context policy ----
    supports_long_context: bool = False  # sub-quadratic path for long_500k

    @property
    def padded_vocab(self) -> int:
        p = max(self.vocab_pad, 1)
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attn_free(self) -> bool:
        return self.ssm

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), for 6ND."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        per_layer = 0
        if self.ssm:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            # in_proj: z,x,B,C,dt ; out_proj
            conv_dim = d_in + 2 * self.ssm_state
            per_layer = (
                d * (2 * d_in + 2 * self.ssm_state + nheads)
                + conv_dim * self.ssm_conv_width
                + d_in * d + 2 * nheads + d
            )
        else:
            if self.mla:
                qd = self.q_lora_rank or d
                attn = (
                    (d * self.q_lora_rank if self.q_lora_rank else 0)
                    + qd * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d
                )
            else:
                attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            gated = self.activation in ("swiglu", "geglu")
            ff_mult = 3 if gated else 2
            if self.num_experts:
                moe_ff = ff_mult * d * self.moe_d_ff
                ffn = (self.num_experts + self.num_shared_experts) * moe_ff + d * self.num_experts
                dense_ffn = ff_mult * d * (self.dense_d_ff or self.d_ff)
                n_moe = L - self.first_k_dense
                per_layer = attn + (n_moe * ffn + self.first_k_dense * dense_ffn) / L
            else:
                ffn = ff_mult * d * self.d_ff
                per_layer = attn + ffn
            if self.hybrid:
                # average over pattern: rglru blocks replace attention
                lru = self.lru_width or d
                rg = d * lru * 2 + lru * d + 2 * lru * (lru // 16) + 2 * lru  # gates (block-diag) + proj
                n = len(self.block_pattern) or 1
                n_rec = sum(1 for b in self.block_pattern if b == "rglru")
                per_layer = (attn * (n - n_rec) + rg * n_rec) / n + ffn
            per_layer += 2 * d  # norms
        total = emb + head + int(per_layer) * L + d
        if self.encdec:
            total += int(per_layer) * self.encoder_layers  # encoder stack (approx.)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        gated = self.activation in ("swiglu", "geglu")
        ff_mult = 3 if gated else 2
        moe_ff = ff_mult * d * self.moe_d_ff
        all_experts = (self.num_experts + self.num_shared_experts) * moe_ff
        active = (self.experts_per_token + self.num_shared_experts) * moe_ff
        n_moe = L - self.first_k_dense
        return self.param_count() - n_moe * (all_experts - active)
