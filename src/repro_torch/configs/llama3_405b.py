"""llama3-405b [dense] — GQA kv=8, 128k vocab.  [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500000.0,
    # bf16 Adam moments and gradient accumulator: the reference's
    # training policy for the 405B (DESIGN.md §6); serving ignores both
    optimizer_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    microbatch_size=1,
    remat_block=14,    # sqrt-L remat: 126 saved carries -> 9+14
    icq_kv=True,
    icq_grad=True,
)
