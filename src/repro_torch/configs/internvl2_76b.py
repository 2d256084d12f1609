"""internvl2-76b [vlm] — InternViT frontend (STUB: input_specs() provides
precomputed patch embeddings) + Llama3-70B-class LM backbone.
[arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500000.0,
    frontend="vision_stub",
    num_vision_tokens=256,       # 256 patch tokens prepended per image
    vision_dim=3200,             # InternViT-6B hidden (projected to d_model)
    optimizer_dtype="bfloat16",
    microbatch_size=2,
    remat_block=10,
    icq_kv=True,
    icq_grad=True,
)
