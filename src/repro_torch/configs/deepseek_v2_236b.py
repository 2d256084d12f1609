"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,            # MLA: all heads share the compressed latent
    head_dim=128,
    d_ff=1536,                   # routed-expert hidden dim (assignment value)
    vocab_size=102400,
    activation="swiglu",
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    first_k_dense=1,
    dense_d_ff=12288,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    optimizer_dtype="bfloat16",
    microbatch_size=2,
    remat_block=10,
    icq_kv=True,                 # composes on the 512-d MLA latent
    icq_grad=True,
)
