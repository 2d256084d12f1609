"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 routed experts top-6
(+2 shared per the Moonlight HF config).  [hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                   # routed-expert hidden dim (assignment value)
    vocab_size=163840,
    activation="swiglu",
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_k_dense=1,
    dense_d_ff=11264,
    rope_theta=50000.0,
    microbatch_size=4,
    icq_kv=True,
    icq_grad=True,
)
