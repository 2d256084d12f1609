"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern
(two recurrent blocks per local-attention block), MQA kv=1, window 2048.
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,              # MQA on the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    hybrid=True,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    lru_width=4096,
    rope_theta=10000.0,
    microbatch_size=4,
    icq_kv=False,                # bounded local windows: marginal (DESIGN.md §5)
    icq_grad=True,
    supports_long_context=True,  # bounded window + O(1) LRU state
)
