"""mamba2-1.3b [ssm] — SSD (state-space duality), attn-free.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # attn-free, no FFN: Mamba2 blocks only
    vocab_size=50280,
    ssm=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    microbatch_size=2,
    ssm_chunk=128,
    icq_kv=False,                # no KV cache: inapplicable (DESIGN.md §5)
    icq_grad=True,
    supports_long_context=True,  # O(1) recurrent state -> long_500k runs
)
