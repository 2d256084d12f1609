"""tinyllama-1.1b [dense] — llama2-arch small, GQA kv=4.  [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    activation="swiglu",
    rope_theta=10000.0,
    microbatch_size=8,
    icq_kv=True,
    icq_grad=True,
)
