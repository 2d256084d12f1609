"""granite-3-8b [dense] — GQA kv=8.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    microbatch_size=4,
    remat_block=8,
    icq_kv=True,
    icq_grad=True,
)
