"""gemma-7b [dense] — GeGLU, head_dim=256, GQA kv=16.  [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    microbatch_size=4,
    remat_block=7,
    icq_kv=True,
    icq_grad=True,
)
