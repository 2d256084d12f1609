"""whisper-large-v3 [audio] — enc-dec transformer backbone; the conv/mel
frontend is a STUB per assignment (input_specs() provides precomputed frame
embeddings).  [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,               # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    norm_type="layernorm",
    encdec=True,
    encoder_layers=32,
    encoder_seq_len=1500,        # 30 s audio -> 1500 frames after conv stub
    learned_pos_emb=True,
    frontend="audio_stub",
    microbatch_size=4,
    icq_kv=True,                 # self- and (static) cross-attention caches
    icq_grad=True,
)
