"""Architecture registry: ``--arch <id>`` lookup for launchers and tests."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

# arch-id -> module name in this package
_MODULES = {
    "gemma-7b": "gemma_7b",
    "llama3-405b": "llama3_405b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "granite-3-8b": "granite_3_8b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-1.3b": "mamba2_1_3b",
    "internvl2-76b": "internvl2_76b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests.

    Small layers/width/experts/vocab; preserves every structural feature
    (GQA ratio, MLA, MoE routing, SSD, hybrid pattern, enc-dec, frontend).
    """
    cfg = get_config(arch)
    repl: Dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        vocab_size=128,
        microbatch_size=2,
        remat=False,
    )
    if cfg.ssm:
        repl.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    else:
        n_heads = max(2, min(cfg.num_heads, 4))
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        repl.update(num_heads=n_heads, num_kv_heads=n_kv, head_dim=16, d_ff=128)
    if cfg.num_experts:
        repl.update(num_experts=8, num_shared_experts=min(cfg.num_shared_experts, 1),
                    experts_per_token=2, moe_d_ff=32, dense_d_ff=128, first_k_dense=min(cfg.first_k_dense, 1))
        repl["num_layers"] = 2
    if cfg.mla:
        repl.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16)
    if cfg.hybrid:
        repl.update(block_pattern=("rglru", "local"), local_window=32,
                    lru_width=64, num_layers=2)
    if cfg.encdec:
        repl.update(encoder_layers=2, encoder_seq_len=16)
    if cfg.frontend == "vision_stub":
        repl.update(num_vision_tokens=4, vision_dim=48)
    return dataclasses.replace(cfg, **repl)
