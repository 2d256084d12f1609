"""The four input shapes (twin of ``repro.configs.shapes``; the same
set for every LM-family arch).

``decode_*`` / ``long_*`` are serve steps (one new token against a KV
cache of ``seq_len``), not train steps.  ``long_500k`` needs a
sub-quadratic token-mixing path and only runs for archs with
``supports_long_context=True`` (SSM / hybrid).
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeSpec

TRAIN_4K = ShapeSpec(name="train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeSpec(name="prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeSpec(name="decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeSpec(name="long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(arch_cfg) -> dict:
    """All shape cells that are runnable for this arch (skips recorded)."""
    out = {}
    for name, spec in SHAPES.items():
        if name == "long_500k" and not arch_cfg.supports_long_context:
            continue
        out[name] = spec
    return out


def skipped_shapes_for(arch_cfg) -> list:
    return [n for n in SHAPES if n not in shapes_for(arch_cfg)]
