"""Step builders of the LM serving path (twin of ``repro.launch.steps``:
``build_serve_fns`` and ``scale_config``).  The train step, the input
specs and the cell plans wait for ROADMAP items 22 (LM training) and 23
(LM sharding and the dry run)."""
from __future__ import annotations

import dataclasses

from repro_torch.models import build_model


def build_serve_fns(cfg, *, attn_impl: str = "chunked", mesh=None):
    """(prefill_fn, decode_fn, model).  prefill(params, batch, max_len),
    ``batch`` the reference's dict: ``tokens``, and ``patch_emb`` (the
    VLM) or ``audio_emb`` (the encoder-decoder); decode(params, tokens,
    caches)."""
    model = build_model(cfg, attn_impl=attn_impl, mesh=mesh)

    def prefill_fn(params, batch, max_len: int):
        return model.prefill(params, batch, max_len)

    def decode_fn(params, tokens, caches):
        return model.decode_step(params, tokens, caches)

    return prefill_fn, decode_fn, model


def scale_config(cfg):
    """Production dtype policy: bf16 params and bf16 compute (f32
    accumulation inside the products; norms and softmax in f32)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
