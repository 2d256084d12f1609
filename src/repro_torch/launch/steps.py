"""Step builders of the LM paths (twin of ``repro.launch.steps``): the
train step with gradient accumulation over microbatches, the batch
geometry, and the serving functions.

``build_train_step`` — microbatches in a loop (the reference's
``lax.scan``), each differentiated by autograd through
``train_forward`` (remat inside the model's layers), the gradients
accumulated in ``cfg.grad_accum_dtype``, then the optimizer update; all
of it with full-f32 matrix products on the card (no TF32).  The
compressed cross-pod combine (``multi_pod``) and a sharded mesh wait
for ROADMAP item 23 (LM sharding and the dry run); the cell plans and
lowering are the reference's XLA dry run and come with it too.
``build_serve_fns`` — prefill and decode_step.

Microbatching: batches come shaped (n_micro, micro_batch, seq);
``n_micro`` follows the arch's ``microbatch_size`` (rows a data shard):
n_micro = global_batch / (dp_size * microbatch_size).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.index.base import full_f32_matmul
from repro_torch.models import build_model
from repro_torch.train.optimizer import (make_optimizer, tree_leaves,
                                         tree_map, tree_unflatten)

# the ROADMAP item of what this module does not build yet
_SHARDING = "item 23 (LM sharding and the dry run)"


# ----------------------------------------------------------- geometry ----

def num_microbatches(cfg, shape, dp: int) -> int:
    per_shard = max(shape.global_batch // max(dp, 1), 1)
    n_micro = max(per_shard // max(cfg.microbatch_size, 1), 1)
    while shape.global_batch % n_micro:
        n_micro -= 1
    return max(n_micro, 1)


def batch_struct(cfg, shape, n_micro: int, *,
                 train: bool) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{name: (shape, dtype)} of one input batch (microbatch-major for
    train): the reference's ``ShapeDtypeStruct`` stand-ins as plain
    shapes and torch dtypes."""
    B, S = shape.global_batch, shape.seq_len
    vis = cfg.frontend == "vision_stub"
    s_text = S - (cfg.num_vision_tokens if vis else 0)
    rows = B // n_micro if train else B

    def shp(*dims):
        return (n_micro,) + dims if train else dims

    specs = {"tokens": (shp(rows, s_text), torch.int32)}
    if train:
        specs["labels"] = specs["tokens"]
    if vis:
        specs["patch_emb"] = (shp(rows, cfg.num_vision_tokens,
                                  cfg.vision_dim), torch.bfloat16)
    if cfg.encdec:
        specs["audio_emb"] = (shp(rows, cfg.encoder_seq_len, cfg.d_model),
                              torch.bfloat16)
    return specs


# -------------------------------------------------------------- train ----

def tree_zeros(tree, dtype):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                          device=x.device), tree)


def build_train_step(cfg, *, n_micro: int, multi_pod: bool = False,
                     attn_impl: str = "chunked", total_steps: int = 10000,
                     mesh=None):
    """Returns (train_step, model, opt, init_opt_state).

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm"})``: batch leaves (n_micro, micro_B, ...), numpy
    arrays or tensors; the loss the microbatches' mean; new param and
    optimizer tensors (the inputs are not modified).  Gradients of
    every microbatch add in place into one accumulator in
    ``cfg.grad_accum_dtype`` (the reference's sum, in its order), which
    is then scaled in place by 1 / n_micro."""
    if multi_pod:
        raise NotImplementedError(
            "the compressed cross-pod gradient combine (multi_pod) of the "
            f"train step waits for ROADMAP {_SHARDING}")
    if mesh is not None and any(
            mesh.shape.get(a, 1) > 1 for a in ("data", "pod", "model")):
        raise NotImplementedError(
            f"a train step over a sharded mesh ({mesh.shape}) waits for "
            f"ROADMAP {_SHARDING}")
    model = build_model(cfg, attn_impl=attn_impl)
    opt = make_optimizer(cfg, total_steps=total_steps)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        gacc, lsum = None, None
        for i in range(n_micro):
            mb = {k: v[i] for k, v in batch.items()}
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = model.train_forward(tree_unflatten(params, live), mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, live)]
            if gacc is None:
                gacc = [g.to(acc_dtype) for g in grads]
                lsum = loss.detach()
            else:
                for a, g in zip(gacc, grads):
                    a.add_(g.to(acc_dtype))
                lsum = lsum + loss.detach()
            del grads, live, loss
        scale = 1.0 / n_micro
        for g in gacc:
            g.mul_(scale)
        return tree_unflatten(params, gacc), lsum * scale

    def train_step(params, opt_state, batch):
        with full_f32_matmul():
            grads, loss = grads_of(params, batch)
            new_params, new_opt, gnorm = opt.update(grads, opt_state,
                                                    params)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm}

    def init_opt_state(params):
        return opt.init(params)

    return train_step, model, opt, init_opt_state


# ---------------------------------------------------------------- serve ----

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
