"""Embedding models W for the quantization pipelines (twin of
``repro.core.embed``).

- ``linear``: the SQ-style learned linear map R^{d_raw} -> R^d (Wang et
  al. 2016) with an auxiliary classifier head for L^E.
- ``cnn``: a LeNet-style convolutional embedder for image-shaped data
  (paper §4.2).  It keeps the reference's layouts: the input is NHWC
  and the conv weights HWIO; ``cnn_apply`` permutes them to NCHW / OIHW
  for ``conv2d`` (SAME padding: 2 on each side of a 5x5 window; full
  f32, no TF32, wherever it is called) and back to NHWC before the
  dense layer, so the flattened features are in the reference's
  (h, w, c) order.
- ``identity``: the embeddings are the inputs.

Each exposes ``init(generator, ...) -> params`` and ``apply(params, x)
-> emb``, plus ``classify(params, emb)`` for the classification loss.
Params are drawn on the generator's device, in the order the init
functions list them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.index.base import full_f32_matmul
from repro_torch.models import nn


# ---------------------------------------------------------------- linear ----

def linear_init(generator, d_raw: int, d: int, num_classes: int):
    """Draws w (d_raw, d), then cls (d, num_classes)."""
    w = nn.dense_init(generator, d_raw, d)
    cls = nn.dense_init(generator, d, num_classes)
    return {"w": w, "b": nn.bias_init(d).to(w.device), "cls": cls}


def linear_apply(params, x):
    return x @ params["w"] + params["b"]


# ------------------------------------------------------------------- cnn ----

def _conv_init(generator, h, w, cin, cout):
    fan_in = h * w * cin
    return (torch.randn((h, w, cin, cout), generator=generator,
                        device=generator.device, dtype=torch.float32)
            / torch.sqrt(torch.tensor(float(fan_in))))


def _conv(x, w):
    """SAME, stride 1: x (n, C, H, W), w HWIO -> (n, O, H, W), in full
    f32 on the card (cuDNN's default is TF32, which would move every
    embedding by ~1e-3 relative)."""
    with full_f32_matmul():
        return F.conv2d(x, w.permute(3, 2, 0, 1),
                        padding=(w.shape[0] // 2, w.shape[1] // 2))


def _pool(x):
    """2x2 max pool, stride 2, VALID."""
    return F.max_pool2d(x, 2, 2)


def cnn_init(generator, img_hw: int, channels: int, d: int,
             num_classes: int, width: int = 32):
    """LeNet-style: conv-pool-conv-pool-dense -> d-dim embedding.
    Draws c1, c2, fc, cls in that order."""
    flat = (img_hw // 4) * (img_hw // 4) * (2 * width)
    c1 = _conv_init(generator, 5, 5, channels, width)
    c2 = _conv_init(generator, 5, 5, width, 2 * width)
    fc = nn.dense_init(generator, flat, d)
    cls = nn.dense_init(generator, d, num_classes)
    dev = c1.device
    return {"c1": c1, "b1": nn.bias_init(width).to(dev),
            "c2": c2, "b2": nn.bias_init(2 * width).to(dev),
            "fc": fc, "fcb": nn.bias_init(d).to(dev), "cls": cls}


def cnn_apply(params, x):
    """x: (n, H, W, C) float -> (n, d)."""
    h = x.permute(0, 3, 1, 2)
    h = _pool(F.relu(_conv(h, params["c1"])
                     + params["b1"][None, :, None, None]))
    h = _pool(F.relu(_conv(h, params["c2"])
                     + params["b2"][None, :, None, None]))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h @ params["fc"] + params["fcb"]


def classify(params, emb):
    return emb @ params["cls"]


def identity_apply(params, x):
    return x


def build_embedder(kind: str, generator, *, d_raw=None, d=16,
                   num_classes=10, img_hw=None, channels=None):
    """Factory -> (params, apply).  kind: 'linear' | 'cnn' | 'identity'
    ('identity' draws its classifier head only)."""
    if kind == "linear":
        return linear_init(generator, d_raw, d, num_classes), linear_apply
    if kind == "cnn":
        return (cnn_init(generator, img_hw, channels, d, num_classes),
                cnn_apply)
    if kind == "identity":
        return ({"cls": nn.dense_init(generator, d, num_classes)},
                identity_apply)
    raise ValueError(kind)
