"""Quantizer implementations behind the trainer protocol (twin of
``repro.trainer.quantizers``).

``JointQuantizer`` wraps the joint trainer (mode "icq" | "cq" | "pq":
the ICQ system plus the SQ and PQN supervised baselines).  The
unsupervised baselines PQ / OPQ / CQ speak the same init/step/finalize
verbs: closed-form or round-based ``step``s, and a ``finalize`` that
exports through the tiled encoder.  The ``fit_*`` entry points
(re-exported by ``core/baselines/*``) are thin loops over these
classes.

Every quantizer runs on ``device`` (the CUDA card unless named; the
data moves there) and draws its randomness from ``seed`` (an int or a
``torch.Generator``), where the reference takes a ``key``.  Every matrix
product runs in full f32 (``index.base.full_f32_matmul``), so the card
and the CPU agree to rounding; the k-means and the encoders run the
``kmeans_assign`` and ICM kernels on the card.  The states are dicts of
tensors (and ints), so a step can be run again from a copy of its
inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import codebooks as cb
from repro_torch.core import encode as enc
from repro_torch.core import losses
from repro_torch.core.embed import identity_apply
from repro_torch.index.base import (as_generator, as_torch, full_f32_matmul,
                                    resolve_device)
from repro_torch.train.optimizer import AdamW
from repro_torch.trainer import joint
from repro_torch.trainer.base import ICQModel, plain_structure
from repro_torch.trainer.encode import encode_database


def _batch_x(batch):
    """The inputs of a step's batch: x of an (x, y) pair, or x itself."""
    return batch[0] if isinstance(batch, (tuple, list)) else batch


def _population_var(emb):
    """Per-dimension variance over the rows (the reference's
    ``jnp.var``: no Bessel correction)."""
    return torch.var(emb, dim=0, correction=0)


@dataclasses.dataclass
class JointQuantizer:
    """The joint embedding + codebook trainer as a protocol quantizer.

    mode="icq" is the paper's system; mode="cq" with the linear embedder
    is SQ (Wang et al.); mode="pq" with the CNN embedder is PQN-style
    (Yu et al.).  ``step`` is one step of ``joint.make_train_step`` on
    an (x, y) minibatch (``trainer.epoch`` loops them into epochs)."""
    icq_cfg: Any
    mode: str = "icq"
    embed_kind: str = "linear"
    num_classes: int = 10
    img_hw: Optional[int] = None
    channels: Optional[int] = None
    lr: float = 1e-3
    tau: float = 1.0
    sample_size: int = 4096
    device: Any = None

    def init(self, seed, xs, ys=None) -> Dict:
        dev = resolve_device(self.device)
        xs = as_torch(xs).to(dev, torch.float32).contiguous()
        n = xs.shape[0]
        ys = (torch.zeros((n,), dtype=torch.int32, device=dev)
              if ys is None else as_torch(ys).to(dev))
        k = min(n, self.sample_size)
        st = joint.init_train_state(
            seed, self.icq_cfg, embed_kind=self.embed_kind,
            d_raw=xs.shape[-1] if xs.ndim == 2 else None,
            num_classes=self.num_classes, img_hw=self.img_hw,
            channels=self.channels, mode=self.mode, lr=self.lr,
            sample_batch=(xs[:k], ys[:k]), device=dev)
        st["step_fn"] = joint.make_train_step(
            self.icq_cfg, st["embed_apply"], st["opt"], self.mode,
            st["pq_mask"], self.tau)
        return st

    def step(self, state: Dict, batch) -> Dict:
        dev = state["params"]["C"].device
        x, y = (as_torch(b).to(dev) for b in batch)
        p, o, v, mets = state["step_fn"](state["params"],
                                         state["opt_state"],
                                         state["var_state"],
                                         (x.to(torch.float32), y))
        return dict(state, params=p, opt_state=o, var_state=v,
                    last_metrics=mets)

    def finalize(self, state: Dict, xs) -> ICQModel:
        return joint.finalize(state["params"], state["embed_apply"],
                              state["var_state"], self.icq_cfg, xs,
                              mode=self.mode)


class _Unsupervised:
    """What the PQ / OPQ / CQ baselines share: an optional fixed
    embedder (identity when none is given) applied on the device."""

    def _apply(self):
        return self.embed_apply or identity_apply

    def _embed(self, xs):
        x = as_torch(xs).to(resolve_device(self.device), torch.float32)
        with full_f32_matmul(), torch.no_grad():
            emb = self._apply()(self.embed_params, x)
        return emb.to(torch.float32).contiguous()


@dataclasses.dataclass
class PQQuantizer(_Unsupervised):
    """Product Quantization (Jegou, Douze, Schmid 2010).

    Unsupervised and closed-form: ``init`` fits k-means per contiguous
    subspace on the given sample; ``step`` is the identity (kept for
    protocol uniformity); ``finalize`` encodes independently per
    codebook through ``encode_database``."""
    icq_cfg: Any
    kmeans_iters: int = 25
    embed_params: Any = None
    embed_apply: Any = None
    device: Any = None

    def init(self, seed, xs, ys=None) -> Dict:
        emb = self._embed(xs)
        C = cb.init_pq(as_generator(seed), emb, self.icq_cfg.num_codebooks,
                       self.icq_cfg.codebook_size, self.kmeans_iters)
        return {"C": C}

    def step(self, state: Dict, batch) -> Dict:
        return state                          # closed-form at init

    def finalize(self, state: Dict, xs) -> ICQModel:
        emb = self._embed(xs)
        C = state["C"]
        codes = encode_database(emb, C, mode="pq", device=C.device)
        return ICQModel(icq_cfg=self.icq_cfg, embed_params=self.embed_params,
                        embed_apply=self._apply(), C=C, codes=codes,
                        structure=plain_structure(C, emb.shape[-1]),
                        lam=_population_var(emb), mode="pq")


def _rotated(base_apply):
    """OPQ's export apply: the base embedder, then the rotation R, in
    full f32 wherever it is called."""
    def apply_fn(p, x):
        with full_f32_matmul():
            return base_apply(p["base"], x) @ p["R"]
    return apply_fn


@dataclasses.dataclass
class OPQQuantizer(_Unsupervised):
    """Optimized Product Quantization (Ge et al. 2013), non-parametric.

    ``step`` is one alternation round on its batch: (1) PQ in the
    rotated space x R; (2) the rotation update by the orthogonal
    Procrustes solution R = U V^T from SVD(X^T Xbar).  Round r's k-means
    draws from a generator seeded by (the state's seed, r), as the
    reference folds its key with the round, so a step depends on its
    state alone.  ``finalize`` folds R into the embedding apply, so the
    search side is shared with plain PQ."""
    icq_cfg: Any
    kmeans_iters: int = 10
    embed_params: Any = None
    embed_apply: Any = None
    device: Any = None

    def init(self, seed, xs, ys=None) -> Dict:
        emb = self._embed(xs)
        draw = torch.randint(0, 2**62, (1,), generator=as_generator(seed))
        return {"R": torch.eye(emb.shape[-1], dtype=torch.float32,
                               device=emb.device),
                "C": None, "seed": int(draw), "round": 0}

    def step(self, state: Dict, batch) -> Dict:
        emb = self._embed(_batch_x(batch))
        gen = torch.Generator().manual_seed(
            (state["seed"] * 1_000_003 + state["round"]) % 2**63)
        with full_f32_matmul(), torch.no_grad():
            xr = emb @ state["R"]
            C = cb.init_pq(gen, xr, self.icq_cfg.num_codebooks,
                           self.icq_cfg.codebook_size, self.kmeans_iters)
            xbar = cb.decode(C, enc.encode_pq(xr, C))
            # Procrustes: maximize tr(R^T X^T Xbar)  ->  R = U V^T
            u, _, vt = torch.linalg.svd(emb.T @ xbar, full_matrices=False)
            R = u @ vt
        return dict(state, R=R, C=C, round=state["round"] + 1)

    def finalize(self, state: Dict, xs) -> ICQModel:
        emb = self._embed(xs)
        with full_f32_matmul(), torch.no_grad():
            xr = emb @ state["R"]
        C = state["C"]
        codes = encode_database(xr, C, mode="pq", device=C.device)
        return ICQModel(icq_cfg=self.icq_cfg,
                        embed_params={"base": self.embed_params,
                                      "R": state["R"]},
                        embed_apply=_rotated(self._apply()), C=C,
                        codes=codes,
                        structure=plain_structure(C, emb.shape[-1]),
                        lam=_population_var(xr), mode="pq")


def _cq_loss(C, codes, emb, gamma: float):
    """Reconstruction error plus ``gamma`` times the CQ penalty."""
    rec = cb.decode(C, codes)
    l_rec = torch.mean(torch.sum(torch.square(emb - rec), dim=-1))
    l_cq, _ = losses.cq_penalty(C, codes)
    return l_rec + gamma * l_cq


@dataclasses.dataclass
class CQQuantizer(_Unsupervised):
    """Composite Quantization (Zhang, Du, Wang 2014), unsupervised.

    Additive codebooks with the constant-inner-product constraint;
    ``step`` is one round of ``grad_steps`` AdamW updates of C (constant
    lr, no decay, no clip; gradients by ``torch.autograd``) followed by
    ICM re-encoding warm-started from the previous codes."""
    icq_cfg: Any
    grad_steps: int = 50
    lr: float = 5e-3
    embed_params: Any = None
    embed_apply: Any = None
    device: Any = None

    def _opt(self) -> AdamW:
        return AdamW(lr=lambda s: self.lr, weight_decay=0.0, clip_norm=0.0)

    def init(self, seed, xs, ys=None) -> Dict:
        emb = self._embed(xs)
        C = cb.init_residual(as_generator(seed), emb,
                             self.icq_cfg.num_codebooks,
                             self.icq_cfg.codebook_size, iters=10)
        codes = enc.icm_encode(emb, C, self.icq_cfg.icm_iters)
        return {"C": C, "codes": codes,
                "opt_state": self._opt().init({"C": C})}

    def c_grad(self, C, codes, emb):
        """The gradient in C of the reconstruction error plus
        ``gamma_cq`` times the CQ penalty, at fixed codes."""
        with full_f32_matmul(), torch.enable_grad():
            live = C.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                _cq_loss(live, codes, emb, self.icq_cfg.gamma_cq), [live])
        return g

    def c_update(self, C, g, opt_state):
        """The AdamW update of C by gradient ``g`` -> (C, opt_state)."""
        params, opt_state, _ = self._opt().update({"C": g}, opt_state,
                                                  {"C": C})
        return params["C"], opt_state

    def c_step(self, C, codes, opt_state, emb):
        """One AdamW update of C at fixed codes -> (C, opt_state)."""
        return self.c_update(C, self.c_grad(C, codes, emb), opt_state)

    def c_steps(self, C, codes, opt_state, emb):
        """``grad_steps`` updates of C at fixed codes -> (C,
        opt_state)."""
        for _ in range(self.grad_steps):
            C, opt_state = self.c_step(C, codes, opt_state, emb)
        return C, opt_state

    def step(self, state: Dict, batch) -> Dict:
        emb = self._embed(_batch_x(batch))
        C, opt_state = self.c_steps(state["C"], state["codes"],
                                    state["opt_state"], emb)
        codes = enc.icm_encode(emb, C, self.icq_cfg.icm_iters,
                               init_codes=state["codes"])
        return dict(state, C=C, codes=codes, opt_state=opt_state)

    def finalize(self, state: Dict, xs) -> ICQModel:
        """Export the codes of the last step's batch (not a fresh
        encode of ``xs``, as in the reference); ``xs`` gives the
        variance estimate."""
        emb = self._embed(xs)
        C = state["C"]
        codes = enc.pack_codes(state["codes"], self.icq_cfg.codebook_size)
        return ICQModel(icq_cfg=self.icq_cfg, embed_params=self.embed_params,
                        embed_apply=self._apply(), C=C, codes=codes,
                        structure=plain_structure(C, emb.shape[-1]),
                        lam=_population_var(emb), mode="cq")


# ----------------------------------------------------- the fit_* entries

def fit_pq(seed, xs, icq_cfg, *, kmeans_iters: int = 25,
           embed_params=None, embed_apply=None, device=None) -> ICQModel:
    """Fit PQ on raw vectors (or embedded ones if embed_* given)."""
    q = PQQuantizer(icq_cfg, kmeans_iters=kmeans_iters,
                    embed_params=embed_params, embed_apply=embed_apply,
                    device=device)
    return q.finalize(q.init(seed, xs), xs)


def fit_opq(seed, xs, icq_cfg, *, rounds: int = 8, kmeans_iters: int = 10,
            embed_params=None, embed_apply=None, device=None) -> ICQModel:
    """Fit OPQ: ``rounds`` alternation steps over the full data."""
    q = OPQQuantizer(icq_cfg, kmeans_iters=kmeans_iters,
                     embed_params=embed_params, embed_apply=embed_apply,
                     device=device)
    state = q.init(seed, xs)
    for _ in range(rounds):
        state = q.step(state, xs)
    return q.finalize(state, xs)


def fit_cq(seed, xs, icq_cfg, *, rounds: int = 10, grad_steps: int = 50,
           lr: float = 5e-3, embed_params=None, embed_apply=None,
           device=None) -> ICQModel:
    """Fit CQ: ``rounds`` (C-gradient + ICM re-encode) rounds."""
    q = CQQuantizer(icq_cfg, grad_steps=grad_steps, lr=lr,
                    embed_params=embed_params, embed_apply=embed_apply,
                    device=device)
    state = q.init(seed, xs)
    for _ in range(rounds):
        state = q.step(state, xs)
    return q.finalize(state, xs)
