"""Trainer-layer foundations (twin of ``repro.trainer.base``): the
``Quantizer`` protocol and the ``ICQModel`` fitted artifact.

Every quantizer speaks the same three verbs:

    init(seed, xs, ys)  -> state     seed codebooks / embedding / prior
    step(state, batch)  -> state     one optimization step or round
    finalize(state, xs) -> ICQModel  export: project, encode db, pack

The quantizers behind the protocol (joint, PQ, OPQ, CQ) are in
``trainer/quantizers.py``; the joint trainer's functions are in
``trainer/joint.py`` and its epoch loop in ``trainer/epoch.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Protocol, runtime_checkable

import torch


@dataclasses.dataclass
class ICQModel:
    """Fitted artifact: everything the search side needs."""
    icq_cfg: Any
    embed_params: Any
    embed_apply: Callable
    C: torch.Tensor              # (K,m,d) — hard-projected for mode="icq"
    codes: torch.Tensor          # (n,K) database codes (ICM-encoded, packed)
    structure: Any               # core.icq.ICQStructure
    lam: torch.Tensor            # (d,) final variance estimate
    mode: str = "icq"

    def embed(self, x):
        return self.embed_apply(self.embed_params, x)


@runtime_checkable
class Quantizer(Protocol):
    """The unified quantizer protocol."""

    def init(self, seed, xs, ys=None) -> Dict:
        ...

    def step(self, state: Dict, batch) -> Dict:
        ...

    def finalize(self, state: Dict, xs) -> ICQModel:
        ...


def plain_structure(C, d: int):
    """The degenerate structure non-interleaved quantizers export: every
    dimension in psi, every codebook fast, zero margin (one-step ADC
    semantics through the shared search API), on C's device."""
    from repro_torch.core.icq import ICQStructure

    return ICQStructure(
        xi=torch.ones((d,), dtype=torch.bool, device=C.device),
        fast_mask=torch.ones((C.shape[0],), dtype=torch.bool,
                             device=C.device),
        sigma=torch.zeros((), device=C.device))
