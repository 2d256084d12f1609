"""Config-driven index construction and the ``AnnEngine`` serving
handle (twin of ``repro.api.serving``) for the flat, two-step and IVF
kinds.

``load_ann_engine(path)`` opens a saved artifact directory as a serving
engine on the CUDA card; ``AnnEngine.search`` runs a query batch
through the index and attaches a ``ResultMeta`` to every result;
``AnnEngine.add`` grows the served index in place (``Index.add``).

This slice serves the ``full`` rung of the degradation ladder only,
with no mesh and no failover: a kernel that fails to build or launch
raises, whatever ``resilience.pallas_failover`` says (the field is kept
for config-hash parity).  The capped and crude rungs and the retry
policy wait for the resilience slice (ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.api.artifacts import ArtifactError, Artifacts, index_opts
from repro_torch.api.config import ConfigError, IndexConfig, ServeConfig
from repro_torch.core.encode import pack_nibbles
from repro_torch.index import make_index
from repro_torch.index.base import resolve_backend, resolve_device
from repro_torch.index.flat import FlatADC
from repro_torch.index.ivf import IVFTwoStep
from repro_torch.kernels.stages import pad_to
from repro_torch.resilience.budget import (ResultMeta, SearchBudget,
                                           validate_budget)


class AnnEngine:
    """A serving handle over one index: ``engine(queries)`` or
    ``engine.search(queries)`` serves an (nq, d) batch.

    ``query_tile``: None serves each batch at its own shape; set, every
    batch runs as zero-padded (tile, d) chunks, so a row's answer does
    not depend on how rows were batched (PyTorch, like XLA, may pick
    another reduction order for another batch shape).

    ``stats`` counts batches served per rung (only ``full`` here) and
    the degraded and failover totals (always 0 in this slice)."""

    def __init__(self, index, *, resilience=None,
                 query_tile: Optional[int] = None):
        self.index = index
        self.resilience = resilience
        self.query_tile = query_tile
        self.backend = resolve_backend(index.backend, index.device)
        self.stats: Dict[str, int] = {"degraded": 0, "failovers": 0}

    @property
    def n(self) -> int:
        return self.index.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _stages(self):
        probe = ("probe",) if isinstance(self.index, IVFTwoStep) else ()
        return probe + (("adc",) if isinstance(self.index, FlatADC)
                        else ("crude", "refine"))

    def _run_tiled(self, queries, k):
        """One call at the arrival shape, or (tile, d) zero-padded
        chunks with the pad rows sliced off; returns once the device
        has finished the batch."""
        tile = self.query_tile
        if tile is None:
            r = self.index.search(queries, k)
        else:
            nq = queries.shape[0]
            parts = [self.index.search(pad_to(queries[s:s + tile], tile), k)
                     for s in range(0, max(nq, 1), tile)]
            # avg_ops/pass_rate are padded-batch diagnostics (mean over
            # chunks); the bitwise contract covers ids and distances only
            r = parts[-1]._replace(
                indices=torch.cat([p.indices for p in parts])[:nq],
                distances=torch.cat([p.distances for p in parts])[:nq],
                avg_ops=sum(p.avg_ops for p in parts) / len(parts),
                pass_rate=sum(p.pass_rate for p in parts) / len(parts))
        if r.indices.is_cuda:
            torch.cuda.synchronize(r.indices.device)
        return r

    def add(self, new_vectors, **encode_opts) -> "AnnEngine":
        """Grow the served index by ``new_vectors`` ((n_new, d), numpy or
        torch): ``Index.add`` with ``encode_opts`` (``icm_iters``,
        ``encode_backend``, ``point_chunk``).  ``n`` and ``device`` follow
        the index; ``query_tile`` is unchanged.  Returns the engine."""
        self.index = self.index.add(new_vectors, **encode_opts)
        return self

    def __call__(self, queries, budget: Optional[SearchBudget] = None):
        return self.search(queries, budget=budget)

    def search(self, queries, k: Optional[int] = None, *,
               budget: Optional[SearchBudget] = None, filter=None):
        """Serve one query batch ((nq, d) numpy or torch; moved to the
        index's device as f32); ``k`` overrides the index's ``topk``."""
        if filter is not None:
            raise NotImplementedError(
                "filtered search is not ported to the PyTorch package yet "
                "(ROADMAP.md, queue 1, item 2)")
        budget = validate_budget(budget) if budget is not None \
            else SearchBudget()
        if (budget.force_level not in (None, "full")
                or not budget.allow_refine or budget.refine_cap is not None
                or budget.max_n_probe is not None):
            raise NotImplementedError(
                "the degradation ladder is not ported yet: this slice "
                "serves the 'full' rung only (ROADMAP.md, queue 1, item 4)")
        deadline = budget.deadline_ms
        if deadline is None and self.resilience is not None:
            deadline = self.resilience.deadline_ms
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.array(queries, np.float32))
        queries = queries.to(self.device, torch.float32)
        t0 = time.perf_counter()
        result = self._run_tiled(queries, k)
        wall_ms = (time.perf_counter() - t0) * 1000.0
        meta = ResultMeta(
            stages=self._stages(), wall_ms=wall_ms, deadline_ms=deadline,
            deadline_exceeded=deadline is not None and wall_ms > deadline,
            backend=self.backend)
        self.stats["full"] = self.stats.get("full", 0) + 1
        return result._replace(meta=meta)

    def warm(self, nq: int, k: Optional[int] = None) -> "AnnEngine":
        """Serve one all-zero (nq, d) batch so the first real batch finds
        the kernels built and loaded and the allocator warm."""
        d = int(self.index.C.shape[-1])
        self._run_tiled(torch.zeros((int(nq), d), dtype=torch.float32,
                                    device=self.device), k)
        return self


def build_index(codes, C, structure, *, index_cfg: IndexConfig,
                serve_cfg: ServeConfig, emb_db=None, generator=None,
                device=None):
    """Build an index from the config tree's sections on ``device`` (the
    card unless named).  ``index_cfg.code_bits == 4`` packs byte-per-code
    (n, K) codes two per byte; codes already in the (n, ceil(K/2))
    layout are taken as they are.

    ``emb_db`` (the (n, d) embeddings the codes encode) is required for
    ``index_cfg.kind == "ivf"``; ``generator`` (a ``torch.Generator`` or
    an int seed) seeds its coarse k-means, which runs on the device."""
    if index_cfg.code_bits == 4:
        if C.shape[1] > 16:
            raise ConfigError(
                f"index.code_bits=4 requires codebook_size <= 16 "
                f"codewords (4-bit codes), got m={C.shape[1]}; set "
                "train.codebook_size <= 16 or keep index.code_bits=8")
        if codes.shape[-1] == C.shape[0] and C.shape[0] > 1:
            codes = pack_nibbles(
                codes if isinstance(codes, torch.Tensor)
                else torch.from_numpy(np.array(codes)), C.shape[0])
    opts = index_opts(index_cfg, serve_cfg)
    if index_cfg.kind == "ivf":
        if emb_db is None:
            raise ConfigError("index.kind='ivf' needs emb_db= (the "
                              "embeddings the codes encode) to fit the "
                              "coarse quantizer")
        opts.update(emb_db=emb_db, n_lists=index_cfg.n_lists,
                    kmeans_iters=index_cfg.kmeans_iters,
                    generator=generator)
    return make_index(index_cfg.kind, codes, C, structure, device=device,
                      **opts)


def load_ann_engine(path: str, *, device=None,
                    overrides: Optional[Dict[str, Any]] = None,
                    verify_checksums: Optional[bool] = None,
                    query_tile: Optional[int] = None) -> AnnEngine:
    """Open a saved artifact directory as a serving engine on ``device``
    (the CUDA card unless named; with no card this raises).

    ``overrides`` applies dotted config overrides before the index is
    rebuilt.  ``verify_checksums`` forces the per-tensor sha256 pass
    (None defers to the embedded ``resilience.verify_artifacts``)."""
    device = resolve_device(device)
    art = Artifacts.load(path, overrides=overrides,
                         verify_checksums=verify_checksums, device=device)
    if art.index is None:
        raise ArtifactError(
            f"{path}: artifacts hold no index (model-only save); build "
            "one and save again")
    return AnnEngine(art.index, resilience=art.config.resilience,
                     query_tile=query_tile)
