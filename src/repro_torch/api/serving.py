"""Config-driven index construction and the ``AnnEngine`` serving
handle (twin of ``repro.api.serving``) for the flat, two-step and IVF
kinds.

``load_ann_engine(path)`` opens a saved artifact directory as a serving
engine on the CUDA card; ``build_ann_engine(codes, C, structure, ...)``
is the kwarg front door (folded into ``IndexConfig`` and
``ServeConfig``, then ``build_index``); ``AnnEngine.search`` runs a
query batch through the index and attaches a ``ResultMeta`` to every
result; ``AnnEngine.add`` grows the served index in place.

The engine executes the degradation ladder (full -> capped -> probes ->
crude): per batch it picks the least degraded rung whose measured warm
wall time (an EMA, alpha 0.3) fits the budget's deadline; hard caps
promote their rung (``refine_cap`` the capped rung, ``max_n_probe`` below
the index's ``n_probe`` the probes rung) and ``allow_refine=False``
takes the crude floor.  The rungs follow the reference backend for
backend: every rung runs on the kernels on the card, and the capped
rung, like ``filter``, is a jnp-engine option of the reference, so an
index whose ``serve.backend`` is auto or pallas on the card (resolved
"cuda", the fused engine) serves two-step and flat {full, crude} and
IVF {full, probes, crude}, and refuses ``filter`` with the reference's
words, while ``serve.backend="jnp"`` on the card ("cuda-jnp") and every
backend on the CPU ("torch") add the capped rung (two-step {full,
capped, crude}, IVF {full, capped, probes, crude}) and serve
``filter``.  A sharded engine serves ``filter`` under every backend, as
the reference's sharded bodies do.

A failed batch (a ``RuntimeError``: a kernel launch, a CUDA error, an
injected fault) is retried in place, as the reference retries it: one
attempt, then 1 + ``resilience.max_retries`` more under
``BackoffPolicy`` (2 + ``max_retries`` in all; every attempt after the
first counted in ``stats["retries"]``); the last failure raises
``RetriesExhausted`` chained to it.  A refused argument
(``ValueError``) raises at once.  The engine never fails over: the
reference's Pallas -> jnp failover would move the batch onto another
engine of the same kernels, and a fallback would hide a failing
kernel.  So
``resilience.pallas_failover`` is kept for ``config_hash`` parity and
has no effect here; ``stats["failovers"]`` stays 0.

``AnnEngine(index, mesh)`` serves ``index.shard(mesh)``
(``index/sharded.py``: rows or lists over the mesh's ``data`` axis, the
scan kernels on every shard's device) and keeps the unsharded source,
so ``add`` grows the source and shards it again, the dead shards
carried over.  A sharded engine serves the ``("full",)`` rung only;
``mark_shard_dead`` fails shards over, and every result reports the
reachable share as ``meta.coverage``, flagged ``degraded`` below 1.  A
failed sharded batch is retried in place like any other.

A pipelined index (``serve.pipeline``, queue 1 item 7, done) is served
like any other; with ``query_tile`` set the engine cuts the batch
first, so the index sees one tile a call and has nothing to overlap,
as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.artifacts import ArtifactError, Artifacts, index_opts
from repro_torch.api.config import (ConfigError, IndexConfig,
                                    ResilienceConfig, ServeConfig)
from repro_torch.core.encode import pack_nibbles
from repro_torch.index import make_index
from repro_torch.index.base import resolve_backend, resolve_device
from repro_torch.index.flat import FlatADC
from repro_torch.index.ivf import IVFTwoStep
from repro_torch.kernels.stages import pad_to
from repro_torch.resilience.budget import (DEGRADE_LEVELS, ResultMeta,
                                           SearchBudget, validate_budget)
from repro_torch.resilience.retry import BackoffPolicy, retry_with_backoff

# warm-timing EMA weight: recent batches dominate, but one outlier does
# not whipsaw the ladder's choice
_EMA_ALPHA = 0.3


class AnnEngine:
    """A serving handle over one index: ``engine(queries)`` or
    ``engine.search(queries, k, budget=, filter=)`` serves an (nq, d)
    batch and attaches a ``ResultMeta``.

    ``query_tile``: None serves each batch at its own shape; set, every
    batch runs as zero-padded (tile, d) chunks, so a row's answer does
    not depend on how rows were batched (PyTorch, like XLA, may pick
    another reduction order for another batch shape).

    ``resilience`` (a ``ResilienceConfig``): the default deadline, the
    ladder's knobs and the retry policy.  ``fault_injector`` (a
    ``resilience.faults.FaultInjector``) is checked at ``engine.search``
    before each attempt; its kernel hook is installed separately
    (``injector.installed()``).

    ``mesh`` (a ``distributed.Mesh`` with a ``data`` axis) serves the
    index sharded over it; ``index`` stays the unsharded source.

    ``stats`` counts batches served per rung and the degraded, retried
    and failed-over totals (failovers stay 0: see the module docstring).
    """

    def __init__(self, index, mesh=None, *,
                 resilience: Optional[ResilienceConfig] = None,
                 fault_injector=None, query_tile: Optional[int] = None):
        self.index = index                  # the unsharded source index
        self.mesh = mesh
        self.resilience = resilience or ResilienceConfig()
        self.fault_injector = fault_injector
        self.query_tile = query_tile
        self._ema: Dict[str, float] = {}     # rung -> warm wall-ms EMA
        self._warmed: set = set()            # rung variants served once
        self.stats: Dict[str, int] = {"degraded": 0, "failovers": 0,
                                      "retries": 0}
        self._refresh()

    def _refresh(self):
        """The served view: the source index, or its sharded clone with
        the dead shards of the view it replaces (an ``add`` must not
        resurrect a failed shard)."""
        if self.mesh is not None:
            view = self.index.shard(self.mesh)
            dead = getattr(getattr(self, "_view", None), "dead_shards", ())
            if dead:
                view.mark_shard_dead(*dead)
        else:
            view = self.index
        self._view = view
        self.backend = resolve_backend(self.index.backend, view.device)
        # rung variants of the index, by their options: one instance a
        # variant, so a pipelined variant keeps its plans and streams
        self._variants: Tuple[Any, Dict[tuple, Any]] = (self.index, {})
        self._warmed = set()

    @property
    def n(self) -> int:
        return self.index.codes.shape[0]

    @property
    def device(self) -> torch.device:
        """Where queries go: the index's device, or the mesh's first."""
        return self._view.device

    @property
    def coverage(self) -> float:
        """The reachable share of the database's rows (1.0 unsharded or
        with no dead shard)."""
        return float(getattr(self._view, "coverage", 1.0))

    def mark_shard_dead(self, *shards: int) -> "AnnEngine":
        """Fail shards over (sharded engines only): later batches merge
        the surviving shards' top-k and report ``meta.coverage`` < 1."""
        if self.mesh is None:
            raise ValueError("mark_shard_dead needs a sharded engine "
                             "(AnnEngine(mesh=...))")
        self._view.mark_shard_dead(*shards)
        return self

    # ------------------------------------------------------------ ladder --
    def _levels(self) -> Tuple[str, ...]:
        """Rungs this engine serves, least to most degraded."""
        if self.mesh is not None:
            return ("full",)                 # sharded: full search only
        idx = self.index
        if isinstance(idx, FlatADC):
            return ("full", "crude")         # crude == full (no refine)
        # the fused engine ("cuda") has no capped rung, as the
        # reference's pallas engine has none
        capped = () if self.backend == "cuda" else ("capped",)
        if isinstance(idx, IVFTwoStep):
            return ("full",) + capped + ("probes", "crude")
        return ("full",) + capped + ("crude",)

    def _level_index(self, level: str, budget: SearchBudget):
        """The index variant serving one rung (``dataclasses.replace``:
        the tensors are shared, only options change), made once per
        option set for the index being served; a sharded engine serves
        its sharded view."""
        if self.mesh is not None:
            return self._view
        idx = self.index
        repl: Dict[str, Any] = {}
        if level == "capped":
            cap = (budget.refine_cap if budget.refine_cap is not None
                   else self.resilience.degraded_refine_cap)
            repl["refine_cap"] = (cap if cap is not None
                                  else max(4 * int(idx.topk), 64))
        if hasattr(idx, "n_probe"):
            n_probe = int(idx.n_probe)
            if level == "probes":
                n_probe = max(self.resilience.min_n_probe, n_probe // 2)
            if budget.max_n_probe is not None:
                n_probe = min(n_probe, budget.max_n_probe)
            n_probe = max(1, n_probe)
            if n_probe != int(idx.n_probe):
                repl["n_probe"] = n_probe
        if not repl:
            return idx
        if self._variants[0] is not idx:
            self._variants = (idx, {})
        key = tuple(sorted(repl.items()))
        variants = self._variants[1]
        if key not in variants:
            variants[key] = dataclasses.replace(idx, **repl)
        return variants[key]

    def _estimate_ms(self, level: str, order: Tuple[str, ...]):
        """Expected warm wall time of a rung: its own EMA, else the best
        measured less degraded rung as an upper bound (a more degraded
        rung never runs slower), else None (unknown)."""
        if level in self._ema:
            return self._ema[level]
        upper = [self._ema[lv] for lv in order[:order.index(level)]
                 if lv in self._ema]
        return min(upper) if upper else None

    def _pick_level(self, budget: SearchBudget) -> str:
        order = self._levels()
        if budget.force_level is not None:
            if budget.force_level not in order:
                raise ValueError(
                    f"force_level={budget.force_level!r} is not servable "
                    f"by this engine (available: {list(order)})")
            return budget.force_level
        if not budget.allow_refine:
            return "crude" if "crude" in order else order[-1]
        # hard caps promote their rung outright (no timing involved)
        floor = 0
        if budget.refine_cap is not None and "capped" in order:
            floor = max(floor, order.index("capped"))
        if (budget.max_n_probe is not None and "probes" in order
                and budget.max_n_probe < int(self.index.n_probe)):
            floor = max(floor, order.index("probes"))
        candidates = order[floor:]
        deadline = self._deadline(budget)
        if deadline is None:
            return candidates[0]
        # the least degraded rung whose estimate fits; a rung with no
        # estimate yet is taken (its measurement steers the next batch);
        # the crude floor is always eligible
        for name in candidates:
            est = self._estimate_ms(name, order)
            if est is None or est <= deadline:
                return name
        return candidates[-1]

    def _deadline(self, budget: SearchBudget):
        return (budget.deadline_ms if budget.deadline_ms is not None
                else self.resilience.deadline_ms)

    def _stages(self, level: str) -> Tuple[str, ...]:
        probe = ("probe",) if isinstance(self.index, IVFTwoStep) else ()
        if isinstance(self.index, FlatADC):
            return probe + ("adc",)
        if level == "crude":
            return probe + ("crude",)
        if level == "capped":
            return probe + ("crude", "refine-capped")
        return probe + ("crude", "refine")

    # ----------------------------------------------------------- serving --
    def _run_tiled(self, call, queries):
        """One call at the arrival shape, or (tile, d) zero-padded
        chunks with the pad rows sliced off; returns once the device
        has finished the batch."""
        tile = self.query_tile
        if tile is None:
            r = call(queries)
        else:
            nq = queries.shape[0]
            parts = [call(pad_to(queries[s:s + tile], tile))
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

    def _attempt(self, call, queries):
        if self.fault_injector is not None:
            self.fault_injector.check("engine.search")
        return self._run_tiled(call, queries)

    def _serve(self, level: str, k, budget: SearchBudget, queries,
               filter=None):
        """One batch at one rung: one attempt, then on a failure 1 +
        ``max_retries`` more in place under the backoff policy (the
        reference's ``_serve_with_failover`` count)."""
        lidx = self._level_index(level, budget)
        search = lidx.search_crude if level == "crude" else lidx.search

        def call(q):
            return search(q, k, filter=filter)

        def retry():
            self.stats["retries"] += 1
            return self._attempt(call, queries)

        res = self.resilience
        policy = BackoffPolicy(max_retries=res.max_retries,
                               base_ms=res.backoff_base_ms,
                               max_ms=res.backoff_max_ms)
        key = (level, k, getattr(lidx, "refine_cap", None),
               getattr(lidx, "n_probe", None), filter is not None,
               getattr(lidx, "dead_shards", None))
        try:
            return key, self._attempt(call, queries)
        except RuntimeError:
            return key, retry_with_backoff(retry, policy=policy,
                                           retryable=(RuntimeError,))

    def __call__(self, queries, budget: Optional[SearchBudget] = None):
        return self.search(queries, budget=budget)

    def search(self, queries, k: Optional[int] = None, *,
               budget: Optional[SearchBudget] = None, filter=None):
        """Serve one query batch ((nq, d) numpy or torch; moved to the
        index's device as f32); ``k`` overrides the index's ``topk``.
        ``budget`` bounds the batch: the engine picks the ladder rung
        that fits and reports it on ``result.meta``.  ``filter``: an
        optional (n,) bool row predicate (a jnp-engine option: the fused
        engine of an unsharded index on the card refuses it with the
        reference's words; absent slots are id -1 at distance +inf)."""
        if filter is not None and self.mesh is None and \
                self.backend == "cuda":
            raise ValueError(
                "filtered search requires backend='jnp' (the fused "
                "kernels cannot mask rows by predicate)")
        budget = validate_budget(budget) if budget is not None \
            else SearchBudget()
        level = self._pick_level(budget)
        deadline = self._deadline(budget)
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.array(queries, np.float32))
        # one layout: on the card the LUT product's rounding depends on
        # the operand strides (cuBLAS picks its kernel by them)
        queries = queries.to(self.device, torch.float32).contiguous()
        t0 = time.perf_counter()
        key, result = self._serve(level, k, budget, queries, filter)
        wall_ms = (time.perf_counter() - t0) * 1000.0
        # warm-only timing: a rung variant's first batch pays kernel
        # builds and allocator growth and would skew the estimates
        if key in self._warmed:
            prev = self._ema.get(level)
            self._ema[level] = wall_ms if prev is None else \
                (1 - _EMA_ALPHA) * prev + _EMA_ALPHA * wall_ms
        else:
            self._warmed.add(key)
        li = DEGRADE_LEVELS.index(level)
        coverage = self.coverage
        meta = ResultMeta(
            level=li, level_name=level, degraded=li > 0 or coverage < 1.0,
            stages=self._stages(level), wall_ms=wall_ms,
            deadline_ms=deadline,
            deadline_exceeded=deadline is not None and wall_ms > deadline,
            coverage=coverage, backend=self.backend)
        self.stats[level] = self.stats.get(level, 0) + 1
        if meta.degraded:
            self.stats["degraded"] += 1
        return result._replace(meta=meta)

    def warm(self, nq: int, k: Optional[int] = None, *,
             budget: Optional[SearchBudget] = None) -> "AnnEngine":
        """Serve one all-zero (nq, d) batch at the rung ``budget`` picks
        and mark that rung warm, so the first real batch finds the
        kernels built and loaded and the allocator warm, and its time
        feeds the ladder's estimates."""
        budget = validate_budget(budget) if budget is not None \
            else SearchBudget()
        level = self._pick_level(budget)
        d = int(self.index.C.shape[-1])
        zeros = torch.zeros((int(nq), d), dtype=torch.float32,
                            device=self.device)
        key, _ = self._serve(level, k, budget, zeros)
        self._warmed.add(key)
        return self

    def add(self, new_vectors, **encode_opts) -> "AnnEngine":
        """Grow the served index by ``new_vectors`` ((n_new, d), numpy or
        torch): ``Index.add`` with ``encode_opts`` (``icm_iters``,
        ``encode_backend``, ``point_chunk``) on the source index, sharded
        again over the mesh with the dead shards kept.  ``n`` and
        ``device`` follow the index; ``query_tile`` is unchanged.  The
        rungs' timings are measured anew.  Returns the engine."""
        self.index = self.index.add(new_vectors, **encode_opts)
        self._refresh()
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


def build_ann_engine(codes, C, structure, *, topk: int = 50,
                     backend: str = "auto", block_q=None, block_n=None,
                     query_chunk=None, index: str = "two-step", mesh=None,
                     emb_db=None, n_lists: int = 64, n_probe: int = 8,
                     refine_cap=None, generator=None,
                     lut_dtype: str = "f32", code_bits: int = 8,
                     pipeline: str = "off", pipeline_tile=None,
                     resilience: Optional[ResilienceConfig] = None,
                     fault_injector=None, device=None,
                     query_tile: Optional[int] = None) -> AnnEngine:
    """The kwarg front door: the kwargs fold into the config tree
    (``IndexConfig`` + ``ServeConfig``, validated there), the index is
    built by ``build_index`` on ``device`` (the card unless named) and
    served by an ``AnnEngine``.

    ``index`` picks the kind ("flat" | "two-step" | "ivf"); "ivf" also
    needs ``emb_db`` (the embeddings the codes encode) and takes
    ``n_lists``, ``n_probe`` and ``generator`` (the reference's ``key``:
    a ``torch.Generator`` or an int seed for the coarse k-means).
    ``block_q``/``block_n`` are validated and kept in the config only:
    the CUDA kernels choose their own tiles.  ``mesh`` (with a ``data``
    axis) serves the index sharded over it; the index is then built on
    the mesh's first device unless ``device`` names one.  ``pipeline``
    and ``pipeline_tile`` select the pipelined executor (item 7, done;
    a sharded engine serves ``pipeline="off"``)."""
    if mesh is not None and device is None:
        device = mesh.lead
    # n_lists / n_probe describe an IVF only; the flat kinds ignore them
    index_cfg = (IndexConfig(kind=index, n_lists=n_lists, n_probe=n_probe,
                             refine_cap=refine_cap, code_bits=code_bits)
                 if index == "ivf"
                 else IndexConfig(kind=index, refine_cap=refine_cap,
                                  code_bits=code_bits))
    serve_cfg = ServeConfig(topk=topk, backend=backend, lut_dtype=lut_dtype,
                            query_chunk=query_chunk, block_q=block_q,
                            block_n=block_n, pipeline=pipeline,
                            pipeline_tile=pipeline_tile)
    idx = build_index(codes, C, structure, index_cfg=index_cfg,
                      serve_cfg=serve_cfg, emb_db=emb_db,
                      generator=generator, device=device)
    return AnnEngine(idx, mesh=mesh, resilience=resilience,
                     fault_injector=fault_injector, query_tile=query_tile)


def load_ann_engine(path: str, *, mesh=None, device=None,
                    overrides: Optional[Dict[str, Any]] = None,
                    verify_checksums: Optional[bool] = None,
                    query_tile: Optional[int] = None,
                    fault_injector=None) -> AnnEngine:
    """Open a saved artifact directory as a serving engine on ``device``
    (the CUDA card unless named; with no card this raises).  ``mesh``
    shards the loaded index over its ``data`` axis, as
    ``build_ann_engine(mesh=)`` does; the index loads onto the mesh's
    first device unless ``device`` names one.

    ``overrides`` applies dotted config overrides before the index is
    rebuilt.  ``verify_checksums`` forces the per-tensor sha256 pass
    (None defers to the embedded ``resilience.verify_artifacts``).  The
    engine inherits the embedded ``ResilienceConfig``.  A model section
    is verified but not rebuilt: the engine serves embedded queries
    (``ICQSession.from_artifacts`` rebuilds the model)."""
    if mesh is not None and device is None:
        device = mesh.lead
    device = resolve_device(device)
    art = Artifacts.load(path, overrides=overrides,
                         verify_checksums=verify_checksums, device=device,
                         load_model=False)
    if art.index is None:
        raise ArtifactError(
            f"{path}: artifacts hold no index (model-only save); build "
            "one and save again")
    return AnnEngine(art.index, mesh=mesh,
                     resilience=art.config.resilience,
                     fault_injector=fault_injector, query_tile=query_tile)
