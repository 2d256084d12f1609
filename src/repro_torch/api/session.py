"""The lifecycle facade of ``repro_torch.api`` (twin of
``repro.api.session``): one object that walks a config through fit ->
encode -> index -> search -> save, on the CUDA card unless the caller
names ``device="cpu"``.

    from repro_torch.api import ICQConfig, icq_session

    session = icq_session(ICQConfig.load("config.json"))
    model = session.fit(X, y, seed=0)     # ICQModel
    searcher = session.index()            # index over the fit data
    result = searcher.search(queries, k=10)
    searcher.save("artifacts/run0")       # fit -> save -> load -> search
                                          # is bit for bit (tested)

``fit`` dispatches on ``config.train.quantizer``: the joint trainer
modes ("icq", "sq", "pqn") run ``trainer.fit``; the baselines ("pq",
"opq", "cq") run the generic ``init``/``step``/``finalize`` loop, one
step an epoch.  ``index`` builds the configured index over the fit data
or a new database, and ``Searcher`` embeds raw-space queries with the
trained model before every search.  ``fit(mesh=)`` trains the joint
modes data-parallel over the mesh's ``data`` axis; ``index(mesh=)``
serves the index sharded over it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.api.artifacts import Artifacts
from repro_torch.api.config import JOINT_MODES, ConfigError, ICQConfig
from repro_torch.api.serving import AnnEngine, build_index
from repro_torch.index.base import as_torch, resolve_backend, resolve_device


class Searcher:
    """A trained model + a built index behind one query method.
    ``search`` takes *raw-space* queries (embedded with the session's
    model on the index's device); ``add`` grows the index from raw-space
    vectors without retraining; ``save`` persists model + index as one
    artifact directory (``repro_torch.api.artifacts``)."""

    def __init__(self, model, engine: AnnEngine, config: ICQConfig):
        self.model = model
        self.engine = engine
        self.config = config

    @property
    def index(self):
        """The served index (a frozen index dataclass)."""
        return self.engine.index

    @property
    def n(self) -> int:
        return self.engine.n

    def embed(self, queries) -> torch.Tensor:
        """Raw-space rows (numpy or torch) -> their embeddings on the
        index's device."""
        x = as_torch(queries).to(self.engine.device,
                                 torch.float32).contiguous()
        with torch.no_grad():
            return self.model.embed(x)

    def search(self, queries, k: Optional[int] = None, *, budget=None,
               filter=None):
        """Embed ``queries`` ((nq, ...) raw inputs) and search.  ``k``
        overrides ``config.serve.topk`` for this call; ``budget`` (a
        ``resilience.SearchBudget``) bounds the batch; ``filter`` (an
        (n,) boolean row predicate, plain versions only) restricts the
        results to rows where it is True.  Returns a ``SearchResult``
        whose ``meta`` reports what the engine did."""
        return self.engine.search(self.embed(queries), k, budget=budget,
                                  filter=filter)

    def add(self, new_x, **encode_opts) -> "Searcher":
        """Encode raw-space ``new_x`` through the model and the ICM
        engine and grow the index in place (no retraining); new rows get
        ids [n, n + n_new).  ``encode_opts`` (``icm_iters``,
        ``encode_backend``, ``point_chunk``) override the config's
        encode section for this call.  Returns ``self``."""
        opts = dict(icm_iters=self.config.encode.icm_iters,
                    encode_backend=self.config.encode.backend,
                    point_chunk=self.config.encode.point_chunk)
        opts.update(encode_opts)
        self.engine.add(self.embed(new_x), **opts)
        return self

    def save(self, path: str) -> str:
        """Persist config + model + index to ``path``; a fresh process
        reloads with ``load_ann_engine`` / ``ICQSession.from_artifacts``
        and serves identically."""
        return Artifacts(config=self.config, model=self.model,
                         index=self.engine.index).save(path)


class ICQSession:
    """The front door: holds a validated ``ICQConfig``, the device it
    runs on (the CUDA card unless ``device`` names another) and the
    state the lifecycle produces (fitted model, fit-data embeddings)."""

    def __init__(self, config: ICQConfig, *, device=None):
        if not isinstance(config, ICQConfig):
            raise ConfigError(
                f"icq_session needs an api ICQConfig, got "
                f"{type(config).__name__} (build one with "
                "repro_torch.api.ICQConfig or ICQConfig.load(path))")
        self.config = config
        self.device = device
        self.model = None                 # trainer.base.ICQModel after fit
        self._fit_emb = None              # embeddings of the fit data

    # -------------------------------------------------------------- fit --
    def fit(self, X, y=None, *, seed=0, mesh=None, verbose: bool = False):
        """Train the configured quantizer on ``X`` (+ optional labels
        ``y`` for the supervised embedding loss; zeros when omitted).

        seed:  an int or a ``torch.Generator``, threading init and
               shuffle (the reference's ``key``).
        mesh:  optional mesh with a "data" axis: data-parallel epochs
               for the joint trainer modes (``trainer.fit(mesh=)``),
               on the mesh's first device unless the session names one.

        Returns (and retains) the fitted ``ICQModel``; the fit data's
        embeddings are kept so ``index()`` can build over them without
        re-embedding."""
        cfg = self.config
        quantizer = cfg.train.quantizer
        if mesh is not None:
            if quantizer not in JOINT_MODES:
                raise ConfigError(
                    f"mesh-parallel fit is only wired for the joint "
                    f"trainer modes {sorted(JOINT_MODES)}, not "
                    f"{quantizer!r}")
        dev = resolve_device(self.device if self.device is not None
                             or mesh is None else mesh.lead)
        X = as_torch(X).to(dev, torch.float32).contiguous()
        y = (torch.zeros((X.shape[0],), dtype=torch.int32, device=dev)
             if y is None else as_torch(y).to(dev))
        hyper = cfg.train.hyperparams(icm_iters=cfg.encode.icm_iters)
        if quantizer in JOINT_MODES:
            from repro_torch.trainer import fit as trainer_fit

            self.model = trainer_fit(
                seed, X, y, hyper, mode=JOINT_MODES[quantizer],
                embed_kind=cfg.train.embed,
                num_classes=cfg.train.num_classes,
                img_hw=cfg.train.img_hw, channels=cfg.train.channels,
                epochs=cfg.train.epochs, batch_size=cfg.train.batch_size,
                lr=cfg.train.lr, tau=cfg.train.tau, verbose=verbose,
                mesh=mesh, encode_batch=cfg.encode.chunk,
                encode_backend=cfg.encode.backend, device=dev)
        else:
            from repro_torch.trainer import make_quantizer

            q = make_quantizer(quantizer, hyper, device=dev)
            state = q.init(seed, X, y)
            for _ in range(cfg.train.epochs):
                state = q.step(state, (X, y))
            self.model = q.finalize(state, X)
        with torch.no_grad():
            self._fit_emb = self.model.embed(X)
        return self.model

    # ------------------------------------------------------------ index --
    def _db_codes(self, db):
        """(codes, embeddings) of the database: the fit data's when
        ``db`` is None (the codes ``fit`` exported), else ``db``
        embedded and encoded through ``encode_database``."""
        if db is None:
            return self.model.codes, self._fit_emb
        from repro_torch.trainer import encode_database

        cfg = self.config
        dev = self.model.C.device
        with torch.no_grad():
            emb_db = self.model.embed(
                as_torch(db).to(dev, torch.float32).contiguous())
        codes = encode_database(
            emb_db, self.model.C,
            mode="pq" if self.model.mode == "pq" else "icm",
            icm_iters=cfg.encode.icm_iters, chunk=cfg.encode.chunk,
            backend=cfg.encode.backend, device=dev)
        return codes, emb_db

    def index(self, db=None, *, mesh=None, seed=None) -> Searcher:
        """Build the configured index and wrap it with the model into a
        ``Searcher``.

        db:    optional (n, ...) raw-space database to index; ``None``
               indexes the fit data (reusing the codes ``fit``
               exported, no re-encode).
        mesh:  optional mesh with a "data" axis for sharded serving.
        seed:  seeds the IVF coarse k-means (default 0).
        """
        if self.model is None:
            raise ConfigError("session.index() before session.fit(); fit "
                              "a model first (or load artifacts with "
                              "ICQSession.from_artifacts)")
        cfg = self.config
        codes, emb_db = self._db_codes(db)
        idx = build_index(codes, self.model.C, self.model.structure,
                          index_cfg=cfg.index, serve_cfg=cfg.serve,
                          emb_db=emb_db,
                          generator=0 if seed is None else seed,
                          device=self.model.C.device)
        return Searcher(self.model, AnnEngine(idx, mesh=mesh), cfg)

    # ------------------------------------------------------------- tune --
    def _tuning_structure(self, num_fast: int):
        """The trained structure with the fast set re-selected to
        ``num_fast`` codebooks over the same trained codebooks and psi
        split, so |K_fast| is sweepable without retraining."""
        st = self.model.structure
        if int(st.fast_mask.sum()) == num_fast:
            return st
        from repro_torch.core import icq as icq_mod

        mask = icq_mod.fast_set_topk(self.model.C, st.xi, num_fast)
        return st._replace(fast_mask=mask)

    def _tune_grid(self) -> List[Dict[str, Any]]:
        """Coarse candidate grid of dotted config overrides for the
        configured index kind: search-time knobs only, so every
        candidate is a ``dataclasses.replace`` of one built index."""
        cfg = self.config
        K = cfg.train.num_codebooks
        kind = cfg.index.kind
        if kind == "flat":
            return [{}, {"serve.lut_dtype": "int8"},
                    {"serve.pipeline": "tiles"}]
        nf_opts = sorted({max(1, K // 2), K - 1})
        grid: List[Dict[str, Any]] = []
        if kind == "ivf":
            probes, p = [], 1
            while p < cfg.index.n_lists:
                probes.append(p)
                p *= 4
            probes.append(cfg.index.n_lists)
            for np_ in probes:
                for nf in nf_opts:
                    grid.append({"index.n_probe": np_,
                                 "train.num_fast": nf})
        else:                                            # two-step
            # refine_cap is a jnp-engine option: the fused engine (auto |
            # pallas on the card) refuses it, so it is a candidate only
            # where the engine serves it (the reference's grid lists it
            # under every backend, and its pallas engine then raises)
            capped = resolve_backend(self.config.serve.backend,
                                     self.model.C.device) != "cuda"
            for nf in nf_opts:
                grid.append({"train.num_fast": nf})
                if capped:
                    grid.append({"train.num_fast": nf,
                                 "index.refine_cap":
                                     max(4 * cfg.serve.topk, 64)})
            grid.append({"train.num_fast": nf_opts[0],
                         "serve.lut_dtype": "int8"})
        # the pipelined executor is a scheduling knob (same results,
        # other wall time): one candidate at the default operating point
        grid.append({"serve.pipeline": "tiles"})
        return grid

    def _refine_candidates(self, best_ov: Dict[str, Any]):
        """Local refinement around the coarse winner: neighbouring
        n_probe values and num_fast +/- 1."""
        cfg = self.config
        out: List[Dict[str, Any]] = []
        if cfg.index.kind == "ivf":
            np0 = best_ov.get("index.n_probe", cfg.index.n_probe)
            for np_ in sorted({max(1, (3 * np0) // 4),
                               np0 + max(1, np0 // 2)}):
                if 1 <= np_ <= cfg.index.n_lists and np_ != np0:
                    out.append({**best_ov, "index.n_probe": np_})
        if cfg.index.kind != "flat":
            nf0 = best_ov.get("train.num_fast", cfg.train.num_fast)
            for nf in (nf0 - 1, nf0 + 1):
                if 1 <= nf <= cfg.train.num_codebooks - 1 and nf != nf0:
                    out.append({**best_ov, "train.num_fast": nf})
        return out

    def _measure_point(self, ov: Dict[str, Any], base_idx, q_emb,
                       gt_ids, k: int, repeats: int) -> Dict[str, Any]:
        """Recall@k and QPS (min-of-repeats warm timing, ending in a
        synchronize on the card) of one override candidate, served by a
        direct call of a ``dataclasses.replace`` of the built index."""
        from repro_torch import eval as eval_mod

        self.config.with_overrides(ov)       # validate the candidate
        repl: Dict[str, Any] = {}
        if "train.num_fast" in ov:
            repl["structure"] = self._tuning_structure(
                ov["train.num_fast"])
        if "index.n_probe" in ov:
            repl["n_probe"] = ov["index.n_probe"]
        if "index.refine_cap" in ov:
            repl["refine_cap"] = ov["index.refine_cap"]
        if "serve.lut_dtype" in ov:
            repl["lut_dtype"] = ov["serve.lut_dtype"]
        if "serve.pipeline" in ov:
            repl["pipeline"] = ov["serve.pipeline"]
        if "serve.pipeline_tile" in ov:
            repl["pipeline_tile"] = ov["serve.pipeline_tile"]
        idx = dataclasses.replace(base_idx, **repl) if repl else base_idx

        def call():
            r = idx.search(q_emb, k)
            if q_emb.is_cuda:
                torch.cuda.synchronize(q_emb.device)
            return r

        r = call()                           # build + warm
        recall = eval_mod.recall_at_k(r.indices[:, :k].cpu().numpy(),
                                      gt_ids, k)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        qps = q_emb.shape[0] / max(best, 1e-9)
        return {"overrides": dict(ov), "recall": recall, "qps": qps}

    def tune(self, db=None, queries=None, *, target_recall: float = 0.9,
             k: int = 10, grid: Optional[List[Dict[str, Any]]] = None,
             repeats: int = 3, cache_dir: Optional[str] = None,
             seed=None, apply: bool = True) -> ICQConfig:
        """Autotune the search-time knobs to ``target_recall`` at max
        QPS and return the tuned ``ICQConfig``.

        Measures recall@``k`` against the exact (cached) ground truth
        (``eval.cached_ground_truth`` on the model's device) and warm
        QPS for a coarse grid of candidates over the knobs the
        configured index kind exposes (n_probe, num_fast, refine_cap,
        lut_dtype, pipeline), then refines locally around the winner.
        Selection: the max-QPS point with recall >= ``target_recall``,
        else the max-recall point (the sweep is kept on
        ``self.last_tune``).

        db:       raw-space database to tune over (None = the fit data,
                  reusing the codes ``fit`` exported).
        queries:  raw-space query sample (required).
        grid:     explicit override-dict candidates; None = the kind's
                  default coarse grid.
        cache_dir:  ground-truth npz cache directory (content-keyed).
        seed:     seeds the IVF coarse k-means (default 0).
        apply:    adopt the tuned config on this session (and re-select
                  the fast set when the winning num_fast differs), so a
                  following ``index()`` + ``save`` persist it.
        """
        if self.model is None:
            raise ConfigError("session.tune() before session.fit(); fit "
                              "a model first (or load artifacts with "
                              "ICQSession.from_artifacts)")
        if queries is None:
            raise ConfigError("session.tune() needs queries= (a raw-space "
                              "query sample to measure recall/QPS on)")
        from repro_torch import eval as eval_mod

        cfg = self.config
        dev = self.model.C.device
        codes, emb_db = self._db_codes(db)
        with torch.no_grad():
            q_emb = self.model.embed(as_torch(queries).to(dev,
                                                          torch.float32))
        gt_ids, _, _ = eval_mod.cached_ground_truth(
            emb_db.cpu().numpy(), q_emb.cpu().numpy(), k,
            cache_dir=cache_dir, device=dev)
        base_idx = build_index(
            codes, self.model.C, self.model.structure,
            index_cfg=cfg.index, serve_cfg=cfg.serve, emb_db=emb_db,
            generator=0 if seed is None else seed, device=dev)

        points: List[Dict[str, Any]] = []
        seen = set()

        def measure(ov):
            sig = tuple(sorted(ov.items()))
            if sig in seen:
                return
            seen.add(sig)
            points.append(self._measure_point(ov, base_idx, q_emb,
                                              gt_ids, k, repeats))

        for ov in (grid if grid is not None else self._tune_grid()):
            measure(ov)
        sel, _ = eval_mod.select_operating_point(points, target_recall)
        for ov in self._refine_candidates(points[sel]["overrides"]):
            measure(ov)
        sel, met = eval_mod.select_operating_point(points, target_recall)
        best = points[sel]
        frontier = eval_mod.pareto_frontier(points)
        tuned = cfg.with_overrides(best["overrides"])
        self.last_tune = {
            "points": points,
            "frontier": [points[i] for i in frontier],
            "selected": best, "met_target": met,
            "target_recall": target_recall, "k": k,
        }
        if apply:
            self.config = tuned
            nf = tuned.train.num_fast
            if int(self.model.structure.fast_mask.sum()) != nf:
                self.model.structure = self._tuning_structure(nf)
                self.model.icq_cfg = dataclasses.replace(
                    self.model.icq_cfg, num_fast=nf)
        return tuned

    # ------------------------------------------------------------- save --
    def save(self, path: str) -> str:
        """Persist the fitted model (no index); ``Searcher.save``
        persists model + index together."""
        if self.model is None:
            raise ConfigError("session.save() before session.fit()")
        return Artifacts(config=self.config, model=self.model).save(path)

    @classmethod
    def from_artifacts(cls, path: str, *, device=None) -> "ICQSession":
        """Rebuild a session (config + fitted model) from saved
        artifacts on ``device`` (the card unless named); ``index()``
        then works as after ``fit`` (for a saved index, prefer
        ``load_ann_engine``: it serves the stored index directly)."""
        art = Artifacts.load(path, device=resolve_device(device))
        if art.model is None:
            raise ConfigError(
                f"{path}: artifacts hold no model (index-only save); "
                "serve them with repro_torch.api.load_ann_engine instead")
        session = cls(art.config, device=device)
        session.model = art.model
        return session


def icq_session(config: ICQConfig, *, device=None) -> ICQSession:
    """Open the front door: validate ``config`` and return an
    ``ICQSession`` on ``device`` (the CUDA card unless named)."""
    return ICQSession(config, device=device)
