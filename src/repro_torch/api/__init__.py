"""``repro_torch.api``: the port's front door (twin of ``repro.api``).

  - **Config**: ``ICQConfig`` = ``TrainConfig`` + ``EncodeConfig`` +
    ``IndexConfig`` + ``ServeConfig`` + ``ResilienceConfig`` (the
    reference's schema and ``config_hash``).
  - **Lifecycle**: ``session = icq_session(config)``;
    ``session.fit(X, y, seed=0)``; ``searcher = session.index(db)``;
    ``searcher.search(q, k)``; ``searcher.save(path)``.
  - **Persistence**: ``Artifacts`` (the reference's layout, both
    ways), ``save_artifacts`` / ``load_artifacts``.
  - **Serving**: ``AnnEngine``, ``build_ann_engine``,
    ``load_ann_engine``, ``build_index``.
  - **Resilience**: ``SearchBudget`` / ``ResultMeta``, the
    ``FaultInjector`` harness.

Everything runs on the CUDA card unless the caller names a device.
"""
from repro_torch.api.artifacts import (FORMAT_VERSION, ArtifactError,
                                       Artifacts, index_from_numpy,
                                       load_artifacts, save_artifacts)
from repro_torch.api.config import (CHOICES, SCHEMA_VERSION, ConfigError,
                                    EncodeConfig, ICQConfig, IndexConfig,
                                    ResilienceConfig, ServeConfig,
                                    TrainConfig)
from repro_torch.api.serving import (AnnEngine, build_ann_engine,
                                     build_index, load_ann_engine)
from repro_torch.api.session import ICQSession, Searcher, icq_session
from repro_torch.resilience import (FaultInjector, FaultSpec, ResultMeta,
                                    SearchBudget)

__all__ = [
    # config tree
    "ICQConfig", "TrainConfig", "EncodeConfig", "IndexConfig",
    "ServeConfig", "ConfigError", "SCHEMA_VERSION", "CHOICES",
    # lifecycle
    "icq_session", "ICQSession", "Searcher",
    # persistence
    "Artifacts", "ArtifactError", "save_artifacts", "load_artifacts",
    "FORMAT_VERSION", "index_from_numpy",
    # serving
    "AnnEngine", "build_ann_engine", "build_index", "load_ann_engine",
    # resilience
    "ResilienceConfig", "SearchBudget", "ResultMeta", "FaultInjector",
    "FaultSpec",
]
