"""The port's front door (twin of ``repro.api`` for serving): the
config tree, persistent artifacts and the serving engine."""
from repro_torch.api.artifacts import (FORMAT_VERSION, ArtifactError,
                                       Artifacts, index_from_numpy)
from repro_torch.api.config import (CHOICES, SCHEMA_VERSION, ConfigError,
                                    EncodeConfig, ICQConfig, IndexConfig,
                                    ResilienceConfig, ServeConfig,
                                    TrainConfig)
from repro_torch.api.serving import (AnnEngine, build_ann_engine,
                                     build_index, load_ann_engine)

__all__ = [
    "ICQConfig", "TrainConfig", "EncodeConfig", "IndexConfig",
    "ServeConfig", "ResilienceConfig", "ConfigError", "SCHEMA_VERSION",
    "CHOICES", "Artifacts", "ArtifactError", "FORMAT_VERSION",
    "index_from_numpy", "AnnEngine", "build_ann_engine", "build_index",
    "load_ann_engine",
]
