"""The port's configs (twin of ``repro.configs``): the ICQ
hyper-parameter record, the architecture configs of the ten archs and
their registry, and the input shapes."""
from repro_torch.configs.base import ArchConfig, ICQConfig, ShapeSpec
from repro_torch.configs.registry import get_config, list_archs, smoke_config
from repro_torch.configs.shapes import SHAPES, shapes_for, skipped_shapes_for

__all__ = [
    "ArchConfig", "ICQConfig", "ShapeSpec",
    "get_config", "list_archs", "smoke_config",
    "SHAPES", "shapes_for", "skipped_shapes_for",
]
