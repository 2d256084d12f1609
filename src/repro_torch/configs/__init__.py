"""The port's configs (twin of ``repro.configs``): the paper-level
hyper-parameter record ``ICQConfig``.  The architecture configs wait
for the LM side (ROADMAP.md, queue 1, item 11)."""
from repro_torch.configs.base import ICQConfig

__all__ = ["ICQConfig"]
