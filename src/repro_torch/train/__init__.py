"""Optimizers of the port (twin of ``repro.train``)."""
from repro_torch.train.optimizer import (Adafactor, AdamW,
                                         clip_by_global_norm,
                                         cosine_schedule, global_norm,
                                         make_optimizer)

__all__ = ["AdamW", "Adafactor", "make_optimizer", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]
