"""Optimizers of the port (twin of ``repro.train``)."""
from repro_torch.train.optimizer import (AdamW, clip_by_global_norm,
                                         cosine_schedule, global_norm)

__all__ = ["AdamW", "cosine_schedule", "global_norm", "clip_by_global_norm"]
