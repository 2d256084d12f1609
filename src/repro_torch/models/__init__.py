"""The port's models (twin of ``repro.models``): the dense decoder LMs
and their module primitives."""
from repro_torch.models.transformer import build_model, ModelFns

__all__ = ["build_model", "ModelFns"]
