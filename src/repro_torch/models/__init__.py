"""The port's models (twin of ``repro.models``): the decoder LMs of
dense, MoE (``moe``) and MLA (``mla``) layers and their module
primitives."""
from repro_torch.models.transformer import build_model, ModelFns

__all__ = ["build_model", "ModelFns"]
