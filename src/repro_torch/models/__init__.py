"""The port's models (twin of ``repro.models``): the decoder LMs of
dense, MoE (``moe``), MLA (``mla``), SSM (``ssm``, Mamba-2) and hybrid
(``rglru`` with windowed local attention) layers and their module
primitives."""
from repro_torch.models.transformer import build_model, ModelFns

__all__ = ["build_model", "ModelFns"]
