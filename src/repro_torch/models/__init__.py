"""The port's models (twin of ``repro.models``): the LMs of dense, MoE
(``moe``), MLA (``mla``), SSM (``ssm``, Mamba-2) and hybrid (``rglru``
with windowed local attention) layers, the encoder-decoder (whisper:
a non-causal encoder, cross attention in ``attention``) and the VLM
(a projected patch-embedding stub before a dense backbone), and their
module primitives."""
from repro_torch.models.transformer import build_model, ModelFns

__all__ = ["build_model", "ModelFns"]
