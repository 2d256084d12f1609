"""ICQ core pieces the serving path needs: the structure record,
codebook geometry and the stored code formats."""
from repro_torch.core.icq import ICQStructure

__all__ = ["ICQStructure"]
