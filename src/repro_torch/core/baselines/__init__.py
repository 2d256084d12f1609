"""The baselines the paper compares against (twin of
``repro.core.baselines``).

Unsupervised quantizers: PQ (Jegou et al.), OPQ (Ge et al., a learned
rotation), CQ (Zhang et al., constant inner-product additive codes).
Supervised pipelines: SQ (Wang et al., linear embedding + CQ on the
joint trainer with the ICQ terms off) and PQN-style (Yu et al., CNN
embedding + soft-assign PQ with straight-through codes).  All return
``ICQModel`` artifacts, so every comparison calls one search API.
"""
from repro_torch.core.baselines.cq import fit_cq
from repro_torch.core.baselines.opq import fit_opq
from repro_torch.core.baselines.pq import fit_pq
from repro_torch.core.baselines.pqn import fit_pqn
from repro_torch.core.baselines.sq import fit_sq

__all__ = ["fit_pq", "fit_opq", "fit_cq", "fit_sq", "fit_pqn"]
