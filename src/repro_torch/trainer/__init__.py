"""The trainer layer of the port (twin of ``repro.trainer``): one
``Quantizer`` protocol (``init``/``step``/``finalize``), the joint ICQ
trainer and the PQ / OPQ / CQ baselines behind it, the epoch loop and
``fit`` (optionally checkpointed), and the tiled database encoder.

    from repro_torch.trainer import fit, make_quantizer, encode_database
    model = fit(0, xs, ys, cfg, mode="icq", epochs=6)   # on the card
    model = fit(0, xs, ys, cfg, device="cpu")           # plain versions
    q = make_quantizer("cq", cfg); st = q.init(0, xs)   # protocol
    codes = encode_database(emb_new, model.C)           # packed uint8

``cfg`` is an ``ICQConfig`` (``repro_torch.configs``), e.g.
``TrainConfig(...).hyperparams()``.  The reference's ``compile_epoch``
has no twin: it compiles an epoch into one ``lax.scan``, and the port's
epoch is the plain loop ``run_epoch``.  ``fit(mesh=)`` trains
data-parallel over a ``distributed.Mesh``'s ``data`` axis.
"""
from repro_torch.trainer.base import ICQModel, Quantizer, plain_structure
from repro_torch.trainer.encode import encode_database
from repro_torch.trainer.epoch import epoch_batches, fit, run_epoch
from repro_torch.trainer.joint import (finalize, init_train_state,
                                       make_train_step,
                                       train_state_from_numpy)
from repro_torch.trainer.quantizers import (CQQuantizer, JointQuantizer,
                                            OPQQuantizer, PQQuantizer,
                                            fit_cq, fit_opq, fit_pq)

QUANTIZER_KINDS = {
    "icq": lambda cfg, **o: JointQuantizer(cfg, mode="icq", **o),
    "sq": lambda cfg, **o: JointQuantizer(cfg, mode="cq", **o),
    "pqn": lambda cfg, **o: JointQuantizer(cfg, mode="pq", **o),
    "pq": PQQuantizer,
    "opq": OPQQuantizer,
    "cq": CQQuantizer,
}


def make_quantizer(kind: str, icq_cfg, **opts) -> Quantizer:
    """Build a quantizer by name: the joint trainer modes ("icq", "sq",
    "pqn") or the unsupervised baselines ("pq", "opq", "cq").  ``opts``
    are the quantizer's fields (``device`` among them)."""
    try:
        ctor = QUANTIZER_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown quantizer kind {kind!r}; expected one "
                         f"of {sorted(QUANTIZER_KINDS)}") from None
    return ctor(icq_cfg, **opts)


__all__ = [
    "ICQModel", "Quantizer", "QUANTIZER_KINDS", "JointQuantizer",
    "PQQuantizer", "OPQQuantizer", "CQQuantizer", "make_quantizer",
    "fit", "finalize", "init_train_state", "make_train_step",
    "run_epoch", "epoch_batches", "encode_database", "plain_structure",
    "fit_pq", "fit_opq", "fit_cq", "train_state_from_numpy",
]
