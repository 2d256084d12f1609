"""The trainer layer of the port (twin of ``repro.trainer``): the joint
ICQ trainer (init, step, finalize), its epoch loop and ``fit``, and the
tiled database encoder.

    from repro_torch.trainer import fit, encode_database
    model = fit(0, xs, ys, cfg, mode="icq", epochs=6)   # on the card
    model = fit(0, xs, ys, cfg, device="cpu")           # plain versions
    codes = encode_database(emb_new, model.C)           # packed uint8

``cfg`` is an ``ICQConfig`` (``repro_torch.configs``), e.g.
``TrainConfig(...).hyperparams()``.  The quantizer registry and the
PQ / OPQ / CQ baselines (``make_quantizer``), the data-parallel and the
checkpointed ``fit`` wait for ROADMAP.md queue 1 items 9b and 10.
"""
from repro_torch.trainer.base import ICQModel, Quantizer, plain_structure
from repro_torch.trainer.encode import encode_database
from repro_torch.trainer.epoch import epoch_batches, fit, run_epoch
from repro_torch.trainer.joint import (finalize, init_train_state,
                                       make_train_step,
                                       train_state_from_numpy)

__all__ = [
    "ICQModel", "Quantizer", "fit", "finalize", "init_train_state",
    "make_train_step", "run_epoch", "epoch_batches", "encode_database",
    "plain_structure", "train_state_from_numpy",
]
