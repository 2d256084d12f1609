"""Joint embedding + quantizer training: a re-export of the trainer
layer (twin of ``repro.core.train``).  New code should import from
``repro_torch.trainer``."""
from repro_torch.trainer.base import ICQModel
from repro_torch.trainer.epoch import fit
from repro_torch.trainer.joint import (finalize, init_train_state,
                                       make_train_step)

__all__ = ["ICQModel", "fit", "finalize", "init_train_state",
           "make_train_step"]
