"""The trainer layer of the port (twin of ``repro.trainer``).  This slice
holds the database encoder; the quantizers and the fit loop wait for
the training slice (ROADMAP.md, queue 1, item 9).

    from repro_torch.trainer import encode_database
    codes = encode_database(xs, C)          # on the card, packed uint8
"""
from repro_torch.trainer.encode import encode_database

__all__ = ["encode_database"]
