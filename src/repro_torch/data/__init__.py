"""Synthetic data of the port (twin of ``repro.data``): the Table-1
datasets and the serving paths' random index."""
from repro_torch.data.synthetic import (SYNTHETIC_DATASETS, guyon_dataset,
                                        make_synthetic_index,
                                        make_table1_dataset)

__all__ = ["SYNTHETIC_DATASETS", "guyon_dataset", "make_table1_dataset",
           "make_synthetic_index"]
