"""Data of the port (twin of ``repro.data``, numpy only): the Table-1
datasets, the pseudo-real stand-ins (MNIST, CIFAR, SIFT and GloVe
shaped), the LM token stream, the array minibatcher and the serving
paths' random index."""
from repro_torch.data.pipeline import ArrayPipeline, TokenPipeline
from repro_torch.data.pseudo_real import (pseudo_cifar, pseudo_glove,
                                          pseudo_mnist, pseudo_sift,
                                          skewed_queries)
from repro_torch.data.synthetic import (SYNTHETIC_DATASETS, guyon_dataset,
                                        make_synthetic_index,
                                        make_table1_dataset)

__all__ = [
    "guyon_dataset", "SYNTHETIC_DATASETS", "make_table1_dataset",
    "pseudo_mnist", "pseudo_cifar", "TokenPipeline", "ArrayPipeline",
    "pseudo_sift",
    "pseudo_glove", "skewed_queries", "make_synthetic_index",
]
