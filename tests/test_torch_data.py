"""The port's data (``repro_torch.data``) against the reference's: the
pseudo-real generators and the array minibatcher are numpy-only copies,
so the same seed gives the reference's arrays bit for bit."""
import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro.data import pseudo_real as ref_pseudo
from repro_torch.data import (ArrayPipeline, pseudo_cifar, pseudo_glove,
                              pseudo_mnist, pseudo_sift, skewed_queries)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gen,kw", [
    (pseudo_mnist, dict(n_train=40, n_test=8, seed=3)),
    (pseudo_cifar, dict(n_train=40, n_test=8, seed=3)),
    (pseudo_sift, dict(n=500, n_queries=16, seed=3)),
    (pseudo_glove, dict(n=500, n_queries=16, seed=3)),
], ids=["mnist", "cifar", "sift", "glove"])
def test_pseudo_real_equal_reference(gen, kw):
    _equal(gen(**kw), getattr(ref_pseudo, gen.__name__)(**kw))


def test_skewed_queries_equal_reference():
    db, _, cid = pseudo_sift(n=600, n_queries=4, seed=1)
    _equal(skewed_queries(db, cid, 32, alpha=1.2, seed=2),
           ref_pseudo.skewed_queries(db, cid, 32, alpha=1.2, seed=2))


@pytest.mark.parametrize("hosts,drop", [(1, True), (2, True), (2, False)])
def test_array_pipeline_batches_equal_reference(hosts, drop):
    x = np.arange(103 * 3, dtype=np.float32).reshape(103, 3)
    y = np.arange(103, dtype=np.int32)
    for host in range(hosts):
        kw = dict(batch_size=16, num_hosts=hosts, host_id=host, seed=4,
                  drop_remainder=drop)
        port = ArrayPipeline(x, y, **kw)
        ref = ref_pipeline.ArrayPipeline(x, y, **kw)
        assert port.num_batches() == ref.num_batches()
        for epoch in range(2):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want)
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
