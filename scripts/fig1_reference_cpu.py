"""The JAX package's Figure 1 full protocol for one cell, on the CPU: the
yardstick that ``chip_smoke.py`` phase 11 prints beside the port's
trained model (a CPU run of the reference, not a target).

Table 1's dataset1 (10000 train / 1000 test rows, 64 features, 32
informative, seed 1), ``ICQConfig(d=16, num_codebooks=8,
codebook_size=256, num_fast=2)``, the linear embedder, mode icq, 10
epochs of batch 256 at lr 1e-3, key ``PRNGKey(8)`` (the key
``benchmarks/fig1_synthetic_pq.py`` gives K = 8); then the two-step
search of the test queries at topk 50 (``benchmarks/common.py``
``evaluate``, backend jnp).  Prints each epoch's loss terms, then one
JSON line: MAP@50, Average Ops, pass_rate and the fit's seconds
(compiles included).

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python scripts/fig1_reference_cpu.py
"""
import json
import time

import jax

from benchmarks.common import evaluate
from repro.configs.base import ICQConfig
from repro.data import make_table1_dataset
from repro.trainer import fit


def main():
    xtr, ytr, xte, yte = make_table1_dataset("dataset1")
    cfg = ICQConfig(d=16, num_codebooks=8, codebook_size=256, num_fast=2)
    t0 = time.time()
    model = fit(jax.random.PRNGKey(8), xtr, ytr, cfg, mode="icq", epochs=10,
                batch_size=256, lr=1e-3, verbose=True)
    fit_s = time.time() - t0
    mapv, ops, pr, _ = evaluate(model, xte, yte, ytr, topk=50)
    print(json.dumps({"map50": mapv, "avg_ops": ops, "pass_rate": pr,
                      "fit_s": fit_s, "device": jax.devices()[0].platform}))


if __name__ == "__main__":
    main()
