"""How far two runs of the port's joint trainer drift apart when one
starts from params perturbed by ``--eps`` relative (a stand-in for the
rounding by which the card and the CPU differ), at the Figure 1 full
protocol's widths: Table 1's dataset1, ``ICQConfig(d=16,
num_codebooks=8, codebook_size=256, num_fast=2)``, the linear embedder,
mode icq, batch 256, lr 1e-3.  Both runs take the same batch stacks.

Prints, for every step of ``--epochs`` epochs, the largest relative
difference of the loss terms and the global norm between the runs,
then each trained leaf's largest absolute difference beside its
magnitude and whether it holds to rtol 1e-4 (atol 1e-6 of the
magnitude), then ``finalize``'s structure and the share of database
rows with equal codes.  CPU only (``--threads`` CPU threads).

    PYTHONPATH=src python scripts/train_divergence.py [--eps 2e-7]
"""
import argparse

import torch

from repro_torch.configs import ICQConfig
from repro_torch.data import make_table1_dataset
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.trainer import (epoch_batches, finalize, init_train_state,
                                 make_train_step, run_epoch)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eps", type=float, default=2e-7)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    xtr, ytr, _, _ = make_table1_dataset("dataset1")
    xs, ys = torch.from_numpy(xtr), torch.from_numpy(ytr)
    cfg = ICQConfig(d=16, num_codebooks=8, codebook_size=256, num_fast=2)
    st = init_train_state(args.seed, cfg, d_raw=xs.shape[1], device="cpu",
                          sample_batch=(xs[:4096], ys[:4096]))
    gen = torch.Generator().manual_seed(args.seed + 1)
    stacks = [epoch_batches(gen, xs, ys, 256) for _ in range(args.epochs)]
    noise = torch.Generator().manual_seed(args.seed + 2)
    starts = (st["params"], tree_map(lambda t: t * (1 + args.eps * torch.randn(
        t.shape, generator=noise)), st["params"]))
    step = make_train_step(cfg, st["embed_apply"], st["opt"], "icq")
    runs = []
    for params in starts:
        mets = []

        def recorded(*a):
            out = step(*a)
            mets.append(out[3])
            return out
        opt_state = st["opt_state"]
        for xb, yb in stacks:
            params, opt_state, var_state, _ = run_epoch(recorded, params,
                                                        opt_state, xb, yb)
        runs.append((params, opt_state, var_state, mets))
    (pa, oa, va, ma), (pb, ob, vb, mb) = runs
    for i, (a, b) in enumerate(zip(ma, mb)):
        rel = {k: abs(float(a[k]) - float(b[k])) / max(abs(float(a[k])),
                                                        1e-30)
               for k in a if k != "psi_size"}
        worst = max(rel, key=rel.get)
        print(f"step {i}: largest relative difference {rel[worst]:.3e} "
              f"({worst}); psi_size {int(a['psi_size'])} "
              f"{int(b['psi_size'])}")
    for name, ta, tb in (("params", pa, pb), ("opt_state", oa, ob),
                         ("var_state", va, vb)):
        for j, (x, y) in enumerate(zip(tree_leaves(ta), tree_leaves(tb))):
            err = float((x.double() - y.double()).abs().max())
            scale = float(x.abs().max())
            ok = bool(torch.allclose(y, x, rtol=1e-4, atol=1e-6 * scale))
            print(f"{name} leaf {j} {tuple(x.shape)}: max abs diff "
                  f"{err:.3e}, magnitude {scale:.3e}, rtol 1e-4: {ok}")
    fa = finalize(pa, st["embed_apply"], va, cfg, xs)
    fb = finalize(pb, st["embed_apply"], vb, cfg, xs)
    print(f"finalize: xi equal {torch.equal(fa.structure.xi, fb.structure.xi)}"
          f", fast_mask equal "
          f"{torch.equal(fa.structure.fast_mask, fb.structure.fast_mask)}, "
          f"sigma {float(fa.structure.sigma)} {float(fb.structure.sigma)}, "
          f"rows with equal codes "
          f"{float((fa.codes == fb.codes).all(1).float().mean())}")


if __name__ == "__main__":
    main()
