"""ANN serving command of the port (twin of ``repro.launch.serve``'s
``--ann`` and ``--load-artifacts`` paths, flat, two-step and IVF kinds).

    # build a synthetic index from a seed, serve query batches on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \
        --ann-n 1000000 --ann-d 128 --ann-queries 64 --topk 100
    # the IVF index: a coarse k-means over the decoded database on the
    # card, 1024 lists, 8 probed per query
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \
        --ann-index ivf --ann-lists 1024 --ann-probe 8 --ann-n 1000000
    # the same on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --ann --device cpu \
        --ann-n 20000 --ann-queries 8
    # save, then serve the saved directory in a fresh process
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \
        --save-artifacts /path/ann && \
        PYTHONPATH=src python -m repro_torch.launch.serve \
        --load-artifacts /path/ann

Each batch's time comes from the host clock around work that ends in a
device synchronize (the engine synchronizes before it returns).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_batches(engine, nq: int, d: int, batches: int, label: str,
                  seed: int = 0):
    """Warm the engine at (nq, d), then serve ``batches`` random query
    batches and print per-query time, pass rate and Average Ops."""
    rng = np.random.default_rng(seed)
    engine.warm(nq)
    t0 = time.perf_counter()
    for _ in range(batches):
        res = engine(rng.standard_normal((nq, d), dtype=np.float32))
    dt = (time.perf_counter() - t0) / batches
    print(f"{label}: {dt * 1e6 / nq:.1f} us/query (batch {dt * 1e3:.2f} ms)"
          f", pass_rate={float(res.pass_rate):.4f}, "
          f"avg_ops={float(res.avg_ops):.3f}, device={engine.device}")
    return res


def serve_ann(cfg, n: int, nq: int, *, batches: int, device, seed: int,
              save_dir=None):
    """Build a synthetic index as ``cfg`` describes and serve it.  The
    IVF kind fits its coarse quantizer over the decoded database
    ``decode(C, codes)``, seeded with ``seed``."""
    import torch

    from repro_torch.api import AnnEngine, Artifacts, build_index
    from repro_torch.core.codebooks import decode
    from repro_torch.data.synthetic import make_synthetic_index
    from repro_torch.index.base import resolve_device

    t = cfg.train
    codes, C, structure = make_synthetic_index(
        seed, n, d=t.d, K=t.num_codebooks, m=t.codebook_size,
        num_fast=t.num_fast)
    device = resolve_device(device)
    emb_db = None
    if cfg.index.kind == "ivf":
        emb_db = decode(torch.from_numpy(C).to(device),
                        torch.from_numpy(codes).to(device))
    index = build_index(codes, C, structure, index_cfg=cfg.index,
                        serve_cfg=cfg.serve, emb_db=emb_db, generator=seed,
                        device=device)
    engine = AnnEngine(index, resilience=cfg.resilience, query_tile=nq)
    ivf = (f" lists={cfg.index.n_lists} probe={cfg.index.n_probe}"
           if cfg.index.kind == "ivf" else "")
    serve_batches(engine, nq, t.d, batches,
                  f"ann: index={cfg.index.kind}{ivf} n={n} d={t.d} "
                  f"K={t.num_codebooks} m={t.codebook_size} nq={nq} "
                  f"topk={cfg.serve.topk} lut={cfg.serve.lut_dtype} "
                  f"bits={cfg.index.code_bits}", seed=seed + 1)
    if save_dir:
        Artifacts(config=cfg, index=index).save(save_dir)
        print(f"ann: artifacts (config hash {cfg.config_hash()[:12]}) -> "
              f"{save_dir}; reload with --load-artifacts")


def serve_loaded(path: str, nq: int, *, batches: int, device, seed: int,
                 overrides=None, verify: bool = False):
    """Serve a saved artifact directory; artifact errors exit with a
    one-line message."""
    from repro_torch.api import ArtifactError, load_ann_engine

    try:
        engine = load_ann_engine(path, device=device,
                                 overrides=overrides or None,
                                 verify_checksums=verify or None,
                                 query_tile=nq)
    except (ArtifactError, OSError) as e:
        raise SystemExit(f"--load-artifacts {path}: {e}") from e
    d = int(engine.index.C.shape[-1])
    serve_batches(engine, nq, d, batches,
                  f"ann-loaded: {path} n={engine.n} d={d} nq={nq}",
                  seed=seed + 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ann", action="store_true",
                    help="build a synthetic index and serve it")
    ap.add_argument("--load-artifacts", default=None, metavar="DIR",
                    help="serve a saved artifact directory")
    ap.add_argument("--save-artifacts", default=None, metavar="DIR",
                    help="with --ann: save the built index")
    ap.add_argument("--verify-artifacts", action="store_true",
                    help="with --load-artifacts: check every tensor's "
                         "sha256 against the manifest")
    ap.add_argument("--config", default=None,
                    help="ICQConfig JSON driving the --ann run")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--ann-n", type=int, default=100_000)
    ap.add_argument("--ann-queries", type=int, default=64)
    ap.add_argument("--ann-index", default=None,
                    choices=["flat", "two-step", "ivf"],
                    help="override index.kind")
    ap.add_argument("--ann-lists", type=int, default=None,
                    help="override index.n_lists (ivf coarse cells)")
    ap.add_argument("--ann-probe", type=int, default=None,
                    help="override index.n_probe (ivf cells probed per "
                         "query)")
    ap.add_argument("--ann-d", type=int, default=None,
                    help="override train.d")
    ap.add_argument("--ann-k", type=int, default=None,
                    help="override train.num_codebooks")
    ap.add_argument("--ann-m", type=int, default=None,
                    help="override train.codebook_size")
    ap.add_argument("--topk", type=int, default=None,
                    help="override serve.topk")
    ap.add_argument("--lut-dtype", default=None, choices=["f32", "int8"],
                    help="override serve.lut_dtype")
    ap.add_argument("--code-bits", type=int, default=None, choices=[8, 4],
                    help="override index.code_bits (4 needs --ann-m <= 16)")
    args = ap.parse_args(argv)

    overrides = {k: v for k, v in {
        "index.kind": args.ann_index,
        "index.n_lists": args.ann_lists,
        "index.n_probe": args.ann_probe,
        "train.d": args.ann_d,
        "train.num_codebooks": args.ann_k,
        "train.codebook_size": args.ann_m,
        "serve.topk": args.topk,
        "serve.lut_dtype": args.lut_dtype,
        "index.code_bits": args.code_bits,
    }.items() if v is not None}
    if args.load_artifacts:
        for flag, val in (("--config", args.config),
                          ("--save-artifacts", args.save_artifacts),
                          ("--ann-index", args.ann_index)):
            if val is not None:
                ap.error(f"{flag} cannot be combined with --load-artifacts")
        serve_loaded(args.load_artifacts, args.ann_queries,
                     batches=args.batches, device=args.device,
                     seed=args.seed, overrides=overrides,
                     verify=args.verify_artifacts)
        return
    if not args.ann:
        ap.error("give --ann or --load-artifacts DIR")
    from repro_torch.api import ICQConfig

    cfg = ICQConfig.load(args.config) if args.config else ICQConfig()
    serve_ann(cfg.with_overrides(overrides), args.ann_n, args.ann_queries,
              batches=args.batches, device=args.device, seed=args.seed,
              save_dir=args.save_artifacts)


if __name__ == "__main__":
    main()
