"""ANN serving command of the port (twin of ``repro.launch.serve``'s
``--ann``, ``--load-artifacts`` and ``--serve-loop`` paths, flat,
two-step and IVF kinds).

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
    # then grow the served index by 128 vectors (ICM encode + append)
    PYTHONPATH=src python -m repro_torch.launch.serve --ann --device cpu \
        --ann-n 20000 --ann-queries 8 --ann-add 128
    # save, then serve the saved directory in a fresh process
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \
        --save-artifacts /path/ann && \
        PYTHONPATH=src python -m repro_torch.launch.serve \
        --load-artifacts /path/ann
    # the pipelined executor: crude of tile t+1 beside refine of tile t
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --load-artifacts /path/ann --pipeline tiles --pipeline-tile 64 \
        --ann-queries 512
    # the index sharded over a 4-way data mesh (four shards on one card
    # share it; with more cards they spread over them), or on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \
        --ann-index ivf --ann-shards 4 --ann-n 1000000
    PYTHONPATH=src python -m repro_torch.launch.serve --ann --device cpu \
        --ann-shards 4 --ann-n 20000 --ann-queries 8
    # two saved indexes as tenants of the coalescing serving loop under
    # 2 s of seeded Poisson traffic at 1000 requests/s
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-loop \
        --tenant a=/path/ann --tenant b=/path/ivf --serve-rate 1000 \
        --serve-duration 2 --batch-tile 32 --batch-window-ms 2

Each batch's time comes from the host clock around work that ends in a
device synchronize (the engine synchronizes before it returns); so does
the ``--ann-add`` time.  ``--serve-loop`` prints, per tenant, requests,
p50 and p99 end-to-end latency (host clock from submit to the result),
requests per second, mean tile fill and mean queue wait.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_mesh(shards: int, device=None):
    """``--ann-shards``: an N-way ``data`` mesh over the visible CUDA
    devices (each repeated over a block of shards when there are fewer
    than N), or over ``device`` when one is named; None for N <= 1."""
    if shards <= 1:
        return None
    from repro_torch.distributed.sharding import make_mesh_auto
    return make_mesh_auto((shards,), ("data",), devices=device)


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


def grow(engine, n_add: int, nq: int, seed: int):
    """``--ann-add``: ``n_add`` new vectors ``decode(C, random codes) +
    0.01 * noise`` from ``seed``, added to the engine (encode + append,
    no retraining), then one more batch served."""
    import torch

    from repro_torch.core.codebooks import decode

    C = engine.index.C
    K, m, d = C.shape
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, m, size=(n_add, K)))
    noise = torch.from_numpy(rng.standard_normal((n_add, d),
                                                 dtype=np.float32))
    new = decode(C, codes.to(C.device)) + 0.01 * noise.to(C.device)
    t0 = time.perf_counter()
    engine.add(new)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    res = engine(rng.standard_normal((nq, d), dtype=np.float32))
    print(f"ann-add: +{n_add} vectors in {dt * 1e3:.1f} ms (encode + "
          f"append, no retraining) -> n={engine.n}; post-add "
          f"pass_rate={float(res.pass_rate):.4f}")


def serve_ann(cfg, n: int, nq: int, *, batches: int, device, seed: int,
              save_dir=None, n_add: int = 0, shards: int = 1):
    """Build a synthetic index as ``cfg`` describes and serve it, then
    with ``n_add`` grow it (``grow``).  The IVF kind fits its coarse
    quantizer over the decoded database ``decode(C, codes)``, seeded
    with ``seed``.  ``save_dir`` saves the index the engine holds;
    ``shards`` > 1 serves it sharded (``serve_mesh``)."""
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
    engine = AnnEngine(index, serve_mesh(shards, device),
                       resilience=cfg.resilience, query_tile=nq)
    ivf = (f" lists={cfg.index.n_lists} probe={cfg.index.n_probe}"
           if cfg.index.kind == "ivf" else "")
    serve_batches(engine, nq, t.d, batches,
                  f"ann: index={cfg.index.kind}{ivf} n={n} d={t.d} "
                  f"K={t.num_codebooks} m={t.codebook_size} nq={nq} "
                  f"topk={cfg.serve.topk} lut={cfg.serve.lut_dtype} "
                  f"bits={cfg.index.code_bits} shards={shards}",
                  seed=seed + 1)
    if n_add > 0:
        grow(engine, n_add, nq, seed + 3)
    if save_dir:
        Artifacts(config=cfg, index=engine.index).save(save_dir)
        print(f"ann: artifacts (config hash {cfg.config_hash()[:12]}) -> "
              f"{save_dir}; reload with --load-artifacts")


def serve_loaded(path: str, nq: int, *, batches: int, device, seed: int,
                 overrides=None, verify: bool = False, shards: int = 1):
    """Serve a saved artifact directory; artifact errors exit with a
    one-line message."""
    from repro_torch.api import ArtifactError, load_ann_engine

    try:
        engine = load_ann_engine(path, mesh=serve_mesh(shards, device),
                                 device=device, overrides=overrides or None,
                                 verify_checksums=verify or None,
                                 query_tile=nq)
    except (ArtifactError, OSError) as e:
        raise SystemExit(f"--load-artifacts {path}: {e}") from e
    d = int(engine.index.C.shape[-1])
    serve_batches(engine, nq, d, batches,
                  f"ann-loaded: {path} n={engine.n} d={d} nq={nq} "
                  f"shards={shards}",
                  seed=seed + 1)


def serve_traffic(specs, *, rate_hz: float, duration_s: float,
                  window_ms=None, tile=None, overrides=None, seed: int = 0,
                  device=None, pool_q: int = 64, shards: int = 1):
    """``--serve-loop``: serve tenant artifact directories through the
    coalescing loop under a seeded Poisson workload and print each
    tenant's latency and throughput.  Spec conflicts and artifact
    errors exit with a one-line message."""
    from repro_torch.api import ArtifactError
    from repro_torch.serve import (ServeError, ServingLoop, load_tenants,
                                   make_workload, run_open_loop, summarize)

    try:
        tenants = load_tenants(specs, mesh=serve_mesh(shards, device),
                               overrides=overrides or None, device=device)
    except (ServeError, ArtifactError, OSError) as e:
        raise SystemExit(f"--serve-loop: {e}") from e
    rng = np.random.default_rng(seed)
    pools = {name: rng.standard_normal((pool_q, t.d)).astype(np.float32)
             for name, t in sorted(tenants.items())}
    workload = make_workload(pools, rate_hz, duration_s, rng=rng)
    with ServingLoop(tenants, window_ms=window_ms, tile=tile) as loop:
        for name in tenants:
            loop.warm(name)
        t0 = time.perf_counter()
        records = run_open_loop(loop, workload)
        wall_s = time.perf_counter() - t0
        stats = dict(loop.stats)
    for name in sorted(tenants):
        s = summarize([r for r in records if r["tenant"] == name],
                      wall_s=wall_s)
        if not s["requests"]:
            print(f"serve-loop[{name}]: no arrivals this run")
            continue
        print(f"serve-loop[{name}]: {s['requests']} req, "
              f"p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, "
              f"{s['qps']:.1f} qps, fill {s['mean_batch_fill']:.2f}, "
              f"queue {s['mean_queue_ms']:.2f} ms, device="
              f"{tenants[name].engine.device}")
    agg = summarize(records, wall_s=wall_s)
    print(f"serve-loop: {agg['requests']} req total, "
          f"{stats['batches']} flushes "
          f"(full {stats['flush_full']} / window {stats['flush_window']}), "
          f"p50 {agg['p50_ms']:.2f} ms, p99 {agg['p99_ms']:.2f} ms, "
          f"{agg['qps']:.1f} qps, degraded {agg['degraded_rate']:.2f}")
    return records


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
    ap.add_argument("--ann-add", type=int, default=0, metavar="N",
                    help="with --ann: after the timed batches, add N new "
                         "vectors to the served index and serve once more")
    ap.add_argument("--ann-queries", type=int, default=64)
    ap.add_argument("--ann-shards", type=int, default=1, metavar="N",
                    help="serve the index sharded over an N-way data mesh "
                         "(on the card's devices, or on --device)")
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
    ap.add_argument("--pipeline", default=None,
                    choices=["off", "tiles", "auto"],
                    help="override serve.pipeline (tiles: the crude pass "
                         "of one query tile beside the refine of the "
                         "previous, on two CUDA streams on the card)")
    ap.add_argument("--pipeline-tile", type=int, default=None,
                    help="override serve.pipeline_tile (queries per "
                         "pipeline tile; default 64 on the card, 16 on "
                         "the CPU)")
    ap.add_argument("--serve-loop", action="store_true",
                    help="serve artifact tenants through the coalescing "
                         "loop under a seeded Poisson workload")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME=DIR",
                    help="load an artifact directory as a named tenant of "
                         "the --serve-loop (repeatable); duplicate names "
                         "or paths are rejected up front")
    ap.add_argument("--batch-window-ms", type=float, default=None,
                    help="--serve-loop: override every tenant's "
                         "serve.batch_window_ms (max coalescing wait)")
    ap.add_argument("--batch-tile", type=int, default=None,
                    help="--serve-loop: override every tenant's "
                         "serve.batch_tile (rows per dispatched tile)")
    ap.add_argument("--serve-rate", type=float, default=50.0,
                    help="--serve-loop: Poisson arrival rate (req/s)")
    ap.add_argument("--serve-duration", type=float, default=1.0,
                    help="--serve-loop: workload duration (s)")
    ap.add_argument("--serve-seed", type=int, default=0,
                    help="--serve-loop: seed for arrivals and query rows")
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
        "serve.pipeline": args.pipeline,
        "serve.pipeline_tile": args.pipeline_tile,
    }.items() if v is not None}
    if args.serve_loop:
        specs = list(args.tenant)
        if args.load_artifacts:
            # a bare --load-artifacts joins the loop as tenant "default";
            # parse_tenant_specs catches a --tenant naming the same
            # directory (or reusing the name)
            specs = [f"default={args.load_artifacts}"] + specs
        if not specs:
            ap.error("--serve-loop needs at least one --tenant NAME=DIR "
                     "(or --load-artifacts DIR)")
        serve_traffic(specs, rate_hz=args.serve_rate,
                      duration_s=args.serve_duration,
                      window_ms=args.batch_window_ms, tile=args.batch_tile,
                      overrides=overrides, seed=args.serve_seed,
                      device=args.device, shards=args.ann_shards)
        return
    for flag, val in (("--tenant", args.tenant or None),
                      ("--batch-window-ms", args.batch_window_ms),
                      ("--batch-tile", args.batch_tile)):
        if val is not None:
            ap.error(f"{flag} requires --serve-loop")
    if args.load_artifacts:
        for flag, val in (("--config", args.config),
                          ("--save-artifacts", args.save_artifacts),
                          ("--ann-index", args.ann_index),
                          ("--ann-add", args.ann_add or None)):
            if val is not None:
                ap.error(f"{flag} cannot be combined with --load-artifacts")
        serve_loaded(args.load_artifacts, args.ann_queries,
                     batches=args.batches, device=args.device,
                     seed=args.seed, overrides=overrides,
                     verify=args.verify_artifacts, shards=args.ann_shards)
        return
    if not args.ann:
        ap.error("give --ann or --load-artifacts DIR")
    from repro_torch.api import ICQConfig

    cfg = ICQConfig.load(args.config) if args.config else ICQConfig()
    serve_ann(cfg.with_overrides(overrides), args.ann_n, args.ann_queries,
              batches=args.batches, device=args.device, seed=args.seed,
              save_dir=args.save_artifacts, n_add=args.ann_add,
              shards=args.ann_shards)


if __name__ == "__main__":
    main()
