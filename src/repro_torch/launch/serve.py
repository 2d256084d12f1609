"""Serving command of the port (twin of ``repro.launch.serve``): the LMs
of every family (``--arch``: dense, MoE, MLA, SSM, hybrid, the
encoder-decoder and the VLM) and the ANN index (``--ann``,
``--load-artifacts`` and ``--serve-loop``; flat, two-step and IVF
kinds).

    # a dense LM at full width on the card, random weights from --seed:
    # prefill a seeded prompt batch (the flash kernel in every layer),
    # then greedy-decode; --icq-kv also decodes through the ICQ-KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --prompt-len 512 --decode-steps 32 --batch 8 --icq-kv
    # the MoE and MLA LMs the same way (on the card their full-width
    # configs do not fit in f32: serve_lm(scale_config(cfg)) serves them
    # in bf16); --icq-kv there runs the reference launcher's standalone
    # ICQ-KV demonstration on the arch's head geometry
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --smoke --device cpu --icq-kv
    # whisper: 1500 seeded audio frames a row through the encoder, the
    # prompt through the decoder (cross attention over the frames); the
    # VLM: 256 seeded patch embeddings before the text (--prompt-len
    # counts them)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --prompt-len 64 --decode-steps 8 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch internvl2-76b --smoke --device cpu --prompt-len 16
    # the reduced config on the CPU, through the plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --device cpu --prompt-len 32 --decode-steps 8 --batch 2

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

The LM path prints the prefill's time, the decode's time a token and
tokens per second (CUDA events on the card, the host clock on the CPU)
and the peak device memory.  Each ANN batch's time comes from the host
clock around work that ends in a device synchronize (the engine
synchronizes before it returns); so does the ``--ann-add`` time.  ``--serve-loop`` prints, per tenant, requests,
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


class _Clock:
    """Times of enclosed work: CUDA events on the card (read after one
    synchronize at the end), the host clock on the CPU."""

    def __init__(self, device):
        self.card = device.type == "cuda"
        self.spans = []

    def span(self, fn):
        import torch
        if self.card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self.spans.append((start, end))
        else:
            t0 = time.perf_counter()
            out = fn()
            self.spans.append(time.perf_counter() - t0)
        return out

    def ms(self) -> list:
        import torch
        if not self.card:
            return [1e3 * t for t in self.spans]
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.spans]


def icq_kv_geometry(cfg, max_len: int):
    """The ICQ-KV dials of the reference's decode cell
    (``launch/steps.py`` ``plan_icq_kv_cell``): d_fast = max(dh / 4, 16)
    and top_c = max(S / 16, 128), each at most its axis."""
    from repro_torch.quant import ICQKVConfig
    d_fast = min(max(cfg.head_dim // 4, 16), cfg.head_dim)
    return ICQKVConfig(d_fast=d_fast), min(max(max_len // 16, 128), max_len)


def icq_caches_from_prefill(kv_cfg, caches, s: int, max_len: int):
    """The ICQ-KV decode caches of every layer, quantized from the dense
    prefill's K/V at positions [0, s) (``build_icq_kv_cache``)."""
    import torch
    from repro_torch.quant import build_icq_kv_cache
    k, v = caches["seg0"]["k"], caches["seg0"]["v"]
    per = [build_icq_kv_cache(kv_cfg, k[li, :, :s], v[li, :, :s], max_len)
           for li in range(k.shape[0])]
    return {"pos": torch.tensor(s, dtype=torch.int32, device=k.device),
            "layers": {name: torch.stack([c[name] for c in per])
                       for name in per[0]}}


def lm_batch(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """The reference launcher's prompt batch, numpy arrays drawn from one
    ``np.random.default_rng(seed)`` in its order (so that both packages
    see the same inputs): ``tokens`` (batch, prompt_len, less the VLM's
    ``num_vision_tokens``) int32, then the VLM's ``patch_emb`` (batch,
    num_vision_tokens, vision_dim) and whisper's ``audio_emb`` (batch,
    encoder_seq_len, d_model), f32."""
    vis = cfg.num_vision_tokens if cfg.frontend == "vision_stub" else 0
    if prompt_len <= vis:
        raise ValueError(f"prompt_len={prompt_len} must exceed the "
                         f"{vis} vision tokens it counts")
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, prompt_len - vis), dtype=np.int32)}
    if vis:
        out["patch_emb"] = rng.standard_normal(
            (batch, vis, cfg.vision_dim)).astype(np.float32)
    if cfg.encdec:
        out["audio_emb"] = rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def serve_lm(cfg, *, prompt_len: int, decode_steps: int, batch: int,
             device=None, seed: int = 0, icq_kv: bool = False,
             icq_top_c=None, params=None, verbose: bool = True):
    """Serve an LM: draw its params from ``seed`` on the device (or take
    ``params``), prefill the prompt batch ``lm_batch(cfg, batch,
    prompt_len, seed)`` (the reference launcher's at seed 0; the VLM's
    ``prompt_len`` counts its vision tokens, and so does ``max_len``),
    then greedy-decode ``decode_steps`` tokens.  One untimed
    prefill at the same shape comes first (on the card: the kernel
    library, cuBLAS, the allocator).  With ``icq_kv`` the same steps
    run again through the ICQ-KV decode (``build_icq_decode``),
    its caches quantized from the prefill's K/V and fed the dense
    path's tokens, so that its logits compare step for step;
    ``icq_top_c`` overrides its survivor count (``icq_kv_geometry``).

    Returns a dict: ``prefill_ms``, ``decode_ms`` (median a step),
    ``tokens_per_s`` (batch / that median), ``peak_mib`` (None on the
    CPU), ``tokens`` (b, 1 + steps) numpy, ``logits`` (b, 1 + steps, V)
    f32 on the device (the prefill's last position, then each step's),
    ``launches`` (flash launches of the timed prefill, the encoder's and
    the cross attention's included, and of the decode steps) and, with
    ``icq_kv``, ``icq`` (its ``decode_ms``, ``max_logit_err`` and
    ``agree`` share against the dense steps, ``d_fast``, ``top_c`` and
    the cache ``bytes`` a step reads, dense and ICQ)."""
    import torch

    from repro_torch.index.base import resolve_device
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.steps import build_serve_fns
    from repro_torch.models.nn import as_dtype
    from repro_torch.quant.serve_icq import build_icq_decode

    device = resolve_device(device)
    card = device.type == "cuda"
    prefill_fn, decode_fn, model = build_serve_fns(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed))
    max_len = prompt_len + decode_steps
    tokens_in = {k: torch.from_numpy(a).to(device)
                 for k, a in lm_batch(cfg, batch, prompt_len, seed).items()}
    prefill_fn(params, tokens_in, max_len)              # warm, untimed
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    clock = _Clock(device)
    flash0 = LAUNCHES["flash_attention"]
    logits, caches = clock.span(
        lambda: prefill_fn(params, tokens_in, max_len))
    flash1 = LAUNCHES["flash_attention"]
    steps = [logits[:, -1].float()]
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    toks = [tok]
    for _ in range(decode_steps):
        logits, caches = clock.span(lambda: decode_fn(params, tok, caches))
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        steps.append(logits[:, -1].float())
        toks.append(tok)
    ms = clock.ms()
    out = dict(
        prefill_ms=ms[0], decode_ms=float(np.median(ms[1:])) if ms[1:]
        else None,
        peak_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                  if card else None),
        tokens=torch.cat(toks, dim=1).cpu().numpy(),
        logits=torch.stack(steps, dim=1),
        launches=dict(prefill=flash1 - flash0,
                      decode=LAUNCHES["flash_attention"] - flash1))
    out["tokens_per_s"] = (batch / out["decode_ms"] * 1e3
                           if out["decode_ms"] else None)
    if verbose:
        print(f"prefill: {prompt_len} tokens x {batch} in "
              f"{out['prefill_ms']:.3f} ms; logits "
              f"{tuple(out['logits'][:, 0].shape)}; flash launches "
              f"{out['launches']['prefill']}")
        if decode_steps:
            print(f"decode: {decode_steps} steps, {out['decode_ms']:.3f} ms"
                  f" a step (median), {out['tokens_per_s']:.1f} tokens/s; "
                  f"flash launches {out['launches']['decode']}")
        print("generated:", out["tokens"][:, :16])
        if card:
            print(f"peak device memory {out['peak_mib']:.1f} MiB")
    if icq_kv and decode_steps:
        kv_cfg, top_c = icq_kv_geometry(cfg, max_len)
        top_c = icq_top_c or top_c
        icq_decode, _ = build_icq_decode(cfg, kv_cfg)
        icq = icq_caches_from_prefill(kv_cfg, caches, prompt_len, max_len)
        del caches
        iclock = _Clock(device)
        got = []
        for i in range(decode_steps):
            logits, icq = iclock.span(lambda: icq_decode(
                params, toks[i], icq, top_c=top_c))
            got.append(logits[:, -1].float())
        got = torch.stack(got, dim=1)
        want = out["logits"][:, 1:]
        L, kvh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        dense_bytes = (L * batch * kvh * max_len * dh * 2
                       * torch.finfo(as_dtype(cfg.compute_dtype)).bits // 8)
        icq_bytes = L * batch * kvh * (max_len * kv_cfg.d_fast * 2
                                       + top_c * (dh * 2 + 2 * 4))
        out["icq"] = dict(
            decode_ms=float(np.median(iclock.ms())), d_fast=kv_cfg.d_fast,
            top_c=top_c,
            max_logit_err=float((got - want).abs().max()),
            agree=float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            bytes=dict(dense=dense_bytes, icq=icq_bytes))
        if verbose:
            r = out["icq"]
            print(f"icq-kv: d_fast={r['d_fast']} top_c={top_c}: "
                  f"{r['decode_ms']:.3f} ms a step (median); max logit err "
                  f"{r['max_logit_err']:.4f} against the dense steps, "
                  f"greedy tokens agree {r['agree']:.3f}; cache bytes a "
                  f"step {dense_bytes} -> {icq_bytes} "
                  f"({dense_bytes / icq_bytes:.1f}x less)")
    return out


def icq_kv_demo(cfg, *, batch: int, max_len: int, device=None,
                seed: int = 1):
    """The reference launcher's standalone ICQ-KV demonstration on
    ``cfg``'s head geometry, for an arch whose own decode has no dense
    KV cache to quantize (MoE, MLA): random K/V/q of ``max_len``
    positions from a generator seeded ``seed`` (other draws than the
    reference's ``PRNGKey(1)``), ICQ-KV attention at top_c = max(S / 8,
    4) against exact attention.  Prints the max error and the decode
    bytes a head, dense and ICQ (the reference's count)."""
    import torch

    from repro_torch.index.base import full_f32_matmul, resolve_device
    from repro_torch.quant import (ICQKVConfig, build_icq_kv_cache,
                                   icq_kv_decode_attention)
    from repro_torch.quant.kv_cache import reference_decode_attention

    dev = resolve_device(device)
    kvh, dh, S = max(cfg.num_kv_heads, 1), max(cfg.head_dim, 16), max_len
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn((batch, S, kvh, dh), generator=g, device=dev)
            for _ in range(2))
    q = torch.randn((batch, 1, cfg.num_heads or kvh, dh), generator=g,
                    device=dev)
    kv_cfg = ICQKVConfig(d_fast=max(dh // 4, 4))
    with full_f32_matmul():
        cache = build_icq_kv_cache(kv_cfg, k, v, max_len=S)
        out = icq_kv_decode_attention(q, cache, kv_cfg, S - 1,
                                      top_c=max(S // 8, 4))
        ref = reference_decode_attention(q, k, v, S - 1)
    err = float((out - ref).abs().max())
    raw = S * kvh * dh * 2 * 2                       # bf16 K+V
    icq = (S * kvh * kv_cfg.d_fast * 2               # crude reads
           + (S // 8) * kvh * dh * 2 * 1)            # int8 survivors
    print(f"icq-kv: max err {err:.4f}; decode HBM bytes/head "
          f"{raw} -> {icq} ({raw / icq:.1f}x less)")


def serve_arch(args):
    """``--arch``: the LM's config, ``serve_lm`` on it; an unknown arch
    exits with a one-line error.  ``--icq-kv`` on an arch ICQ-KV does
    not serve (MoE, MLA, SSM, hybrid, encoder-decoder, VLM) runs
    ``icq_kv_demo`` after the serving, as the reference launcher
    does."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.quant.serve_icq import supports_icq_kv

    try:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    except KeyError as e:
        raise SystemExit(f"--arch: {e.args[0]}") from e
    dense_kv = supports_icq_kv(cfg)
    serve_lm(cfg, prompt_len=args.prompt_len,
             decode_steps=args.decode_steps, batch=args.batch,
             device=args.device, seed=args.seed,
             icq_kv=args.icq_kv and dense_kv)
    if args.icq_kv and not dense_kv:
        icq_kv_demo(cfg, batch=args.batch,
                    max_len=args.prompt_len + args.decode_steps,
                    device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="serve this LM (configs.list_archs(); every arch "
                         "is ported)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the reduced config (smoke_config)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--icq-kv", action="store_true",
                    help="with --arch: also decode through the ICQ-KV "
                         "cache (crude scores over the high-variance key "
                         "dims, exact attention over the top survivors); "
                         "for an arch with no dense decoder-only KV cache "
                         "(MoE, MLA, SSM, hybrid, encoder-decoder, VLM) "
                         "the standalone demonstration on its head "
                         "geometry")
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
    ap.add_argument("--ann-backend", default=None,
                    choices=["auto", "jnp", "pallas"],
                    help="override serve.backend (on the card all three "
                         "run the CUDA kernels: auto and pallas as the "
                         "fused engine, jnp with filter= and refine_cap; "
                         "on the CPU the plain versions)")
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
        "serve.backend": args.ann_backend,
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
    if args.arch is not None:
        serve_arch(args)
        return
    if not args.ann:
        ap.error("give --arch, --ann or --load-artifacts DIR")
    from repro_torch.api import ICQConfig

    cfg = ICQConfig.load(args.config) if args.config else ICQConfig()
    serve_ann(cfg.with_overrides(overrides), args.ann_n, args.ann_queries,
              batches=args.batches, device=args.device, seed=args.seed,
              save_dir=args.save_artifacts, n_add=args.ann_add,
              shards=args.ann_shards)


if __name__ == "__main__":
    main()
