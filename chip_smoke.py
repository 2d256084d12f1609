#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds the hand-written kernels
from this checkout, holds each against its plain PyTorch version on the
card, then serves the two-step search at SIFT1M geometry through the
port's own entry point (``load_ann_engine``) and checks what comes out.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--batches 3]

Needs one CUDA card; exits non-zero, printing no result, without one
or outside a checkout of the repository.  Phases:

1. card name and power limit (nvidia-smi), kernel build time and the
   compiler's ``-Xptxas -v`` report;
2. every kernel mode (crude: {f32, int8} x {8, 4 bit} x dense crude on
   or off; refine: {8, 4 bit}) on ragged shapes with duplicated code
   rows (exact ties), each equal bit for bit to its plain version;
3. each kernel at the main path's shape (64 queries x 1M points, K = 8,
   m = 256): time (CUDA events), the plain version's time, the least
   time the card could take (bytes or operations, whichever binds);
4. the main path: for two-step f32, two-step int8, flat f32 and a 4-bit
   index (K = 16, m = 16, int8 LUTs), a synthetic index made from
   ``--seed`` is saved with ``Artifacts.save``, loaded with
   ``load_ann_engine`` and served in 64-query tiles; every launch
   count is reset before and read after, and the served top-k must
   equal the plain composition run on the same CUDA tensors.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the f32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TOPK = 100
TILE = 64
SIFT = dict(d=128, K=8, m=256, num_fast=2)
# margin of the synthetic cells: with random codebooks at d = 128 the
# slow sum spreads over tens of distance units, and sigma = 10 lets
# about 1% of the points through the margin test (the reference
# synthetic index's 0.5 lets through about 0.05%, fewer than topk)
SIGMA = 10.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    """Least time for the work: the larger of bytes over the memory rate
    and f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal_outputs(got, want) -> bool:
    import torch
    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want))


# ------------------------------------------------------------ operands ----

def problem(seed, n, nq, K, m, d, num_fast, dup: bool):
    """Codes (n, K) uint8 with duplicated rows when ``dup``, f32 LUTs of
    random queries (built by the port), and the fast mask, on the card."""
    import torch
    from repro_torch.index.base import build_lut
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = torch.randn((K, m, d), generator=g, device="cuda") / K ** 0.5
    codes = torch.randint(0, m, (n, K), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    if dup:
        codes[n // 2:n // 2 + 9] = codes[3]
        codes[-7:] = codes[1]
    q = torch.randn((nq, d), generator=g, device="cuda")
    fast = torch.zeros((K,), dtype=torch.bool, device="cuda")
    fast[:num_fast] = True
    return codes, build_lut(q, C), fast


def stored_codes(codes, K, code_bits):
    from repro_torch.core.encode import pack_nibbles
    return pack_nibbles(codes, K).contiguous() if code_bits == 4 else codes


# ------------------------------------------------------- phase 2: modes ----

def check_modes(seed: int):
    """Every mode of both kernels equals its plain version bit for bit."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import crude_lut_operands, slow_lut_operand
    n, nq = 200_003, 67          # ragged against the 1024-point chunk
    for code_bits, K, m in ((8, 8, 256), (4, 7, 16)):
        codes, luts, fast = problem(seed + code_bits, n, nq, K, m, 32, 2,
                                    dup=True)
        stored = stored_codes(codes, K, code_bits)
        for lut_dtype in ("f32", "int8"):
            lut_flat, sc, of = crude_lut_operands(
                luts, fast, quantized=lut_dtype == "int8",
                code_bits=code_bits)
            for want_crude in (True, False):
                got = bs.crude_topk_cuda(stored, lut_flat, TOPK, sc, of,
                                         want_crude=want_crude,
                                         code_bits=code_bits)
                want = bs.crude_topk_torch(stored, lut_flat, TOPK, sc, of,
                                           want_crude=want_crude,
                                           code_bits=code_bits)
                torch.cuda.synchronize()
                ok = equal_outputs(got, want)
                log(f"mode crude {lut_dtype} {code_bits}-bit "
                    f"want_crude={want_crude}: "
                    f"{'equal' if ok else 'DIFFERENT'}")
                check(ok, f"crude kernel != plain version ({lut_dtype}, "
                          f"{code_bits}-bit, want_crude={want_crude})")
        lut_fast, _, _ = crude_lut_operands(luts, fast, quantized=False,
                                            code_bits=code_bits)
        crude = bs.crude_topk_torch(stored, lut_fast, TOPK,
                                    code_bits=code_bits)[0]
        lut_slow = slow_lut_operand(luts, fast, code_bits=code_bits)
        ranked = torch.sort(crude, dim=1).values
        for rank in (5000, 30):   # many survivors; fewer than topk
            thr = ranked[:, rank].contiguous()
            got = bs.refine_topk_cuda(stored, lut_slow, crude, thr, TOPK,
                                      code_bits=code_bits)
            want = bs.refine_topk_torch(stored, lut_slow, crude, thr, TOPK,
                                        code_bits=code_bits)
            torch.cuda.synchronize()
            ok = equal_outputs(got, want)
            log(f"mode refine {code_bits}-bit survivors/query~{rank}: "
                f"{'equal' if ok else 'DIFFERENT'}")
            check(ok, f"refine kernel != plain version ({code_bits}-bit, "
                      f"threshold at rank {rank})")


# ------------------------------------------------ phase 3: kernel times ----

def time_kernels(seed: int, n: int):
    """Both kernels at the main path's shape: times, plain times, bounds
    and the largest difference from the plain version."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands,
                                            slow_lut_operand)
    K, m, d = SIFT["K"], SIFT["m"], SIFT["d"]
    codes, luts, fast = problem(seed + 100, n, TILE, K, m, d,
                                SIFT["num_fast"], dup=False)
    sigma = torch.tensor(0.5, device="cuda")
    lut_flat, _, _ = crude_lut_operands(luts, fast, quantized=False)
    lut_slow = slow_lut_operand(luts, fast)
    records = {}

    crude_k = bs.crude_topk_cuda(codes, lut_flat, TOPK)
    crude_p = bs.crude_topk_torch(codes, lut_flat, TOPK)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(crude_k, crude_p))
    check(equal_outputs(crude_k, crude_p), "crude kernel != plain version "
          "at the main path's shape")
    ms = time_ms(lambda: bs.crude_topk_cuda(codes, lut_flat, TOPK), 20)
    plain_ms = time_ms(lambda: bs.crude_topk_torch(codes, lut_flat, TOPK), 3)
    nbytes = codes.numel() + lut_flat.numel() * 4 + TILE * n * 4 \
        + TILE * TOPK * 8
    b_ms, b_by = bound_ms(nbytes, TILE * n * K)
    records["crude_topk"] = dict(
        name="crude_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/batched_search.cu",
        replaces="src/repro/kernels/batched_search.py:168",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel crude_topk f32 8-bit nq={TILE} n={n}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err {err}")

    crude, cv, ci = crude_k
    thr = ThresholdStage(topk=TOPK).from_candidates(luts, codes, cv, ci,
                                                    fast, sigma)
    ref_k = bs.refine_topk_cuda(codes, lut_slow, crude, thr, TOPK)
    ref_p = bs.refine_topk_torch(codes, lut_slow, crude, thr, TOPK)
    check(equal_outputs(ref_k, ref_p), "refine kernel != plain version at "
          "the main path's shape")
    fin = torch.isfinite(ref_k[0])
    err = float((ref_k[0][fin].double() - ref_p[0][fin].double()).abs()
                .max()) if bool(fin.any()) else 0.0
    ms = time_ms(lambda: bs.refine_topk_cuda(codes, lut_slow, crude, thr,
                                             TOPK), 20)
    plain_ms = time_ms(lambda: bs.refine_topk_torch(codes, lut_slow, crude,
                                                    thr, TOPK), 3)
    survivors = int((crude < thr[:, None]).sum())
    nbytes = codes.numel() + lut_slow.numel() * 4 + TILE * n * 4 \
        + TILE * 4 + TILE * TOPK * 8
    # one compare per point, K adds and one add per survivor
    b_ms, b_by = bound_ms(nbytes, TILE * n + survivors * (K + 1))
    records["refine_topk"] = dict(
        name="refine_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/batched_search.cu",
        replaces="src/repro/kernels/batched_search.py:441",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel refine_topk 8-bit nq={TILE} n={n} survivors={survivors}: "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), max_abs_err {err}")

    # the other crude modes at their main-path shapes (printed only)
    lq, sc, of = crude_lut_operands(luts, fast, quantized=True)
    ms = time_ms(lambda: bs.crude_topk_cuda(codes, lq, TOPK, sc, of), 10)
    log(f"kernel crude_topk int8 8-bit nq={TILE} n={n}: {ms:.4f} ms")
    ms = time_ms(lambda: bs.crude_topk_cuda(codes, lut_flat, TOPK,
                                            want_crude=False), 10)
    log(f"kernel crude_topk f32 8-bit want_crude=False nq={TILE} n={n}: "
        f"{ms:.4f} ms")
    codes4, luts4, fast4 = problem(seed + 200, n, TILE, 16, 16, d, 4,
                                   dup=False)
    packed = stored_codes(codes4, 16, 4)
    lq4, sc4, of4 = crude_lut_operands(luts4, fast4, quantized=True,
                                       code_bits=4)
    ms = time_ms(lambda: bs.crude_topk_cuda(packed, lq4, TOPK, sc4, of4,
                                            code_bits=4), 10)
    log(f"kernel crude_topk int8 4-bit K=16 m=16 nq={TILE} n={n}: "
        f"{ms:.4f} ms")
    return records


# --------------------------------------------------- phase 4: main path ----

def plain_composition(index, q):
    """The served search composed by hand from the plain versions on the
    same CUDA tensors: (ids, distances)."""
    from repro_torch.index.base import build_lut
    from repro_torch.index.flat import FlatADC
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands,
                                            slow_lut_operand)
    quant = index.lut_dtype == "int8"
    bits, topk = index.code_bits, index.topk
    luts = build_lut(q, index.C)
    if isinstance(index, FlatADC):
        lf, sc, of = crude_lut_operands(luts, None, quantized=quant,
                                        code_bits=bits)
        _, vals, idx = bs.crude_topk_torch(index.codes, lf, topk, sc, of,
                                           want_crude=False, code_bits=bits)
        return idx, vals
    fast, sigma = index.structure.fast_mask, index.structure.sigma
    lf, sc, of = crude_lut_operands(luts, fast, quantized=quant,
                                    code_bits=bits)
    crude, cv, ci = bs.crude_topk_torch(index.codes, lf, topk, sc, of,
                                        code_bits=bits)
    thr = ThresholdStage(topk=topk, quantized=quant, code_bits=bits) \
        .from_candidates(luts, index.codes, cv, ci, fast, sigma)
    dist, idx = bs.refine_topk_torch(index.codes,
                                     slow_lut_operand(luts, fast,
                                                      code_bits=bits),
                                     crude, thr, topk, code_bits=bits)
    return idx, dist


def serve_cell(name, geometry, kind, lut_dtype, code_bits, *, seed, n,
               batches, workdir):
    """Save a synthetic index, load it with ``load_ann_engine`` and serve
    ``batches`` tiles of 64 queries.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.api import Artifacts, ICQConfig, build_index
    from repro_torch.api import load_ann_engine
    from repro_torch.data.synthetic import make_synthetic_index
    from repro_torch.kernels import ops

    g = geometry
    cfg = ICQConfig().with_overrides({
        "train.d": g["d"], "train.num_codebooks": g["K"],
        "train.codebook_size": g["m"], "train.num_fast": g["num_fast"],
        "index.kind": kind, "index.code_bits": code_bits,
        "serve.topk": TOPK, "serve.lut_dtype": lut_dtype})
    codes, C, structure = make_synthetic_index(
        seed, n, d=g["d"], K=g["K"], m=g["m"], num_fast=g["num_fast"],
        sigma=SIGMA)
    path = os.path.join(workdir, name)
    index = build_index(codes, C, structure, index_cfg=cfg.index,
                        serve_cfg=cfg.serve, device="cuda")
    Artifacts(config=cfg, index=index).save(path)
    del index
    engine = load_ann_engine(path, query_tile=TILE)
    engine.warm(TILE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 7)
    queries = [torch.from_numpy(rng.standard_normal((TILE, g["d"]),
                                                    dtype=np.float32)).cuda()
               for _ in range(batches)]
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    results = []
    t0 = time.perf_counter()
    start.record()
    for q in queries:
        results.append(engine.search(q))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / batches
    dev_ms = start.elapsed_time(end) / batches
    launches = dict(ops.LAUNCHES)

    want = {"crude_topk": batches,
            "refine_topk": 0 if kind == "flat" else batches}
    check(launches == want, f"{name}: launch counts {launches} != {want}")
    for r in results:
        check(tuple(r.indices.shape) == (TILE, TOPK)
              and tuple(r.distances.shape) == (TILE, TOPK),
              f"{name}: result shape {tuple(r.indices.shape)}")
        check(bool(((r.indices >= 0) & (r.indices < n)).all()),
              f"{name}: ids out of range")
        # a two-step row ends in +inf when fewer than topk points pass
        # the margin test; its nearest point always passes
        check(not bool(torch.isnan(r.distances).any())
              and bool(torch.isfinite(r.distances[:, 0]).all()),
              f"{name}: NaN or no finite distance in a row")
        check(bool((r.distances[:, 1:] >= r.distances[:, :-1]).all()),
              f"{name}: distances not ascending")
        check(r.meta.backend == "cuda", f"{name}: served by {r.meta.backend}")
    ids, dist = plain_composition(engine.index, queries[-1])
    same = (torch.equal(ids, results[-1].indices)
            and torch.equal(dist, results[-1].distances))
    check(same, f"{name}: served top-k != plain composition")
    r = results[-1]
    log(f"cell {name}: n={n} d={g['d']} K={g['K']} m={g['m']} "
        f"kind={kind} lut={lut_dtype} bits={code_bits} tile={TILE} "
        f"topk={TOPK}: batch {dev_ms:.4f} ms (events), "
        f"{host_ms:.4f} ms (host clock), {dev_ms * 1e3 / TILE:.3f} us/query;"
        f" pass_rate={float(r.pass_rate):.6f} "
        f"inf_slots={int(torch.isinf(r.distances).sum())} "
        f"avg_ops={float(r.avg_ops):.6f}; launches={launches}; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
        f"served == plain composition: {same}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database points of the main-path cells")
    ap.add_argument("--batches", type=int, default=3,
                    help="64-query batches served per cell")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    seconds, logs = build.build_all(verbose=True)
    log(f"kernels built in {seconds:.2f} s")
    for name, text in logs.items():
        log(f"--- nvcc -Xptxas -v: {name}.cu ---\n{text.strip()}")

    check_modes(args.seed)
    records = time_kernels(args.seed, args.n)

    cells = (("two-step-f32", SIFT, "two-step", "f32", 8),
             ("two-step-int8", SIFT, "two-step", "int8", 8),
             ("flat-f32", SIFT, "flat", "f32", 8),
             ("two-step-int8-4bit", dict(d=128, K=16, m=16, num_fast=4),
              "two-step", "int8", 4))
    total = {"crude_topk": 0, "refine_topk": 0}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as workdir:
        for cell in cells:
            launches = serve_cell(*cell, seed=args.seed, n=args.n,
                                  batches=args.batches, workdir=workdir)
            for k in total:
                total[k] += launches[k]
    for k, rec in records.items():
        check(total[k] > 0, f"{k} was never launched on the main path")
        rec["launches"] = total[k]

    log(json.dumps({"kernels": [records["crude_topk"],
                                records["refine_topk"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
