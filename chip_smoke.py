#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds the hand-written kernels
from this checkout, holds each against its plain PyTorch version on the
card, then builds and serves the flat, two-step and IVF indexes at
SIFT1M geometry through the port's own entry points (``build_index``,
``load_ann_engine``) and checks what comes out.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--batches 3] \
        [--profile DIR]

Needs one CUDA card; exits non-zero, printing no result, without one
or outside a checkout of the repository.  Phases:

1. card name and power limit (nvidia-smi), kernel build time and the
   compiler's ``-Xptxas -v`` report;
2. every kernel mode on ragged shapes, each equal bit for bit to its
   plain version: flat crude {f32, int8} x {8, 4 bit} x dense crude on
   or off and flat refine {8, 4 bit}, with duplicated code rows (exact
   ties); slab crude {f32, int8} x {8, 4 bit} and slab refine {8, 4
   bit} with many survivors and with fewer than topk, on slabs with -1
   holes, duplicated rows and one query slab thinner than topk; and
   ``kmeans_assign`` (L = 8193 centroids, one duplicated) against its
   plain version: ids equal wherever the two nearest scores are apart
   by more than 1e-5 of the terms' size, distances to rtol 1e-5;
3. the flat kernels at the main path's shape (64 queries x 1M points,
   K = 8, m = 256): time (CUDA events), the plain version's time, the
   least time the card could take (bytes or operations, whichever
   binds);
4. the flat main path: for two-step f32, two-step int8, flat f32 and a
   4-bit index (K = 16, m = 16, int8 LUTs), a synthetic index made
   from ``--seed`` is saved with ``Artifacts.save``, loaded with
   ``load_ann_engine`` and served in 64-query tiles; every launch
   count is reset before and read after, and the served top-k must
   equal the plain composition run on the same CUDA tensors;
5. the IVF path at Jegou et al.'s IVFADC setting (k' = 1024 coarse
   cells, w = 8 probes, 20 k-means iterations): ``build_index`` fits
   the coarse k-means on the card over ``decode(C, codes)`` (launch
   counts reset before and read after the build), a second build from
   the same seed must give identical lists and centroids, and the
   saved index serves the cells ivf-f32, ivf-int8 (the same artifact
   with ``serve.lut_dtype`` overridden) and ivf-int8-4bit (K = 16,
   m = 16) as in phase 4.  The three IVF kernels are then timed as in
   phase 3 at the served shape: the slab of one served tile, and the
   build's 1M points against its 1024 centroids (with the two-call
   library yardstick ``argmin(addmm)`` beside ``kmeans_assign``).

With ``--profile DIR``, five more tiles of the two-step-f32 and ivf-f32
cells run under ``torch.profiler`` after their counted windows: the
device busy time and idle share per tile, the ops by device and host
time, and a Chrome trace per cell in DIR.

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
# about 0.3% of the points through the margin test (measured pass_rate
# 0.0029 on the flat cells; the reference synthetic index's 0.5 lets
# through fewer than topk)
SIGMA = 10.0
# the IVF cells follow Jegou et al.'s IVFADC setting on SIFT1M:
# k' = 1024 coarse cells, w = 8 probed per query, 20 Lloyd iterations
IVF = dict(n_lists=1024, n_probe=8, kmeans_iters=20)


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


def slab_problem(seed, nq, nc, K, m, d, num_fast):
    """A ragged candidate slab on the card: codes (nq, nc, K) uint8 with
    duplicated rows (exact ties), ids with -1 holes in every row and a
    query (row 1) with fewer valid columns than topk, f32 LUTs of random
    queries and the fast mask."""
    import torch
    from repro_torch.index.base import build_lut
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = torch.randn((K, m, d), generator=g, device="cuda") / K ** 0.5
    codes = torch.randint(0, m, (nq, nc, K), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    codes[:, 500:509] = codes[:, 3:4]
    codes[:, -7:] = codes[:, 1:2]
    ids = torch.randint(0, 1 << 30, (nq, nc), generator=g, device="cuda",
                        dtype=torch.int32)
    ids[torch.rand((nq, nc), generator=g, device="cuda") < 0.2] = -1
    ids[1, TOPK // 3:] = -1
    q = torch.randn((nq, d), generator=g, device="cuda")
    fast = torch.zeros((K,), dtype=torch.bool, device="cuda")
    fast[:num_fast] = True
    return codes, ids, build_lut(q, C), fast


def check_slab_modes(seed: int):
    """Every mode of both slab kernels equals its plain version bit for
    bit on ragged slabs."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import crude_lut_operands, slow_lut_operand
    nq, nc = 37, 9_001           # ragged against the 1024-row chunk
    for code_bits, K, m in ((8, 8, 256), (4, 7, 16)):
        codes, ids, luts, fast = slab_problem(seed + 10 + code_bits, nq, nc,
                                              K, m, 32, 2)
        stored = stored_codes(codes, K, code_bits)
        for lut_dtype in ("f32", "int8"):
            lut_flat, sc, of = crude_lut_operands(
                luts, fast, quantized=lut_dtype == "int8",
                code_bits=code_bits)
            got = bs.ivf_crude_topk_cuda(stored, ids, lut_flat, TOPK, sc, of,
                                         code_bits=code_bits)
            want = bs.ivf_crude_topk_torch(stored, ids, lut_flat, TOPK, sc,
                                           of, code_bits=code_bits)
            torch.cuda.synchronize()
            ok = equal_outputs(got, want)
            thin = bool(torch.isinf(got[1][1, TOPK // 3:]).all())
            log(f"mode ivf_crude {lut_dtype} {code_bits}-bit: "
                f"{'equal' if ok else 'DIFFERENT'}; thin slab's +inf tail: "
                f"{thin}")
            check(ok and thin, f"slab crude kernel != plain version "
                               f"({lut_dtype}, {code_bits}-bit)")
        lut_fast, _, _ = crude_lut_operands(luts, fast, quantized=False,
                                            code_bits=code_bits)
        crude = bs.ivf_crude_topk_torch(stored, ids, lut_fast, TOPK,
                                        code_bits=code_bits)[0]
        lut_slow = slow_lut_operand(luts, fast, code_bits=code_bits)
        ranked = torch.sort(crude, dim=1).values
        for rank in (2000, 30):   # many survivors; fewer than topk
            thr = ranked[:, rank].contiguous()
            thr[1] = ranked[1, 2]                  # the thin slab
            got = bs.ivf_refine_topk_cuda(stored, lut_slow, crude, thr, TOPK,
                                          code_bits=code_bits)
            want = bs.ivf_refine_topk_torch(stored, lut_slow, crude, thr,
                                            TOPK, code_bits=code_bits)
            torch.cuda.synchronize()
            ok = equal_outputs(got, want)
            log(f"mode ivf_refine {code_bits}-bit survivors/query~{rank}: "
                f"{'equal' if ok else 'DIFFERENT'}")
            check(ok, f"slab refine kernel != plain version ({code_bits}-"
                      f"bit, threshold at rank {rank})")


def compare_assign(got, want, x, cent):
    """kmeans_assign kernel against its plain version: ids equal wherever
    the two nearest scores differ by more than 1e-5 of the terms' size
    (||x||^2 + ||c||^2, which the scores cancel), distances to rtol 1e-5
    plus an atol of 1e-6 times that size (the kernel sums its dot
    products in its own order).  Returns (ok, max_abs_err, share of
    ids equal, points with a clear nearest centroid)."""
    import torch
    size = float(x.square().sum(1).max() + cent.square().sum(1).max())
    scores = torch.addmm(cent.square().sum(1), x, cent.T, alpha=-2.0)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-5 * size
    del scores
    same = got[0] == want[0]
    err = float((got[1].double() - want[1].double()).abs().max())
    close = bool(torch.isclose(got[1], want[1], rtol=1e-5,
                               atol=1e-6 * size).all())
    ok = bool(same[clear].all()) and close
    return ok, err, float(same.float().mean()), int(clear.sum())


def check_kmeans(seed: int):
    """kmeans_assign on a ragged shape, centroids beyond the TPU kernel's
    256-row block, with a duplicated centroid (the first index wins)."""
    import torch
    from repro_torch.kernels import kmeans as km
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    x = torch.randn((100_003, 128), generator=g, device="cuda")
    cent = torch.randn((8_193, 128), generator=g, device="cuda")
    cent[5000] = cent[11]
    got = km.kmeans_assign_cuda(x, cent)
    want = km.kmeans_assign_torch(x, cent)
    torch.cuda.synchronize()
    ok, err, same, clear = compare_assign(got, want, x, cent)
    dup = not bool((got[0] == 5000).any())
    log(f"mode kmeans_assign n=100003 L=8193 d=128: ids equal on "
        f"{same:.6f} of points ({clear} with a clear nearest), "
        f"max_abs_err {err}, duplicate centroid's first index wins: {dup}")
    check(ok and dup, "kmeans_assign kernel disagrees with its plain "
                      "version beyond the stated tolerance")


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
    import torch
    from repro_torch.index.base import build_lut
    from repro_torch.index.flat import FlatADC
    from repro_torch.index.ivf import (IVFTwoStep, coarse_probe,
                                       gather_candidates)
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
    slow = slow_lut_operand(luts, fast, code_bits=bits)
    tstage = ThresholdStage(topk=topk, quantized=quant, code_bits=bits)
    if isinstance(index, IVFTwoStep):
        probes = coarse_probe(q, index.ivf.centroids, index.n_probe)
        cand_ids, cand_codes = gather_candidates(probes, index.ivf.lists,
                                                 index.list_codes, topk)
        crude, cv, cp = bs.ivf_crude_topk_torch(cand_codes, cand_ids, lf,
                                                topk, sc, of, code_bits=bits)
        thr = tstage.from_slab_candidates(luts, cand_codes, cv, cp, fast,
                                          sigma)
        dist, pos = bs.ivf_refine_topk_torch(cand_codes, slow, crude, thr,
                                             topk, code_bits=bits)
        safe = torch.where(cand_ids >= 0, cand_ids,
                           torch.zeros_like(cand_ids))
        pos = torch.clamp(pos.long(), max=cand_ids.shape[1] - 1)
        return safe.gather(1, pos), dist
    crude, cv, ci = bs.crude_topk_torch(index.codes, lf, topk, sc, of,
                                        code_bits=bits)
    thr = tstage.from_candidates(luts, index.codes, cv, ci, fast, sigma)
    dist, idx = bs.refine_topk_torch(index.codes, slow, crude, thr, topk,
                                     code_bits=bits)
    return idx, dist


def reset_launches():
    from repro_torch.kernels import ops
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0


def read_launches():
    from repro_torch.kernels import ops
    return dict(ops.LAUNCHES)


def cell_config(geometry, kind, lut_dtype, code_bits):
    from repro_torch.api import ICQConfig
    g = geometry
    return ICQConfig().with_overrides({
        "train.d": g["d"], "train.num_codebooks": g["K"],
        "train.codebook_size": g["m"], "train.num_fast": g["num_fast"],
        "index.kind": kind, "index.code_bits": code_bits,
        "index.n_lists": IVF["n_lists"], "index.n_probe": IVF["n_probe"],
        "index.kmeans_iters": IVF["kmeans_iters"],
        "serve.topk": TOPK, "serve.lut_dtype": lut_dtype})


def save_flat_cell(name, geometry, kind, lut_dtype, code_bits, *, seed, n,
                   workdir):
    """Save a synthetic flat or two-step index; returns its path."""
    from repro_torch.api import Artifacts, build_index
    from repro_torch.data.synthetic import make_synthetic_index
    g = geometry
    cfg = cell_config(g, kind, lut_dtype, code_bits)
    codes, C, structure = make_synthetic_index(
        seed, n, d=g["d"], K=g["K"], m=g["m"], num_fast=g["num_fast"],
        sigma=SIGMA)
    path = os.path.join(workdir, name)
    index = build_index(codes, C, structure, index_cfg=cfg.index,
                        serve_cfg=cfg.serve, device="cuda")
    Artifacts(config=cfg, index=index).save(path)
    return path


def expected_launches(index, batches):
    """Launches of one served window: one crude (and refine) launch per
    64-query tile, on the kernels of the index's kind."""
    from repro_torch.index.flat import FlatADC
    from repro_torch.index.ivf import IVFTwoStep
    want = {k: 0 for k in read_launches()}
    if isinstance(index, IVFTwoStep):
        want.update(ivf_crude_topk=batches, ivf_refine_topk=batches)
    else:
        want["crude_topk"] = batches
        if not isinstance(index, FlatADC):
            want["refine_topk"] = batches
    return want


def serve_saved(name, path, *, seed, n, batches, overrides=None):
    """Load an artifact with ``load_ann_engine`` and serve ``batches``
    tiles of 64 queries, with the launch counts reset before and read
    after; check the answers.  Returns (launches, engine, last query
    tile)."""
    import numpy as np
    import torch
    from repro_torch.api import load_ann_engine

    engine = load_ann_engine(path, query_tile=TILE, overrides=overrides)
    index = engine.index
    d = int(index.C.shape[-1])
    engine.warm(TILE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 7)
    queries = [torch.from_numpy(rng.standard_normal((TILE, d),
                                                    dtype=np.float32)).cuda()
               for _ in range(batches)]
    reset_launches()
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
    launches = read_launches()

    want = expected_launches(index, batches)
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
    ids, dist = plain_composition(index, queries[-1])
    same = (torch.equal(ids, results[-1].indices)
            and torch.equal(dist, results[-1].distances))
    check(same, f"{name}: served top-k != plain composition")
    r = results[-1]
    C = index.C
    log(f"cell {name}: n={n} d={d} K={C.shape[0]} m={C.shape[1]} "
        f"kind={type(index).__name__} lut={index.lut_dtype} "
        f"bits={index.code_bits} tile={TILE} topk={TOPK}: "
        f"batch {dev_ms:.4f} ms (events), {host_ms:.4f} ms (host clock), "
        f"{dev_ms * 1e3 / TILE:.3f} us/query;"
        f" pass_rate={float(r.pass_rate):.6f} "
        f"inf_slots={int(torch.isinf(r.distances).sum())} "
        f"avg_ops={float(r.avg_ops):.6f}; launches={launches}; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
        f"served == plain composition: {same}")
    return launches, engine, queries[-1]


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _op_table(prof, key: str, rows: int) -> str:
    for k in (key, key.replace("device", "cuda")):
        try:
            return prof.key_averages().table(sort_by=k, row_limit=rows)
        except (AttributeError, KeyError, ValueError):
            continue
    return prof.key_averages().table(row_limit=rows)


def profile_served(name, engine, *, seed, batches, out_dir):
    """With ``--profile``: ``torch.profiler`` over ``batches`` served
    tiles of a loaded engine, after the cell's counted window.  Prints
    the batch time (host clock, profiler on), the device busy time per
    batch (every kernel the profiler saw), the device's idle share (1 -
    busy / wall), kernel launches per batch and the ops by device and
    by host time; writes a Chrome trace to
    ``<out_dir>/profile_<name>.json``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    d = int(engine.index.C.shape[-1])
    rng = np.random.default_rng(seed + 11)
    queries = [torch.from_numpy(rng.standard_normal((TILE, d),
                                                    dtype=np.float32)).cuda()
               for _ in range(batches)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries:
            engine.search(q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / batches
    launches = sum(e.count for e in kernels) / batches
    log(f"profile {name}: batch {wall_ms:.4f} ms (host clock, profiler "
        f"on), device busy {busy_ms:.4f} ms per batch, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {launches:.1f} kernel launches "
        f"per batch")
    log(f"--- {name}: ops by device time ---\n"
        + _op_table(prof, "self_device_time_total", 25))
    log(f"--- {name}: ops by host time ---\n"
        + _op_table(prof, "self_cpu_time_total", 25))
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}.json"))


# ------------------------------------------------- phase 5: IVF cells ----

def build_ivf_cell(name, geometry, lut_dtype, code_bits, *, seed, n,
                   workdir, check_repeat: bool):
    """Build an IVF index over synthetic codes from ``seed`` with
    ``build_index`` on the card (coarse k-means through the
    ``kmeans_assign`` kernel, counts reset before and read after), save
    it, and with ``check_repeat`` build it again from the same seed and
    require identical lists and centroids.  Returns (path, build
    launches, embeddings, centroids)."""
    import torch
    from repro_torch.api import Artifacts, build_index
    from repro_torch.core.codebooks import decode
    from repro_torch.data.synthetic import make_synthetic_index
    from repro_torch.index.ivf import build_ivf

    g = geometry
    cfg = cell_config(g, "ivf", lut_dtype, code_bits)
    codes, C, structure = make_synthetic_index(
        seed, n, d=g["d"], K=g["K"], m=g["m"], num_fast=g["num_fast"],
        sigma=SIGMA)
    codes = torch.from_numpy(codes).cuda()
    C = torch.from_numpy(C).cuda()
    emb_db = decode(C, codes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    index = build_index(codes, C, structure, index_cfg=cfg.index,
                        serve_cfg=cfg.serve, emb_db=emb_db, generator=seed,
                        device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = read_launches()
    want = {k: 0 for k in launches}
    want["kmeans_assign"] = IVF["kmeans_iters"] + 1
    check(launches == want, f"{name}: build launch counts {launches} != "
                            f"{want}")
    ivf = index.ivf
    lens = ivf.list_lens
    log(f"build {name}: n={n} d={g['d']} n_lists={IVF['n_lists']} "
        f"kmeans_iters={IVF['kmeans_iters']}: {build_s:.4f} s (host clock "
        f"around build_index, first build of the process); "
        f"imbalance={ivf.imbalance:.4f} max_len={ivf.lists.shape[1]} "
        f"list_len min/mean/max={int(lens.min())}/"
        f"{float(lens.float().mean()):.1f}/{int(lens.max())} "
        f"empty_lists={int((lens == 0).sum())}; launches={launches}; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    check(int(lens.sum()) == n, f"{name}: lists hold {int(lens.sum())} of "
                                f"{n} points")
    if check_repeat:
        t0 = time.perf_counter()
        again = build_ivf(emb_db, IVF["n_lists"], IVF["kmeans_iters"],
                          generator=seed)
        torch.cuda.synchronize()
        same = (torch.equal(again.lists, ivf.lists)
                and torch.equal(again.list_lens, ivf.list_lens)
                and torch.equal(again.centroids, ivf.centroids))
        log(f"build {name} again from seed {seed}: "
            f"{time.perf_counter() - t0:.4f} s; identical lists, list_lens "
            f"and centroids: {same}")
        check(same, f"{name}: a second build from the same seed differs")
    path = os.path.join(workdir, name)
    Artifacts(config=cfg, index=index).save(path)
    return path, launches, emb_db, ivf.centroids


def slab_of(engine, q):
    """The served slab of one query tile: (luts, cand_ids, cand_codes)."""
    from repro_torch.index.base import build_lut
    from repro_torch.index.ivf import coarse_probe, gather_candidates
    index = engine.index
    probes = coarse_probe(q, index.ivf.centroids, index.n_probe)
    cand_ids, cand_codes = gather_candidates(probes, index.ivf.lists,
                                             index.list_codes, TOPK)
    return build_lut(q, index.C), cand_ids, cand_codes


def time_ivf_kernels(engine, q, emb_db, centroids):
    """The three IVF kernels at the served shape (the slab of one served
    64-query tile; the build's points and centroids): times, plain
    times, bounds, the largest difference from the plain version."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels import kmeans as km
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands,
                                            slow_lut_operand)
    index = engine.index
    fast, sigma = index.structure.fast_mask, index.structure.sigma
    luts, cand_ids, cand_codes = slab_of(engine, q)
    nq, nc, Kc = cand_codes.shape
    K = index.C.shape[0]
    valid = int((cand_ids >= 0).sum())
    log(f"served slab: nq={nq} nc={nc} (n_probe x max_len), valid "
        f"candidates {valid} ({valid / nq:.1f} per query, "
        f"{valid / (nq * nc):.4f} of the slab)")
    records = {}
    lf, _, _ = crude_lut_operands(luts, fast, quantized=False)
    got = bs.ivf_crude_topk_cuda(cand_codes, cand_ids, lf, TOPK)
    want = bs.ivf_crude_topk_torch(cand_codes, cand_ids, lf, TOPK)
    check(equal_outputs(got, want), "slab crude kernel != plain version at "
                                    "the served shape")
    fin = torch.isfinite(want[0])
    err = float((got[0][fin].double() - want[0][fin].double()).abs().max())
    ms = time_ms(lambda: bs.ivf_crude_topk_cuda(cand_codes, cand_ids, lf,
                                                TOPK), 20)
    plain_ms = time_ms(lambda: bs.ivf_crude_topk_torch(cand_codes, cand_ids,
                                                       lf, TOPK), 3)
    # the id and the dense crude value of every slab column, the codes of
    # the valid columns only (an invalid column is +inf whatever its
    # codes), the LUT and the top-k, once each
    nbytes = nq * nc * (4 + 4) + valid * Kc + lf.numel() * 4 + nq * TOPK * 8
    b_ms, b_by = bound_ms(nbytes, valid * K)
    records["ivf_crude_topk"] = dict(
        name="ivf_crude_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/ivf_search.cu",
        replaces="src/repro/kernels/batched_search.py:320",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel ivf_crude_topk f32 8-bit nq={nq} nc={nc}: {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err {err}")

    crude, cv, cp = got
    thr = ThresholdStage(topk=TOPK).from_slab_candidates(
        luts, cand_codes, cv, cp, fast, sigma)
    slow = slow_lut_operand(luts, fast)
    got = bs.ivf_refine_topk_cuda(cand_codes, slow, crude, thr, TOPK)
    want = bs.ivf_refine_topk_torch(cand_codes, slow, crude, thr, TOPK)
    check(equal_outputs(got, want), "slab refine kernel != plain version "
                                    "at the served shape")
    fin = torch.isfinite(want[0])
    err = float((got[0][fin].double() - want[0][fin].double()).abs()
                .max()) if bool(fin.any()) else 0.0
    ms = time_ms(lambda: bs.ivf_refine_topk_cuda(cand_codes, slow, crude,
                                                 thr, TOPK), 20)
    plain_ms = time_ms(lambda: bs.ivf_refine_topk_torch(cand_codes, slow,
                                                        crude, thr, TOPK), 3)
    survivors = int((crude < thr[:, None]).sum())
    # the crude value of every slab column, the codes of the survivors
    # only (the margin test needs no codes), the slow LUT, the
    # thresholds and the top-k, once each; one compare per column, K
    # adds and one add per survivor
    nbytes = nq * nc * 4 + survivors * Kc + slow.numel() * 4 + nq * 4 \
        + nq * TOPK * 8
    b_ms, b_by = bound_ms(nbytes, nq * nc + survivors * (K + 1))
    records["ivf_refine_topk"] = dict(
        name="ivf_refine_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/ivf_search.cu",
        replaces="src/repro/kernels/batched_search.py:390",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel ivf_refine_topk 8-bit nq={nq} nc={nc} survivors="
        f"{survivors}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), max_abs_err {err}")

    x, cent = emb_db, centroids
    n, d = x.shape
    L = cent.shape[0]
    got = km.kmeans_assign_cuda(x, cent)
    want = km.kmeans_assign_torch(x, cent)
    ok, err, same, clear = compare_assign(got, want, x, cent)
    check(ok, "kmeans_assign kernel disagrees with its plain version at "
              "the build's shape")
    ms = time_ms(lambda: km.kmeans_assign_cuda(x, cent), 10)
    plain_ms = time_ms(lambda: km.kmeans_assign_torch(x, cent), 3)
    csq = cent.square().sum(1)
    lib_ms = time_ms(lambda: torch.argmin(
        torch.addmm(csq, x, cent.T, alpha=-2.0), 1), 10)
    b_ms, b_by = bound_ms((n * d + L * d + L) * 4 + n * 8, 2 * n * L * d)
    records["kmeans_assign"] = dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans.cu",
        replaces="src/repro/kernels/kmeans.py:33",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    log(f"kernel kmeans_assign n={n} L={L} d={d}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), two-call "
        f"library yardstick argmin(addmm) {lib_ms:.4f} ms; ids equal on "
        f"{same:.6f} of points ({clear} with a clear nearest), "
        f"max_abs_err {err}")
    return records


def ivf_cells(seed, n, batches, workdir, profile_dir=None):
    """Phase 5: IVF at SIFT1M geometry, k' = 1024, w = 8.  Returns (the
    launches of the build and served windows, the IVF kernel records)."""
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    path, launches, emb_db, cent = build_ivf_cell(
        "ivf-8bit", SIFT, "f32", 8, seed=seed, n=n, workdir=workdir,
        check_repeat=True)
    add(launches)
    launches, engine, q = serve_saved("ivf-f32", path, seed=seed, n=n,
                                      batches=batches)
    add(launches)
    if profile_dir:
        profile_served("ivf-f32", engine, seed=seed, batches=5,
                       out_dir=profile_dir)
    add(serve_saved("ivf-int8", path, seed=seed, n=n, batches=batches,
                    overrides={"serve.lut_dtype": "int8"})[0])
    records = time_ivf_kernels(engine, q, emb_db, cent)
    del engine, emb_db, cent
    path, launches, _, _ = build_ivf_cell(
        "ivf-4bit", dict(d=128, K=16, m=16, num_fast=4), "int8", 4,
        seed=seed, n=n, workdir=workdir, check_repeat=False)
    add(launches)
    add(serve_saved("ivf-int8-4bit", path, seed=seed, n=n,
                    batches=batches)[0])
    return total, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database points of the main-path cells")
    ap.add_argument("--batches", type=int, default=3,
                    help="64-query batches served per cell")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace 5 served tiles of the two-step-f32 "
                         "and ivf-f32 cells with torch.profiler (Chrome "
                         "traces to DIR)")
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
    check_slab_modes(args.seed)
    check_kmeans(args.seed)
    records = time_kernels(args.seed, args.n)

    cells = (("two-step-f32", SIFT, "two-step", "f32", 8),
             ("two-step-int8", SIFT, "two-step", "int8", 8),
             ("flat-f32", SIFT, "flat", "f32", 8),
             ("two-step-int8-4bit", dict(d=128, K=16, m=16, num_fast=4),
              "two-step", "int8", 4))
    total = {k: 0 for k in read_launches()}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as workdir:
        for name, *cell in cells:
            path = save_flat_cell(name, *cell, seed=args.seed, n=args.n,
                                  workdir=workdir)
            launches, engine, _ = serve_saved(name, path, seed=args.seed,
                                              n=args.n, batches=args.batches)
            for k in total:
                total[k] += launches[k]
            if args.profile and name == "two-step-f32":
                profile_served(name, engine, seed=args.seed, batches=5,
                               out_dir=args.profile)
            del engine
        ivf_total, ivf_records = ivf_cells(args.seed, args.n, args.batches,
                                           workdir, args.profile)
    for k in total:
        total[k] += ivf_total[k]
    records.update(ivf_records)
    for k, rec in records.items():
        check(total[k] > 0, f"{k} was never launched on the main path")
        rec["launches"] = total[k]

    log(json.dumps({"kernels": [records[k] for k in (
        "crude_topk", "refine_topk", "ivf_crude_topk", "ivf_refine_topk",
        "kmeans_assign")]}))
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
