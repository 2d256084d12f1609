#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds the hand-written kernels
from this checkout, holds each against its plain PyTorch version on the
card, then builds and serves the flat, two-step and IVF indexes at
SIFT1M geometry through the port's own entry points (``build_index``,
``load_ann_engine``), trains, and serves two dense LMs, a MoE LM and
an MLA + MoE LM at full width (``serve_lm``), and checks what comes
out.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--batches 3] \
        [--profile DIR]

Needs one CUDA card; exits non-zero, printing no result, without one
or outside a checkout of the repository.  Phases:

1. card name and power limit (nvidia-smi), kernel build time and the
   compiler's ``-Xptxas -v`` report, with the registers and spills of
   every instance of the two scan kernels (the crude kernel as the flat
   pass compiles it in batched_search.cu and as the slab pass does in
   ivf_search.cu);
2. every kernel mode on ragged shapes, each equal bit for bit to its
   plain version: flat crude {f32, int8} x {8, 4 bit} x dense crude on
   or off, with duplicated code rows (exact ties); slab crude {f32,
   int8} x {8, 4 bit} on slabs with -1 holes, duplicated rows and one
   query slab thinner than topk; flat and slab refine {8, 4 bit} with
   many survivors, fewer than topk, none, all, and survivors only in
   the first and only in the last 1024-row chunk; every one of them at
   topk = 100, 257 and 2048 (past the chunk); the slab crude in every
   mode on adversarial slabs (distances rising, falling and equal
   along the slab; a row of ids all -1, a row with 700 invalid columns
   before its first valid one; slabs of one chunk, 1025 and 5000
   columns) at topk 1, 100 and 2048 (or nc); the same modes, regimes
   and adversarial slabs (m = 1024) over int32 code rows at m = 512 and
   1024 (codes wider than a byte, as the index stores them); the widest
   codes one block's shared memory serves: at m = 256 (uint8 rows) K =
   109 with f32 LUTs and 175 with int8 crude LUTs, at m = 512 (int32) 36
   and 48, at m = 1024 27 and 43, all four passes at the f32 width and
   both crude passes at the int8 width equal to their plain versions,
   one codebook more raising a ValueError naming shared memory; and
   ``kmeans_assign`` (L = 8193 centroids, one duplicated) against its
   plain version: ids equal wherever the two nearest scores are apart
   by more than 1e-5 of the terms' size, distances to rtol 1e-5;
3. the flat kernels at the main path's shape (64 queries x 1M points,
   K = 8, m = 256): time (CUDA events), the plain version's time, the
   least time the card could take (bytes or operations, whichever
   binds); the refine kernel at the served cells' margin (sigma = 10,
   about 0.3% of the points pass) and at sigma = 0.5 (fewer survivors
   than topk);
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
   phase 3 at the served shape: the slab of one served tile (one slab
   kernel call in a CUDA graph printed beside its eager time; the slab
   crude kernel alone at 1 to 16 blocks per query beside its plan's),
   and
   the build's 1M points against its 1024 centroids (with the two-call
   library yardstick ``argmin(addmm)`` beside ``kmeans_assign``);
6. encode and grow at SIFT1M geometry (3 ICM sweeps): the ICM kernel
   against its plain version at 1 and 3 sweeps on ``decode(C, random
   codes) + noise`` (codes equal on >= 99.9% of rows, reconstruction MSE
   to rtol 1e-5), the first index winning when every codeword is
   duplicated, the same codes per row in a permuted row order, its time
   beside its bound; all of it first at GIST1M's d = 960 on 100k
   points (the target and recon tiles staged through global scratch);
   ``encode_database`` of all points (launch counts
   reset before, read after), equal to a direct ``icm_encode``; then a
   two-step and an IVF index built from the first 90% of the points
   grow by the rest through ``AnnEngine.add`` (counts reset before, read
   after): codes (and for IVF lists and in-list codes) equal to the
   index built over all points at once, one 64-query tile served equal
   by both, and equal again after a save and ``load_ann_engine``.
   ``kmeans_assign`` and the ICM kernel are also timed at one encode
   chunk (8192 points; L = 256 for the PQ warm start), the shape at
   which the encode and add windows launch them; there the wrapper
   splits the centroid axis (split-L), the split launch must equal the
   unsplit one bit for bit, and the ``argmin(addmm)`` yardstick is
   timed in a CUDA graph beside its eager time;
7. the kernel ops (``ops.adc``, ``ops.two_step``, ``ops.flash_attention``):
   each kernel against its plain version on ragged shapes (ADC and
   two-step bit for bit on uint8 and int32 rows, K in {2, 8, 16}, m in
   {16, 256}, thresholds passing none, some and all points; flash
   attention within 2e-5 in f32 and 2e-2 in bf16, causal and not,
   sq != sk, MHA, GQA and MQA, dh in {32, 64, 128, 256}; each line names
   the body that ran, ``mma.sync`` bf16 or FMA f32, with its registers
   and local-memory bytes); then the ops
   once each at full width, counts reset before and read after: ADC and
   two-step at SIFT1M geometry (1M uint8 rows, one query's LUT, 2 fast
   codebooks, the threshold at the crude 0.3% quantile), flash attention
   at tinyllama-1.1b's (f32 and bf16) and llama3-405b's (bf16) attention
   widths at s = 4096, causal; and their times beside their bounds, their
   plain versions and a one-call library yardstick (``embedding_bag``,
   ``scaled_dot_product_attention``);
8. (run after phase 5, as is 9) the degradation ladder on the
   two-step-f32, flat-f32 and ivf-f32 artifacts of phases 4-5: every rung the card offers (two-step and
   flat {full, crude}, IVF {full, probes, crude}) warmed once and served
   in 64-query tiles with the launch counts reset before and read after
   (the crude rung launches the crude kernel once a tile and the refine
   never), its ms per tile printed beside the card's name and power
   limit; the crude rung equal bit for bit to the crude top-k of the
   plain composition on the same CUDA tensors, the probes rung to the
   index served full at n_probe = 4, full to the plain composition; a
   deadline of half the crude rung's measured time serves crude; filter,
   refine_cap and the capped rung raise the reference's ValueError; and
   a ``FaultInjector`` fault at ``kernels.batched_crude_topk`` is
   retried once in place (max_retries 1), no failover, the same top-k;
9. codes wider than a byte at SIFT1M's width: the flat crude and refine
   kernels timed over 1M int32 rows at m = 1024 beside their byte bound,
   a two-step f32 and an IVF f32 index at K = 8, m = 1024 (32 MB of
   int32 codes) saved, loaded with ``load_ann_engine`` and served in
   64-query tiles equal to the plain composition, and the slab kernels
   timed on the wide IVF cell's served slab;
10. (run after phase 8) the request path on the two-step-f32 and
   ivf-f32 artifacts: each served pipelined (``serve.pipeline =
   "tiles"``, tile 64, no engine tiling: the crude pass of tile t+1 on
   one CUDA stream beside the refine of tile t on another) at every
   rung the card offers (two-step {full, crude}, IVF {full, probes =
   n_probe 4, crude}) over 3 batches of 512 queries and one of 200,
   each result equal to the ``pipeline="off"``, ``query_tile=64``
   engine's ids and distances bit for bit and to all four fields
   (ids, distances, pass_rate, avg_ops) of the sequential index over
   the same 64-query blocks (``serve.query_chunk = 64``), with the
   same launch counts; ms per 512-query batch pipelined and off (CUDA
   events and the host clock) and peak MB; with ``--profile``, the
   device idle share of both and the streams the crude and refine
   scan kernels ran on (two expected); then both artifacts as tenants
   of one ``ServingLoop`` (32-row lanes, 2 ms window, warmed once)
   under ``run_open_loop`` of ``make_workload`` (1000 requests/s for
   2 s, seed 0, 1, 2 or 4 rows a request), every response equal to
   the tenant engine's direct call bit for bit, with each tenant's
   requests, p50 and p99 ms, requests/s, mean fill and mean queue ms
   (and, not a gate, how many also equal a direct call with the
   engine's tiling off, at the request's own row count);
   and ``eval.ground_truth`` of 64 queries over the 1M decoded points
   on the card (ms), its ids equal to the CPU ``exact_search`` wherever
   the k-th and (k+1)-th distances are more than 1e-5 relative apart.

11. training at the paper's Figure 1 full protocol
   (``benchmarks/fig1_synthetic_pq.py``, full): Table 1's dataset1
   (10000 rows, 64 features), d = 16, K = 8, m = 256, 2 fast codebooks,
   the linear embedder, mode icq, 10 epochs of batch 256 at lr 1e-3.
   First the gate: ``init_train_state`` on the card (its k-means
   launches ``kmeans_assign`` 8 x 26 times; the kernel is held against
   its plain version at that shape), 2 epochs of ``run_epoch`` on the
   card with every step run again on the CPU from the card's inputs
   (loss terms, psi_size, params, optimizer and variance state to rtol
   1e-4; a step whose batch codes flip between the devices at a near
   tie is counted instead), and ``finalize`` of the card's state on
   both devices (structure equal, sigma to rtol 1e-5, codes on >= 99.9%
   of rows; its encode launches ``kmeans_assign`` 8 and ``icm_encode``
   once a chunk); the CPU's own free-running drift is printed.  Then
   the main path: ``fit`` on the card (launch counts reset before and
   read after: the init's and the export's), its loss terms per epoch
   (the last epoch's total below the first's), the model served by
   ``TwoStep`` at topk 50 over the 1000 test queries (equal to the
   plain composition), MAP@50 (above chance, 0.1), Average Ops and
   pass_rate beside the JAX package's CPU run of the same protocol;
   init, step (CUDA events, median), epoch and finalize times, peak MB.

12. the front door: the PQ, OPQ and CQ baselines through
   ``icq_session(cfg).fit`` at SIFT1M's geometry (pseudo_sift: 100,000
   train points, the size of SIFT1M's learn set, and a 1M-point base
   indexed flat; d = 128, K = 8, m = 256; PQ 25 k-means iterations, OPQ 8
   rounds, CQ 10 rounds of 50 steps): fit, encode and ms per 64-query
   tile of ``Searcher.search``, recall@100 over 1000 queries against
   ``eval.ground_truth``, peak MiB and the launches of fit, index and
   serve (each checked against what the fit implies); ``sq`` on Figure
   2's full protocol (dataset1, two-step, topk 50) and ``pqn`` with the
   cnn embedder on Figure 5's (pseudo_mnist, 8000 / 800) through the
   session, MAP@50, Average Ops, pass_rate.  Gates: ``Searcher.save`` ->
   ``load_ann_engine`` fed ``ICQSession.from_artifacts(...).model``'s
   embeddings serves the in-process answers bit for bit (an OPQ reload
   raises ``ArtifactError``); ``Tenant.from_searcher`` answers as
   ``Searcher.search``; PQ's, OPQ's and CQ's ``step`` and ``finalize``
   on the card equal the CPU's from the same state (phase 11's
   tolerances; OPQ's round fed the card's round init); ``kmeans_assign``
   at the 100,000 x 256 x 16 subspace shape and ``icm_encode`` with CQ's
   trained codebooks against their plain versions; and phase 11's cell
   trained by ``fit(ckpt_dir=)`` with one fault before epoch 4 ends with
   one restart, its C, codes and structure bit for bit the
   uninterrupted fit's.

13. sharded serving and the data-parallel fit (``index/sharded.py``,
   ``fit(mesh=)``): the two-step f32 / int8, flat f32, two-step int8
   4-bit and ivf-f32 artifacts of phases 4-5 served through
   ``load_ann_engine(path, mesh=)`` over 4 shards on the first card
   (250,000 rows or 256 lists a shard) and over ``make_mesh_auto``'s
   one-device list, and two-step f32 over 3 shards (a shorter last
   shard): every 64-query tile equal bit for bit, in ids, distances,
   pass_rate and avg_ops, to the unsharded engine's, D crude and D
   refine launches a tile (launch counts reset before, read after), ms
   a tile (CUDA events and host clock) beside the unsharded engine's,
   peak MiB; shard 1 of 4 marked dead on two-step f32 and ivf-f32:
   equal to an unsharded engine over the survivors (the codes without
   the dead rows, ids mapped back; the dead lists emptied), coverage the
   surviving share, every batch degraded, 3 launches of each kernel a
   tile, marking all four dead raises; a sharded two-step engine grown
   by 100,000 points through ``AnnEngine.add`` equal bit for bit to the
   grown unsharded engine, and a dead shard kept through the add; then
   phase 11's Figure 1 cell through ``fit(mesh=)`` on 4 shards of 64
   rows on the first card, each step's inputs kept: every data-parallel
   step equal to the CPU's 4-shard step and to the card's single-device
   step from the same inputs, to phase 11's step gate; the launches of
   the init and the export; the data-parallel step's ms; MAP@50 of the
   served model beside phase 11's.

14. LM serving (``launch.serve.serve_lm``, the ``--arch`` command's
   path) on the card at full width with random weights drawn by the
   port's ``init`` from a generator on the card, four cells served one
   after the other, each freed (``del``, ``empty_cache``) before the
   next: cell A, tinyllama-1.1b in f32, batch 8, a 512-token prompt
   (the ``full_attention`` branch), 32 greedy decode steps, then the
   same 32 steps through the ICQ-KV decode (``build_icq_decode``,
   d_fast 16, top_c 128, its caches quantized per layer from the
   prefill's K/V, fed the dense steps' tokens): its ms a step, max logit
   error and greedy agreement against the dense steps (reported, not
   gated) and the cache bytes a step reads, dense and ICQ; cell B,
   gemma-7b under ``scale_config`` (bf16), batch 1, a 2048-token prompt
   (the chunked branch), 16 steps; cell C, moonshot-v1-16b-a3b in bf16
   at full depth (1 dense + 47 MoE layers of 64 experts top-6 + 2
   shared, 28.4 B parameters), batch 8, a 512-token prompt, 16 steps:
   the capacity-bounded dispatch at T = 4096 (C = 480) in the prefill
   and T = 8 (C = 4, drops possible) a step; cell D, deepseek-v2-236b
   in bf16, its depth cut to 6 layers (1 MLA dense + 5 MLA MoE of 160
   experts, 21.2 B parameters; the 60 layers do not fit one card),
   batch 1, a 2048-token prompt (past ``attn_chunk``: on the card MLA's
   K and V materialized and the flash kernel's (192, 128) instance),
   16 steps.  Each prints prefill ms, decode ms a step, tokens/s and
   peak MiB (CUDA events) beside the card's name and power limit.
   Gates: (1) each arch's model on the card against the CPU from the
   same weights in f32 at batch 1, a 64-token prompt and 4 steps
   (tinyllama at full depth, the MoE archs at depth 2: the first dense
   layer and one MoE layer), logits within 2e-4 of the largest
   (``LM_TOL``), greedy tokens equal wherever the CPU's top-2 gap
   exceeds that; (2) at every cell's shape, the flash kernel on layer
   0's q, k, v against its plain version (phase 7's tolerance), timed
   beside its bound and SDPA (or SDPA's refusal), and the f32 (192,
   128) body at a small MLA shape; (3) cell C's two prefills from the
   same inputs, and two decode steps from those caches, bit for bit
   equal (logits and caches); (4) cell C's layer 1 dispatch at 512
   tokens with capacity_factor = E (no drops) against the every-expert
   oracle within 2^-5 of the largest output; (5) at cell A's head
   geometry ICQ-KV attention at top_c = S equal to exact attention over
   the dequantized cache; (6) launch counts reset before and read after
   each cell: exactly ``num_layers`` flash launches a prefill (22, 28,
   48 and 6; the untimed warm prefill doubles the window's count) and
   none in the decode steps.  TF32 must be off; the phase logs
   ``torch.get_float32_matmul_precision()``.  The kernels' record of
   flash attention is cell B's served prefill shape, with the launches
   of the whole run; a second record, ``flash_attention (192, 128)``,
   is cell D's, with cell D's launches.

``torch.cuda.memory_allocated()`` (after ``gc.collect()``) is printed
before and after phase 10, with every live CUDA tensor of 64 MiB or more
and the types of what holds it.

Every engine but the fault check's runs with
``resilience.max_retries = 0``, so a failed batch is tried once more
(the reference's count) and then raises; at the end none may have
retried or failed over.

With ``--profile DIR``, five more tiles of the two-step-f32 and ivf-f32
cells run under ``torch.profiler`` after their counted windows: the
device busy time and idle share per tile, the ops by device and host
time, and a Chrome trace per cell in DIR; phase 10 traces its 512-query
batches pipelined and off the same way, phase 11 10 train steps, and
phase 14 one prefill and 4 decode steps of each LM cell.

The line before the last is the kernels' JSON record (the nine
kernels, then the flash kernel's (192, 128) instance); the last line is
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
# and the dense bf16 tensor-core rate
BF16_OPS_PER_S = 989e12

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
# ICM sweeps of the encoder (the config's encode.icm_iters)
ICM_ITERS = 3
# attention widths of two repo configs at the train_4k length (4096,
# src/repro/configs/shapes.py): tinyllama-1.1b
# (src/repro/configs/tinyllama_1_1b.py) and llama3-405b
# (src/repro/configs/llama3_405b.py), batch 1, causal
ATTENTION = (("tinyllama-1.1b", dict(b=1, s=4096, H=32, KVH=4, dh=64),
              ("float32", "bfloat16")),
             ("llama3-405b", dict(b=1, s=4096, H=128, KVH=8, dh=128),
              ("bfloat16",)))
# the served cells' pass rate: the two-step threshold at this quantile
PASS_QUANTILE = 0.003
# phase 2 also checks each search mode at these k: past the 256 that
# the card once capped, and past the 1024-point chunk
LARGE_TOPK = (257, 2048)
# phase 6 also encodes at GIST1M's width (d = 960, a standard benchmark
# of the paper's field; past the 256 dimensions that the ICM kernel
# keeps resident), on 100k points
WIDE_ICM = dict(n=100_000, d=960)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


# every engine the script serves with, by name, with its stats: all but
# phase 8's fault check run with resilience.max_retries = 0, so a failed
# batch is tried once more and then raises, and at the end none may have
# retried or failed over
ENGINES = []
NO_RETRIES = {"resilience.max_retries": 0}


def engine_load(name, path, overrides=None, **kw):
    """``load_ann_engine`` with no retries, registered in ``ENGINES``."""
    from repro_torch.api import load_ann_engine
    engine = load_ann_engine(path, overrides={**NO_RETRIES,
                                              **(overrides or {})}, **kw)
    ENGINES.append((name, engine.stats))
    return engine


def engine_over(name, index, **kw):
    """``AnnEngine`` over an index with no retries, registered."""
    from repro_torch.api import AnnEngine, ResilienceConfig
    engine = AnnEngine(index, resilience=ResilienceConfig(max_retries=0),
                       **kw)
    ENGINES.append((name, engine.stats))
    return engine


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


def graph_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times between CUDA events, so
    that the host's time to launch a microsecond kernel stays out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over their rate (f32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal_outputs(got, want) -> bool:
    import torch
    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want))


def scan_kernel_registers(logs) -> list:
    """(source, kernel instance, registers, spill store bytes, spill load
    bytes) of every instance of the two scan kernels in the
    ``-Xptxas -v`` report, from their mangled template arguments."""
    import re
    out = []
    for name, text in logs.items():
        fn, spills = None, (0, 0)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spills = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                k = re.search(r"(crude|refine)_scan_kernelI([hi])"
                              r"((?:L[bi]\d+E)+)E", fn)
                if k:
                    flags = re.findall(r"L[bi](\d+)E", k.group(3))
                    names = (("quant", "nibble", "masked", "stages")
                             if k.group(1) == "crude"
                             else ("nibble", "stages"))
                    rows = "uint8" if k.group(2) == "h" else "int32"
                    inst = ", ".join([f"rows={rows}"] + [
                        f"{a}={b}" for a, b in zip(names, flags)])
                    out.append((f"{name}.cu", f"{k.group(1)}_scan_kernel<"
                                f"{inst}>", int(m.group(1)), *spills))
                fn = None
    return out


# ------------------------------------------------------------ operands ----

def code_dtype(m: int):
    """The stored code type of m codewords: uint8 up to 256, int32 past
    it (``core.encode``'s rule)."""
    import torch
    return torch.uint8 if m <= 256 else torch.int32


def problem(seed, n, nq, K, m, d, num_fast, dup: bool):
    """Codes (n, K) in their stored type (``code_dtype``) with duplicated
    rows when ``dup``, f32 LUTs of random queries (built by the port),
    and the fast mask, on the card."""
    import torch
    from repro_torch.index.base import build_lut
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = torch.randn((K, m, d), generator=g, device="cuda") / K ** 0.5
    codes = torch.randint(0, m, (n, K), generator=g, device="cuda",
                          dtype=torch.int32).to(code_dtype(m))
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

def check_modes(seed: int, geometries=((8, 8, 256), (4, 7, 16))):
    """Every mode of both kernels equals its plain version bit for bit,
    for each (code_bits, K, m) of ``geometries`` (m > 256: int32 rows)."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import crude_lut_operands, slow_lut_operand
    n, nq = 200_003, 67          # ragged against the 1024-point chunk
    for code_bits, K, m in geometries:
        codes, luts, fast = problem(seed + code_bits, n, nq, K, m, 32, 2,
                                    dup=True)
        stored = stored_codes(codes, K, code_bits)
        for lut_dtype in ("f32", "int8"):
            lut_flat, sc, of = crude_lut_operands(
                luts, fast, quantized=lut_dtype == "int8",
                code_bits=code_bits)
            for topk, want_crude in ((TOPK, True), (TOPK, False),
                                     *((k, True) for k in LARGE_TOPK)):
                got = bs.crude_topk_cuda(stored, lut_flat, topk, sc, of,
                                         want_crude=want_crude,
                                         code_bits=code_bits)
                want = bs.crude_topk_torch(stored, lut_flat, topk, sc, of,
                                           want_crude=want_crude,
                                           code_bits=code_bits)
                torch.cuda.synchronize()
                ok = equal_outputs(got, want)
                log(f"mode crude {lut_dtype} {code_bits}-bit m={m} "
                    f"{stored.dtype} rows topk={topk} "
                    f"want_crude={want_crude}: "
                    f"{'equal' if ok else 'DIFFERENT'}")
                check(ok, f"crude kernel != plain version ({lut_dtype}, "
                          f"{code_bits}-bit, m={m}, topk={topk}, "
                          f"want_crude={want_crude})")
        lut_fast, _, _ = crude_lut_operands(luts, fast, quantized=False,
                                            code_bits=code_bits)
        crude = bs.crude_topk_torch(stored, lut_fast, TOPK,
                                    code_bits=code_bits)[0]
        lut_slow = slow_lut_operand(luts, fast, code_bits=code_bits)
        for regime, cr, thr in refine_regimes(crude, 5000):
            for topk in (TOPK, *LARGE_TOPK):
                got = bs.refine_topk_cuda(stored, lut_slow, cr, thr, topk,
                                          code_bits=code_bits)
                want = bs.refine_topk_torch(stored, lut_slow, cr, thr, topk,
                                            code_bits=code_bits)
                torch.cuda.synchronize()
                ok = equal_outputs(got, want)
                log(f"mode refine {code_bits}-bit m={m} topk={topk} "
                    f"survivors: {regime}: {'equal' if ok else 'DIFFERENT'}")
                check(ok, f"refine kernel != plain version ({code_bits}-"
                          f"bit, m={m}, topk={topk}, survivors: {regime})")


def refine_regimes(crude, many: int):
    """(name, crude, thresholds) of the refine checks, each where a
    running top-k can go wrong: many survivors per query; fewer than
    topk, spread over every block (the +inf tail carries the lowest
    pruned columns); none; all (thr = +inf); and survivors only in the
    first and only in the last 1024-column chunk (every other column's
    crude raised far above the threshold)."""
    import torch
    nq, n = crude.shape
    ranked = torch.sort(crude, dim=1).values
    col = torch.arange(n, device=crude.device)
    inf = float("inf")
    out = [("many", crude, ranked[:, many]),
           ("fewer than topk", crude, ranked[:, 30]),
           ("none", crude, torch.full((nq,), -inf, device=crude.device)),
           ("all", crude, torch.full((nq,), inf, device=crude.device))]
    for name, keep in (("first chunk only", col < 1024),
                       ("last chunk only", col >= (n - 1) // 1024 * 1024)):
        cr = torch.where(keep, crude, crude.abs() + 1e6)
        rank = min(int(keep.sum()) - 1, 150)
        out.append((name, cr, torch.sort(cr, dim=1).values[:, rank]))
    return [(name, cr.contiguous(), thr.contiguous())
            for name, cr, thr in out]


def slab_problem(seed, nq, nc, K, m, d, num_fast):
    """A ragged candidate slab on the card: codes (nq, nc, K) in their
    stored type with duplicated rows (exact ties), ids with -1 holes in
    every row and a query (row 1) with fewer valid columns than topk,
    f32 LUTs of random queries and the fast mask."""
    import torch
    from repro_torch.index.base import build_lut
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = torch.randn((K, m, d), generator=g, device="cuda") / K ** 0.5
    codes = torch.randint(0, m, (nq, nc, K), generator=g, device="cuda",
                          dtype=torch.int32).to(code_dtype(m))
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


def check_slab_modes(seed: int, geometries=((8, 8, 256), (4, 7, 16))):
    """Every mode of both slab kernels equals its plain version bit for
    bit on ragged slabs, for each (code_bits, K, m) of ``geometries``."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import crude_lut_operands, slow_lut_operand
    nq, nc = 37, 9_001           # ragged against the 1024-row chunk
    for code_bits, K, m in geometries:
        codes, ids, luts, fast = slab_problem(seed + 10 + code_bits, nq, nc,
                                              K, m, 32, 2)
        stored = stored_codes(codes, K, code_bits)
        for lut_dtype in ("f32", "int8"):
            lut_flat, sc, of = crude_lut_operands(
                luts, fast, quantized=lut_dtype == "int8",
                code_bits=code_bits)
            for topk in (TOPK, *LARGE_TOPK):
                got = bs.ivf_crude_topk_cuda(stored, ids, lut_flat, topk, sc,
                                             of, code_bits=code_bits)
                want = bs.ivf_crude_topk_torch(stored, ids, lut_flat, topk,
                                               sc, of, code_bits=code_bits)
                torch.cuda.synchronize()
                ok = equal_outputs(got, want)
                thin = bool(torch.isinf(got[1][1, TOPK // 3:]).all())
                log(f"mode ivf_crude {lut_dtype} {code_bits}-bit m={m} "
                    f"topk={topk}: {'equal' if ok else 'DIFFERENT'}; thin "
                    f"slab's +inf tail: {thin}")
                check(ok and thin, f"slab crude kernel != plain version "
                                   f"({lut_dtype}, {code_bits}-bit, m={m}, "
                                   f"topk={topk})")
        lut_fast, _, _ = crude_lut_operands(luts, fast, quantized=False,
                                            code_bits=code_bits)
        crude = bs.ivf_crude_topk_torch(stored, ids, lut_fast, TOPK,
                                        code_bits=code_bits)[0]
        lut_slow = slow_lut_operand(luts, fast, code_bits=code_bits)
        # the -1 columns are +inf in crude: they never pass, and rank by
        # position like any pruned column; the thin slab (row 1) gets a
        # finite threshold that passes 2 of its columns
        for regime, cr, thr in refine_regimes(crude, 2000):
            if regime in ("many", "fewer than topk"):
                thr[1] = torch.sort(cr[1]).values[2]
            for topk in (TOPK, *LARGE_TOPK):
                got = bs.ivf_refine_topk_cuda(stored, lut_slow, cr, thr,
                                              topk, code_bits=code_bits)
                want = bs.ivf_refine_topk_torch(stored, lut_slow, cr, thr,
                                                topk, code_bits=code_bits)
                torch.cuda.synchronize()
                ok = equal_outputs(got, want)
                log(f"mode ivf_refine {code_bits}-bit m={m} topk={topk} "
                    f"survivors: {regime}: {'equal' if ok else 'DIFFERENT'}")
                check(ok, f"slab refine kernel != plain version ({code_bits}"
                          f"-bit, m={m}, topk={topk}, survivors: {regime})")


def ordered_slab(order, nc, nq, lut_dtype, code_bits, m=256):
    """A slab whose crude distance at position i is a chosen function of
    i, the same in every row: rising with i, falling, or equal for all.
    f32 LUTs give the rank itself (exact integers); int8 LUTs a coarse,
    non-decreasing step of it (long runs of exact ties).  8-bit codes are
    two codebooks of m codewords (int32 rows past 256).  Returns (codes
    (nq, nc, Kc), lut, scale, offset) on the card."""
    import torch
    from repro_torch.core.encode import pack_nibbles
    r = torch.arange(nc, device="cuda")
    if order == "falling":
        r = nc - 1 - r
    elif order == "equal":
        r = torch.full_like(r, 12345)
    j = torch.arange(m if code_bits == 8 else 16, device="cuda",
                     dtype=torch.float32)
    if code_bits == 8:
        codes = torch.stack([r // m % m, r % m], 1).to(code_dtype(m))
        lut = (torch.stack([float(m) * j, j]) if lut_dtype == "f32"
               else torch.stack([torch.div(j, m // 128,
                                           rounding_mode="floor")
                                 - 64, 0 * j]))
    else:
        codes = pack_nibbles(torch.stack([r >> (4 * k) & 15
                                          for k in range(4)], 1)
                             .to(torch.uint8), 4)
        lut = (torch.stack([16.0 ** k * j for k in range(4)])
               if lut_dtype == "f32"
               else torch.stack([0 * j, 0 * j, 0 * j, j]))
    lut = lut.reshape(1, -1).repeat(nq, 1)
    slab = codes[None].expand(nq, -1, -1).contiguous()
    if lut_dtype == "f32":
        return slab, lut.contiguous(), None, None
    return (slab, lut.to(torch.int8).contiguous(),
            torch.full((nq,), 0.5, device="cuda"),
            torch.linspace(-1.0, 1.0, nq, device="cuda"))


def check_slab_adversarial(seed: int, formats=((8, 256), (4, 16))):
    """The slab crude kernel in every mode equals its plain version bit
    for bit on adversarial slabs: distances rising, falling and equal
    along the slab; row 0 all -1 (its top-k must be (+inf, 0..topk-1)),
    row 1 with 700 invalid columns before its first valid one, row 2
    with 20% holes, row 3 with none; slabs of one chunk, 1025 and 5000
    columns; topk 1, 100 and 2048 (or nc); for each (code_bits, m) of
    ``formats`` (m > 256: int32 rows)."""
    import torch
    from repro_torch.kernels import batched_search as bs
    nq = 4
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    for nc in (1024, 1025, 5000):
        ids = torch.randint(0, 1 << 30, (nq, nc), generator=g,
                            device="cuda", dtype=torch.int32)
        ids[0] = -1
        ids[1, :700] = -1
        ids[2, torch.rand((nc,), generator=g, device="cuda") < 0.2] = -1
        for order in ("rising", "falling", "equal"):
            for lut_dtype in ("f32", "int8"):
                for code_bits, m in formats:
                    slab, lut, sc, of = ordered_slab(order, nc, nq,
                                                     lut_dtype, code_bits, m)
                    for topk in (1, TOPK, min(2048, nc)):
                        got = bs.ivf_crude_topk_cuda(slab, ids, lut, topk,
                                                     sc, of,
                                                     code_bits=code_bits)
                        want = bs.ivf_crude_topk_torch(slab, ids, lut, topk,
                                                       sc, of,
                                                       code_bits=code_bits)
                        torch.cuda.synchronize()
                        empty = (bool(torch.isinf(got[1][0]).all())
                                 and torch.equal(got[2][0], torch.arange(
                                     topk, device="cuda",
                                     dtype=torch.int32)))
                        check(equal_outputs(got, want) and empty,
                              f"slab crude kernel != plain version on an "
                              f"adversarial slab ({order}, nc={nc}, "
                              f"{lut_dtype}, {code_bits}-bit, m={m}, "
                              f"topk={topk})")
    log(f"mode ivf_crude adversarial slabs (rising / falling / equal; a row "
        f"all -1, a 700-column invalid prefix, 20% holes; nc = 1024, 1025, "
        f"5000) x {{f32, int8}} x (code_bits, m) {list(formats)} x topk "
        f"{{1, 100, 2048 or nc}}: equal")


# the widest codes one block's shared memory serves, per m: (m, K with
# f32 LUTs (all four passes), K with int8 crude LUTs (both crude
# passes)); uint8 rows at m = 256, int32 rows past it
WIDEST = ((256, 109, 175), (512, 36, 48), (1024, 27, 43))


def check_wide_codes(seed: int):
    """The widest codes of ``WIDEST``: at the f32 K every pass (flat and
    slab crude, flat and slab refine), at the int8 K both crude passes,
    each equal to its plain version bit for bit at topk 100 and 2048;
    one codebook more raises a ValueError naming shared memory in each."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import crude_lut_operands, slow_lut_operand
    nq, nc = 3, 5003
    for m, k_f32, k_int8 in WIDEST:
        for K, lut_dtype in ((k_f32, "f32"), (k_int8, "int8")):
            codes, ids, luts, fast = slab_problem(seed + K + m, nq, nc, K, m,
                                                  16, 2)
            flat = codes[0].contiguous()
            quant = lut_dtype == "int8"
            lf, sc, of = crude_lut_operands(luts, fast, quantized=quant)
            for topk in (TOPK, 2048):
                for what, cuda, plain, args in (
                        ("slab crude", bs.ivf_crude_topk_cuda,
                         bs.ivf_crude_topk_torch, (codes, ids, lf, topk, sc,
                                                   of)),
                        ("flat crude", bs.crude_topk_cuda,
                         bs.crude_topk_torch, (flat, lf, topk, sc, of))):
                    got, want = cuda(*args), plain(*args)
                    torch.cuda.synchronize()
                    check(equal_outputs(got, want), f"{what} kernel != "
                          f"plain version at m={m} K={K} {lut_dtype}, "
                          f"topk={topk}")
            if not quant:
                slow = slow_lut_operand(luts, fast)
                scrude = bs.ivf_crude_topk_torch(codes, ids, lf, TOPK)[0]
                crude = bs.crude_topk_torch(flat, lf, TOPK)[0]
                sthr = torch.sort(scrude, dim=1).values[:, 400].contiguous()
                thr = torch.sort(crude, dim=1).values[:, 400].contiguous()
                for topk in (TOPK, 2048):
                    for what, cuda, plain, args in (
                            ("slab refine", bs.ivf_refine_topk_cuda,
                             bs.ivf_refine_topk_torch, (codes, slow, scrude,
                                                        sthr, topk)),
                            ("flat refine", bs.refine_topk_cuda,
                             bs.refine_topk_torch, (flat, slow, crude, thr,
                                                    topk))):
                        got, want = cuda(*args), plain(*args)
                        torch.cuda.synchronize()
                        check(equal_outputs(got, want), f"{what} kernel != "
                              f"plain version at m={m} K={K}, topk={topk}")
            wide = torch.zeros((nq, nc, K + 1), dtype=code_dtype(m),
                               device="cuda")
            lut = torch.zeros((nq, (K + 1) * m), device="cuda",
                              dtype=torch.int8 if quant else torch.float32)
            calls = [("slab crude", lambda: bs.ivf_crude_topk_cuda(
                          wide, ids, lut, TOPK, sc, of)),
                     ("flat crude", lambda: bs.crude_topk_cuda(
                          wide[0].contiguous(), lut, TOPK, sc, of))]
            if not quant:
                thr0 = torch.zeros((nq,), device="cuda")
                cr = torch.zeros((nq, nc), device="cuda")
                calls += [("slab refine", lambda: bs.ivf_refine_topk_cuda(
                              wide, lut, cr, thr0, TOPK)),
                          ("flat refine", lambda: bs.refine_topk_cuda(
                              wide[0].contiguous(), lut, cr, thr0, TOPK))]
            for what, call in calls:
                try:
                    call()
                    raised = ""
                except ValueError as e:
                    raised = str(e)
                check("shared memory" in raised, f"{what} at m={m} "
                      f"K={K + 1} ({lut_dtype}) did not raise")
            log(f"mode widest codes m={m} ({codes.dtype} rows) K={K} "
                f"{lut_dtype}: "
                + ("slab and flat crude, slab and flat refine" if not quant
                   else "slab and flat crude")
                + f" equal at topk {TOPK} and 2048; K={K + 1} raises a "
                  f"ValueError naming shared memory in each")


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

def time_kernels(seed: int, n: int, m: int = SIFT["m"]):
    """Both kernels at the main path's shape: times, plain times, bounds
    and the largest difference from the plain version.  At another m
    (codes wider than a byte: int32 rows) the same lines are printed
    for the f32 crude and the refine, and the records are of that m."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands,
                                            slow_lut_operand)
    K, d = SIFT["K"], SIFT["d"]
    rows = f"m={m} {code_dtype(m)} rows".replace("torch.", "")
    codes, luts, fast = problem(seed + 100, n, TILE, K, m, d,
                                SIFT["num_fast"], dup=False)
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
    code_bytes = codes.numel() * codes.element_size()
    nbytes = code_bytes + lut_flat.numel() * 4 + TILE * n * 4 \
        + TILE * TOPK * 8
    b_ms, b_by = bound_ms(nbytes, TILE * n * K)
    records["crude_topk"] = dict(
        name="crude_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/batched_search.cu",
        replaces="src/repro/kernels/batched_search.py:168",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel crude_topk f32 8-bit {rows} nq={TILE} n={n}: {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err {err}")

    crude, cv, ci = crude_k
    # the served cells' margin (about 0.3% of the points pass) gives the
    # record; sigma = 0.5 (fewer survivors than topk: the +inf tail) is
    # printed beside it
    for sigma in (SIGMA, 0.5):
        thr = ThresholdStage(topk=TOPK).from_candidates(
            luts, codes, cv, ci, fast, torch.tensor(sigma, device="cuda"))
        ref_k = bs.refine_topk_cuda(codes, lut_slow, crude, thr, TOPK)
        ref_p = bs.refine_topk_torch(codes, lut_slow, crude, thr, TOPK)
        check(equal_outputs(ref_k, ref_p), f"refine kernel != plain version "
              f"at the main path's shape (sigma={sigma})")
        fin = torch.isfinite(ref_k[0])
        err = float((ref_k[0][fin].double() - ref_p[0][fin].double()).abs()
                    .max()) if bool(fin.any()) else 0.0
        ms = time_ms(lambda: bs.refine_topk_cuda(codes, lut_slow, crude, thr,
                                                 TOPK), 20)
        plain_ms = time_ms(lambda: bs.refine_topk_torch(codes, lut_slow,
                                                        crude, thr, TOPK), 3)
        survivors = int((crude < thr[:, None]).sum())
        nbytes = code_bytes + lut_slow.numel() * 4 + TILE * n * 4 \
            + TILE * 4 + TILE * TOPK * 8
        # one compare per point, K adds and one add per survivor
        b_ms, b_by = bound_ms(nbytes, TILE * n + survivors * (K + 1))
        if sigma == SIGMA:
            records["refine_topk"] = dict(
                name="refine_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/search_common.cuh",
                replaces="src/repro/kernels/batched_search.py:441",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
        log(f"kernel refine_topk 8-bit {rows} nq={TILE} n={n} sigma={sigma} "
            f"survivors={survivors} ({survivors / TILE:.1f} per query): "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), max_abs_err {err}")

    if m != SIFT["m"]:
        return records
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

    engine = engine_load(name, path, overrides, query_tile=TILE)
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
        f"bits={index.code_bits} rows={index.codes.dtype} tile={TILE} "
        f"topk={TOPK}: "
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


def slab_crude_sweep(cand_codes, cand_ids, lf):
    """The slab crude kernel alone (f32 8-bit, one launch in a CUDA
    graph, no merge) at 1 to 16 blocks per query beside the plan's
    choice: each block sorts its first chunk and merges the few rows
    below its bar in later ones, so blocks per query trade sorts against
    rounds.  Also prints the slab refine's blocks per query."""
    import ctypes
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels import build
    lib = build.library("ivf_search")
    nq, nc, Kc = cand_codes.shape
    Km = lf.shape[1]
    cb = cand_codes.element_size()
    plan = bs._plan(lib, "icq_ivf_crude_plan", nq, nc, Kc, Km, 0, 0, cb,
                    TOPK)
    refine = bs._plan(lib, "icq_ivf_refine_plan", nq, nc, Kc, Km, 0, cb,
                      TOPK)
    crude = torch.empty((nq, nc), device="cuda")
    times = []
    for grid in sorted({1, 2, 3, 4, 6, 8, 16, plan}):
        cv, ci = bs._lists(nq, grid * TOPK, crude.device)

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.icq_ivf_crude_topk(
                bs._ptr(cand_codes), bs._ptr(cand_ids), bs._ptr(lf), None,
                None, bs._ptr(crude), bs._ptr(cv), bs._ptr(ci), nq, nc, Kc,
                Km, Km // Kc, 0, 0, cb, TOPK, grid, ctypes.c_void_p(stream))
            check(err == 0, f"slab crude launch at grid {grid} failed")
        times.append(f"{grid}{'*' if grid == plan else ''}: "
                     f"{graph_ms(launch) * 1e3:.2f} us")
    log(f"slab crude kernel alone by blocks per query (* the plan's; "
        f"{-(-nc // 1024)} chunks a query): {', '.join(times)}; slab "
        f"refine plan: {refine} blocks per query")


def time_ivf_kernels(engine, q, emb_db=None, centroids=None):
    """The three IVF kernels at the served shape (the slab of one served
    64-query tile; the build's points and centroids): times, plain
    times, bounds, the largest difference from the plain version.
    Without the build's points (a wide-code cell), the two slab kernels
    only, with no sweep of the crude's blocks."""
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
    # a slab kernel takes tens of µs, about its wrapper's host time: the
    # record keeps the eager time, one call in a CUDA graph is printed
    # beside it
    ms = time_ms(lambda: bs.ivf_crude_topk_cuda(cand_codes, cand_ids, lf,
                                                TOPK), 20)
    g_ms = graph_ms(lambda: bs.ivf_crude_topk_cuda(cand_codes, cand_ids, lf,
                                                   TOPK))
    plain_ms = time_ms(lambda: bs.ivf_crude_topk_torch(cand_codes, cand_ids,
                                                       lf, TOPK), 3)
    # the id and the dense crude value of every slab column, the codes of
    # the valid columns only (an invalid column is +inf whatever its
    # codes), the LUT and the top-k, once each
    row_bytes = Kc * cand_codes.element_size()
    nbytes = nq * nc * (4 + 4) + valid * row_bytes + lf.numel() * 4 \
        + nq * TOPK * 8
    b_ms, b_by = bound_ms(nbytes, valid * K)
    records["ivf_crude_topk"] = dict(
        name="ivf_crude_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/search_common.cuh",
        replaces="src/repro/kernels/batched_search.py:320",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel ivf_crude_topk f32 8-bit {cand_codes.dtype} rows "
        f"m={index.C.shape[1]} nq={nq} nc={nc} "
        f"(crude_scan_kernel, launched by ivf_search.cu): {ms:.4f} ms "
        f"(eager; {g_ms:.4f} ms in a CUDA graph), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err}")
    if emb_db is not None:
        slab_crude_sweep(cand_codes, cand_ids, lf)

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
    g_ms = graph_ms(lambda: bs.ivf_refine_topk_cuda(cand_codes, slow, crude,
                                                    thr, TOPK))
    plain_ms = time_ms(lambda: bs.ivf_refine_topk_torch(cand_codes, slow,
                                                        crude, thr, TOPK), 3)
    survivors = int((crude < thr[:, None]).sum())
    # the crude value of every slab column, the codes of the survivors
    # only (the margin test needs no codes), the slow LUT, the
    # thresholds and the top-k, once each; one compare per column, K
    # adds and one add per survivor
    nbytes = nq * nc * 4 + survivors * row_bytes + slow.numel() * 4 + nq * 4 \
        + nq * TOPK * 8
    b_ms, b_by = bound_ms(nbytes, nq * nc + survivors * (K + 1))
    records["ivf_refine_topk"] = dict(
        name="ivf_refine_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/search_common.cuh",
        replaces="src/repro/kernels/batched_search.py:390",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"kernel ivf_refine_topk 8-bit {cand_codes.dtype} rows "
        f"m={index.C.shape[1]} nq={nq} nc={nc} survivors="
        f"{survivors} ({survivors / nq:.1f} per query): {ms:.4f} ms "
        f"(eager; {g_ms:.4f} ms in a CUDA graph), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err}")

    if emb_db is None:
        return records
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
        f"library yardstick argmin(addmm) {lib_ms:.4f} ms (kernel / "
        f"library {ms / lib_ms:.3f}); ids equal on "
        f"{same:.6f} of points ({clear} with a clear nearest), "
        f"max_abs_err {err}")
    return records


def ivf_cells(seed, n, batches, workdir, profile_dir=None):
    """Phase 5: IVF at SIFT1M geometry, k' = 1024, w = 8.  Returns (the
    launches of the build and served windows, the IVF kernel records,
    the path of the f32 8-bit artifact)."""
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    path, launches, emb_db, cent = build_ivf_cell(
        "ivf-8bit", SIFT, "f32", 8, seed=seed, n=n, workdir=workdir,
        check_repeat=True)
    f32_path = path
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
    return total, records, f32_path


# ------------------------------------------- phase 6: encode and grow ----

def encode_problem(seed: int, n: int, d: int = SIFT["d"]):
    """Points on the card: x = decode(C, random codes) + 0.1 noise, C
    (8, 256, d) random codebooks (SIFT1M's d = 128 unless given)."""
    import torch
    from repro_torch.core.codebooks import decode
    K, m = SIFT["K"], SIFT["m"]
    g = torch.Generator(device="cuda").manual_seed(seed + 300)
    C = torch.randn((K, m, d), generator=g, device="cuda") / K ** 0.5
    codes = torch.randint(0, m, (n, K), generator=g, device="cuda")
    x = decode(C, codes) + 0.1 * torch.randn((n, d), generator=g,
                                             device="cuda")
    return x, C


def row_errors(x, C, codes):
    """Squared reconstruction error of every row (n,) f32."""
    import torch
    from repro_torch.core.codebooks import decode
    return torch.sum(torch.square(x - decode(C, codes)), dim=1)


def check_icm(x, C, seed: int, iters: int):
    """The ICM kernel against its plain version on the same CUDA
    tensors; returns its record (time, plain time, bound, largest
    difference of a row's reconstruction error)."""
    import torch
    from repro_torch.core.encode import encode_pq
    from repro_torch.kernels import icm_encode as icm
    n, d = x.shape
    K, m, _ = C.shape
    init = encode_pq(x, C)
    err = 0.0
    for it in (1, iters):
        got = icm.icm_encode_cuda(x, init, C, iters=it)
        want = icm.icm_encode_torch(x, init, C, iters=it)
        torch.cuda.synchronize()
        differ = int((got != want).any(1).sum())
        eg, ew = row_errors(x, C, got), row_errors(x, C, want)
        mse = (float(eg.double().mean()), float(ew.double().mean()))
        err = max(err, float((eg - ew).abs().max()))
        log(f"mode icm_encode n={n} K={K} m={m} d={d} iters={it}: "
            f"{differ} rows differ from the plain version "
            f"({1 - differ / n:.6f} equal), MSE {mse[0]!r} vs plain "
            f"{mse[1]!r}")
        check(differ <= n // 1000 and abs(mse[0] - mse[1])
              <= 1e-5 * abs(mse[1]), f"icm_encode kernel disagrees with "
              f"its plain version at iters={it}: {differ} rows, MSE {mse}")
    g = torch.Generator(device="cuda").manual_seed(seed + 301)
    perm = torch.randperm(n, generator=g, device="cuda")
    same = torch.equal(icm.icm_encode_cuda(x[perm], init[perm], C,
                                           iters=iters), got[perm])
    log(f"icm_encode in a permuted row order: same codes per row: {same}")
    check(same, "icm_encode codes depend on the row order")
    dup = C.clone()
    dup[:, m // 2:] = dup[:, :m // 2]
    rows = min(n, 100_003)                   # ragged against the tile
    wild = torch.randint(0, m, (rows, K), generator=g, device="cuda",
                         dtype=torch.int32)
    tie = [fn(x[:rows], wild, dup, iters=1)
           for fn in (icm.icm_encode_cuda, icm.icm_encode_torch)]
    first = all(int(t.max()) < m // 2 for t in tie)
    log(f"icm_encode with every codeword duplicated (n={rows}): the first "
        f"index wins: {first}")
    check(first, "icm_encode took a later index of an exact tie")

    ms = time_ms(lambda: icm.icm_encode_cuda(x, init, C, iters=iters), 5)
    plain_ms = time_ms(lambda: icm.icm_encode_torch(x, init, C,
                                                    iters=iters), 2)
    # per point and step: m dot products of d FMAs, m scores of a
    # multiply and a subtract, the 3 d adds of the recon chain; plus the
    # K - 1 adds per dimension of the initial recon
    ops = n * iters * K * (m * (2 * d + 2) + 3 * d) + n * (K - 1) * d
    nbytes = n * d * 4 + 2 * n * K * 4 + K * m * d * 4 + K * m * 4
    b_ms, b_by = bound_ms(nbytes, ops)
    log(f"kernel icm_encode n={n} K={K} m={m} d={d} iters={iters}: "
        f"{ms:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err {err}")
    return dict(name="icm_encode", route="cuda",
                source="src/repro_torch/kernels/csrc/icm_encode.cu",
                replaces="src/repro/kernels/icm_encode.py:83",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def time_encode_chunk(x, C, iters: int):
    """``kmeans_assign`` (against one codebook, L = m, as the PQ warm
    start calls it) and the ICM kernel at one encode chunk, the shape at
    which the encode and add windows launch them: kernel times in a CUDA
    graph, plain times eager and the library yardstick both in a graph
    and eager (CUDA events).  At this shape the wrapper splits the
    centroid axis (split-L): the split launch must equal the unsplit one
    bit for bit and agree with the plain version (``compare_assign``).
    Times printed only; the records keep the whole-problem shapes."""
    import torch
    from repro_torch.api import ICQConfig
    from repro_torch.core.encode import encode_pq
    from repro_torch.kernels import icm_encode as icm
    from repro_torch.kernels import kmeans as km
    chunk = ICQConfig().encode.chunk
    K, m, d = C.shape
    xc, cent = x[:chunk].contiguous(), C[0].contiguous()
    csq = cent.square().sum(1)
    split = km.plan(chunk, m, d)[2]
    got = km.kmeans_assign_cuda(xc, cent)
    one = km.kmeans_assign_cuda(xc, cent, _split=1)
    want = km.kmeans_assign_torch(xc, cent)
    torch.cuda.synchronize()
    same = equal_outputs(got, one)
    ok, err, share, clear = compare_assign(got, want, xc, cent)
    log(f"mode kmeans_assign n={chunk} L={m} d={d}: split into {split} "
        f"centroid slices, equal bit for bit to the unsplit launch: "
        f"{same}; against the plain version ids equal on {share:.6f} of "
        f"points ({clear} with a clear nearest), max_abs_err {err}")
    check(split > 1 and same, f"kmeans_assign split ({split} slices) != "
                              "unsplit at the warm start's shape")
    check(ok, "kmeans_assign (split) disagrees with its plain version "
              "beyond the stated tolerance at the warm start's shape")
    ms = graph_ms(lambda: km.kmeans_assign_cuda(xc, cent))
    one_ms = graph_ms(lambda: km.kmeans_assign_cuda(xc, cent, _split=1))
    plain_ms = time_ms(lambda: km.kmeans_assign_torch(xc, cent), 20)

    def library():
        return torch.argmin(torch.addmm(csq, xc, cent.T, alpha=-2.0), 1)

    lib_graph_ms = graph_ms(library)
    lib_ms = time_ms(library, 20)
    b_ms, b_by = bound_ms((chunk * d + m * d + m) * 4 + chunk * 8,
                          2 * chunk * m * d)
    log(f"kernel kmeans_assign n={chunk} L={m} d={d} (one warm-start "
        f"launch): {ms:.5f} ms (CUDA graph; {one_ms:.5f} ms unsplit), "
        f"plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}), two-call "
        f"library yardstick argmin(addmm) {lib_graph_ms:.5f} ms (CUDA "
        f"graph), {lib_ms:.5f} ms eager")
    init = encode_pq(xc, C)
    grid = icm.plan(chunk, K, m, d, iters)["grid"]
    ms = graph_ms(lambda: icm.icm_encode_cuda(xc, init, C, iters=iters), 10)
    plain_ms = time_ms(lambda: icm.icm_encode_torch(xc, init, C,
                                                    iters=iters), 3)
    ops = chunk * iters * K * (m * (2 * d + 2) + 3 * d) + chunk * (K - 1) * d
    b_ms, b_by = bound_ms(chunk * d * 4 + 2 * chunk * K * 4
                          + K * m * d * 4 + K * m * 4, ops)
    log(f"kernel icm_encode n={chunk} K={K} m={m} d={d} iters={iters} (one "
        f"encode launch): {ms:.5f} ms (CUDA graph; {grid} CTAs; "
        f"{ops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.5f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")


def encode_window(x, C, iters: int):
    """``encode_database`` of all points at the config's chunk, launch
    counts reset before and read after; checked against a direct
    ``icm_encode``.  Returns (codes, launches)."""
    import torch
    from repro_torch.api import ICQConfig
    from repro_torch.core.encode import icm_encode, pack_codes
    from repro_torch.trainer import encode_database
    n = x.shape[0]
    chunk = ICQConfig().encode.chunk
    times = {}
    for c in (chunk, n):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        codes = encode_database(x, C, icm_iters=iters, chunk=c)
        torch.cuda.synchronize()
        times[c] = time.perf_counter() - t0
        if c == chunk:
            launches = read_launches()
    log(f"encode_database n={n} iters={iters}: chunk {chunk}: "
        f"{times[chunk]:.4f} s ({n / times[chunk]:.0f} points/s), chunk "
        f"{n} (one launch per kernel): {times[n]:.4f} s "
        f"({n / times[n]:.0f} points/s) (host clock, ending in a "
        f"synchronize); launches at chunk {chunk}: {launches}")
    direct = pack_codes(icm_encode(x, C, iters), C.shape[1])
    check(torch.equal(codes, direct) and codes.dtype == torch.uint8,
          "encode_database != a direct icm_encode of the same rows")
    check(launches["icm_encode"] > 0, "encode_database launched no "
                                      "icm_encode kernel")
    return codes, launches


def grow_cell(kind, x, C, codes_all, *, seed, workdir):
    """Build ``kind`` from the first 90% of the points, ``AnnEngine.add``
    the rest (counts reset before, read after) and hold the grown index
    against the one built over all points at once.  Returns the add's
    launches."""
    import numpy as np
    import torch
    from repro_torch.api import Artifacts, build_index
    from repro_torch.api.artifacts import index_opts
    from repro_torch.index import make_index
    from repro_torch.index.ivf import ivf_assign
    n, d = x.shape
    n0 = n - n // 10
    cfg = cell_config(SIFT, kind, "f32", 8)
    fast = torch.arange(SIFT["K"], device="cuda") < SIFT["num_fast"]
    structure = (torch.ones(d, dtype=torch.bool, device="cuda"), fast,
                 torch.tensor(SIGMA, device="cuda"))
    emb = {"emb_db": x[:n0], "generator": seed} if kind == "ivf" else {}
    index = build_index(codes_all[:n0], C, structure, index_cfg=cfg.index,
                        serve_cfg=cfg.serve, device="cuda", **emb)
    engine = engine_over(f"grow-{kind}", index, query_tile=TILE)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    engine.add(x[n0:])
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["icm_encode"] > 0 and launches["kmeans_assign"] > 0,
          f"grow {kind}: the add launched icm_encode "
          f"{launches['icm_encode']} and kmeans_assign "
          f"{launches['kmeans_assign']} times")
    grown = engine.index
    if kind == "ivf":
        ivf = ivf_assign(index.ivf.centroids, x)
        full = make_index("ivf", codes_all, C, structure, device="cuda",
                          ivf=ivf, **index_opts(cfg.index, cfg.serve))
        same = (torch.equal(grown.ivf.lists, full.ivf.lists)
                and torch.equal(grown.ivf.list_lens, full.ivf.list_lens)
                and torch.equal(grown.list_codes, full.list_codes))
        check(same, "grow ivf: lists or in-list codes != ivf_assign over "
                    "all points")
    else:
        full = build_index(codes_all, C, structure, index_cfg=cfg.index,
                           serve_cfg=cfg.serve, device="cuda")
    check(torch.equal(grown.codes, full.codes),
          f"grow {kind}: codes != the one-shot build's")
    rng = np.random.default_rng(seed + 13)
    q = torch.from_numpy(rng.standard_normal((TILE, d),
                                             dtype=np.float32)).cuda()
    r = engine.search(q)
    want = engine_over(f"one-shot-{kind}", full, query_tile=TILE).search(q)
    path = os.path.join(workdir, f"grown-{kind}")
    Artifacts(config=cfg, index=grown).save(path)
    loaded = engine_load(f"grown-{kind}", path, query_tile=TILE)
    again = loaded.search(q)
    same = all(torch.equal(a.indices, r.indices)
               and torch.equal(a.distances, r.distances)
               for a in (want, again))
    log(f"grow {kind}: {n0} + {n - n0} points, add {add_s:.4f} s (host "
        f"clock, ending in a synchronize; {(n - n0) / add_s:.0f} "
        f"points/s); launches {launches}; codes"
        + (", lists, list_lens and in-list codes" if kind == "ivf" else "")
        + f" equal to the one-shot build; served tile equal to the one-shot "
        f"index's and after save + load_ann_engine: {same}; "
        f"pass_rate={float(r.pass_rate):.6f} n={loaded.n}")
    check(same and loaded.n == n, f"grow {kind}: the grown, the one-shot "
                                  "and the reloaded index serve different "
                                  "answers")
    return launches


def encode_and_grow(seed: int, n: int, workdir):
    """Phase 6.  Returns (the launches of the encode and add windows, the
    icm_encode record)."""
    iters = ICM_ITERS
    xw, Cw = encode_problem(seed + 1, min(n, WIDE_ICM["n"]), WIDE_ICM["d"])
    check_icm(xw, Cw, seed + 1, iters)        # printed, not recorded
    del xw, Cw
    x, C = encode_problem(seed, n)
    record = check_icm(x, C, seed, iters)
    time_encode_chunk(x, C, iters)
    codes, launches = encode_window(x, C, iters)
    total = dict(launches)
    for kind in ("two-step", "ivf"):
        for k, v in grow_cell(kind, x, C, codes, seed=seed,
                              workdir=workdir).items():
            total[k] += v
    return total, record


# ------------------------------------------------ phase 7: kernel ops ----

FLASH_MODES = (   # b, sq, sk, H, KVH, dqk, dv, causal
    (1, 64, 64, 4, 4, 32, 32, True),
    (2, 128, 128, 8, 2, 64, 64, True),
    (1, 64, 256, 4, 1, 32, 32, False),       # cross-length, MQA
    (2, 256, 256, 8, 8, 128, 128, True),
    (1, 1000, 1000, 8, 1, 64, 64, True),     # ragged against the tile
    (1, 333, 1111, 4, 2, 128, 128, True),    # sq < sk, GQA
    (2, 700, 130, 6, 3, 32, 32, False),      # sq > sk
    (1, 700, 130, 4, 4, 128, 128, True),     # sq > sk, causal
    (1, 300, 300, 2, 1, 256, 256, True),     # gemma-7b's head width
    # DeepSeek-V2's MLA widths: q/k 128 nope + 64 rope, v 128
    (1, 1000, 1000, 8, 8, 192, 128, True),   # ragged, MHA
    (2, 64, 200, 4, 1, 192, 128, False),     # cross-length, MQA
    (1, 130, 77, 4, 2, 192, 128, True),      # sq > sk, GQA
)


def flash_tolerance(dtype) -> float:
    import torch
    return 2e-5 if dtype == torch.float32 else 2e-2


def flash_body(dtype, dh, dv=None) -> str:
    """The flash body that runs for ``dtype`` at (``dh``, ``dv``; ``dv``
    defaults to ``dh``): its path, and its registers and local-memory
    (spill) bytes per thread."""
    from repro_torch.kernels import flash_attention as fa
    a = fa.kernel_attributes(dtype, dh, dv)
    return (f"{a['path']}, {a['registers']} registers, "
            f"{a['local_bytes']} B local per thread")


def attention_operands(seed, b, sq, sk, H, KVH, dh, dtype, dv=None):
    """Random q (b, sq, H, dh), k (b, sk, KVH, dh) and v (b, sk, KVH, dv;
    dv defaults to dh) on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, sq, H, dh), (b, sk, KVH, dh),
                          (b, sk, KVH, dv or dh))]


def check_kernel_ops(seed: int):
    """Phase 7 (a): the ADC, two-step and flash kernels against their
    plain versions on ragged shapes, launch counts reset before and
    read after (these launches are checks, not the main path)."""
    import torch
    from repro_torch.kernels import adc, two_step
    from repro_torch.kernels import flash_attention as fa
    reset_launches()
    n = 100_003                              # ragged against every block
    for K, m in ((2, 16), (8, 256), (16, 16), (16, 256)):
        g = torch.Generator(device="cuda").manual_seed(seed + 40 + K + m)
        codes = torch.randint(0, m, (n, K), generator=g, device="cuda",
                              dtype=torch.int32)
        codes[n // 2:n // 2 + 9] = codes[3]
        lut = torch.randn((K, m), generator=g, device="cuda")
        fast = torch.arange(K, device="cuda") < max(1, K // 4)
        for dtype in (torch.uint8, torch.int32):
            c = codes.to(dtype)
            ok = torch.equal(adc.adc_cuda(c, lut), adc.adc_torch(c, lut))
            crude = two_step.two_step_torch(c, lut, fast, 0.0)[0]
            passes = []
            for thr in (crude.min(), crude.median(), crude.max() + 1.0):
                got = two_step.two_step_cuda(c, lut, fast, thr)
                want = two_step.two_step_torch(c, lut, fast, thr)
                ok = ok and equal_outputs(got, want)
                passes.append(int(got[1].sum()))
            torch.cuda.synchronize()
            ok = ok and passes[0] == 0 and 0 < passes[1] < n \
                and passes[2] == n
            log(f"mode adc + two_step n={n} K={K} m={m} "
                f"{str(dtype).split('.')[-1]} rows, passed {passes}: "
                f"{'equal' if ok else 'DIFFERENT'}")
            check(ok, f"adc/two_step kernel != plain version (K={K}, m={m},"
                      f" {dtype}) or wrong pass counts {passes}")
    for mode in FLASH_MODES:
        b, sq, sk, H, KVH, dh, dv, causal = mode
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attention_operands(seed + sq + dh, b, sq, sk, H, KVH,
                                         dh, dtype, dv)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = fa.flash_attention_torch(q, k, v, causal=causal)
            torch.cuda.synchronize()
            tol = flash_tolerance(dtype)
            err = float((got.float() - want.float()).abs().max())
            ok = (got.dtype == dtype and got.shape == want.shape
                  and bool(torch.isclose(got.float(), want.float(), rtol=tol,
                                         atol=tol).all()))
            log(f"mode flash_attention b={b} sq={sq} sk={sk} H={H} KVH={KVH}"
                f" dh={dh} dv={dv} causal={causal} "
                f"{str(dtype).split('.')[-1]} ({flash_body(dtype, dh, dv)}):"
                f" max_abs_err {err} (tolerance "
                f"{tol}): {'within' if ok else 'OUTSIDE'}")
            check(ok, f"flash_attention kernel != plain version {mode} "
                      f"{dtype}: max_abs_err {err}")
    log(f"phase 7 check launches: {read_launches()}")


def attention_work(b, sq, sk, H, KVH, dh, causal, itemsize, dv=None):
    """(bytes, operations) of one attention call: q (width dh), k (dh),
    v (dv, default dh) read and out (dv) written once; per visible
    (query, key) pair 2 dh operations of Q . K^T and 2 dv of P . V,
    counting only the causal part."""
    dv = dv or dh
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    nbytes = itemsize * (b * sq * H * (dh + dv) + b * sk * KVH * (dh + dv))
    return nbytes, 2 * b * H * (dh + dv) * pairs


def kernel_ops(seed: int, n: int):
    """Phase 7 (b, c): the kernel ops once each at full width through
    ``ops`` (ADC and two-step over ``n`` points), launch counts reset
    before and read after; outputs checked against the plain versions;
    then times, bounds and yardsticks.  Returns (the window's launches,
    the three records)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.index.base import build_lut
    from repro_torch.kernels import adc, ops, two_step
    from repro_torch.kernels import flash_attention as fa
    K, m, d = SIFT["K"], SIFT["m"], SIFT["d"]
    g = torch.Generator(device="cuda").manual_seed(seed + 400)
    C = torch.randn((K, m, d), generator=g, device="cuda") / K ** 0.5
    codes = torch.randint(0, m, (n, K), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    lut = build_lut(torch.randn((d,), generator=g, device="cuda"), C)
    fast = torch.arange(K, device="cuda") < SIFT["num_fast"]
    thr = torch.quantile(two_step.two_step_torch(codes, lut, fast, 0.0)[0],
                         PASS_QUANTILE)
    cells = [(name, w, getattr(torch, dt)) for name, w, dts in ATTENTION
             for dt in dts]
    qkv = [attention_operands(seed + 500 + i, w["b"], w["s"], w["s"], w["H"],
                              w["KVH"], w["dh"], dt)
           for i, (_, w, dt) in enumerate(cells)]
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    dist = ops.adc(codes, lut)
    crude, passed = ops.two_step(codes, lut, fast, thr)
    attn = [ops.flash_attention(*t, causal=True) for t in qkv]
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    launches = read_launches()
    want = {k: 0 for k in launches}
    want.update(adc=1, two_step=1, flash_attention=len(cells))
    log(f"kernel ops window: {window_s:.4f} s (host clock, first calls); "
        f"launches {launches}")
    check(launches == want, f"kernel ops launch counts {launches} != {want}")

    records = {}
    want = adc.adc_torch(codes, lut)
    check(torch.equal(dist, want) and bool(torch.isfinite(dist).all()),
          "ops.adc at full width != plain version")
    want_c, want_p = two_step.two_step_torch(codes, lut, fast, thr)
    rate = float(passed.float().mean())
    check(torch.equal(crude, want_c) and torch.equal(passed, want_p)
          and 0 < rate < 0.01, f"ops.two_step at full width != plain "
                               f"version or pass rate {rate}")
    errs = {"adc": float((dist.double() - want.double()).abs().max()),
            "two_step": float((crude.double() - want_c.double()).abs()
                              .max())}
    # the library yardstick of ADC: one embedding_bag over the flat LUT
    # with the codes shifted to k m + code (int64, made outside the timed
    # call); none computes the two-step in one call
    flat = (codes.long() + torch.arange(K, device="cuda") * m).contiguous()
    table = lut.reshape(-1, 1)
    for name, call, plain, library, out_bytes, replaces in (
            ("adc", lambda: adc.adc_cuda(codes, lut),
             lambda: adc.adc_torch(codes, lut),
             lambda: F.embedding_bag(flat, table, mode="sum"), n * 4,
             "src/repro/kernels/adc.py:49"),
            ("two_step", lambda: two_step.two_step_cuda(codes, lut, fast, thr),
             lambda: two_step.two_step_torch(codes, lut, fast, thr), None,
             n * 8, "src/repro/kernels/two_step.py:36")):
        ms = graph_ms(call)
        eager_ms = time_ms(call, 50)
        plain_ms = time_ms(plain, 10)
        lib_ms = graph_ms(library) if library else None
        b_ms, b_by = bound_ms(n * K + K * m * 4 + out_bytes, n * K)
        records[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/adc.cu", replaces=replaces,
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        log(f"kernel {name} n={n} K={K} m={m} uint8 rows: {ms:.5f} ms (CUDA "
            f"graph of 50 calls), {eager_ms:.5f} ms per eager call (CUDA "
            f"events, host launch included), plain {plain_ms:.5f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}), library "
            + (f"embedding_bag(codes + k m, lut, sum) {lib_ms:.5f} ms (CUDA "
               "graph)" if library else "none: no single call")
            + (f"; pass rate {rate:.6f} at the {PASS_QUANTILE} quantile"
               if name == "two_step" else ""))

    for (name, w, dtype), (q, k, v), got in zip(cells, qkv, attn):
        want = fa.flash_attention_torch(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = flash_tolerance(dtype)
        check(bool(torch.isfinite(got.float()).all()) and bool(torch.isclose(
            got.float(), want.float(), rtol=tol, atol=tol).all()),
            f"ops.flash_attention {name} {dtype} != plain version: "
            f"max_abs_err {err}")
        del want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
        sdpa_err = float((sdpa.transpose(1, 2).float() - got.float()).abs()
                         .max())
        del sdpa
        ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v), 5)
        plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v), 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        nbytes, nops = attention_work(w["b"], w["s"], w["s"], w["H"],
                                      w["KVH"], w["dh"], True,
                                      q.element_size())
        b_ms, b_by = bound_ms(nbytes, nops, BF16_OPS_PER_S
                              if dtype == torch.bfloat16 else F32_OPS_PER_S)
        log(f"kernel flash_attention {name} b={w['b']} s={w['s']} H={w['H']}"
            f" KVH={w['KVH']} dh={w['dh']} causal "
            f"{str(dtype).split('.')[-1]} ({flash_body(dtype, w['dh'])}): "
            f"{ms:.4f} ms "
            f"({nops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), library "
            f"scaled_dot_product_attention {lib_ms:.4f} ms "
            f"({nops / lib_ms / 1e9:.2f} TFLOP/s), kernel / SDPA "
            f"{ms / lib_ms:.2f}; max_abs_err {err}, against SDPA {sdpa_err}")
        # the record keeps the last, widest cell (llama3-405b, bf16)
        records["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:71",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
    return launches, records


# ------------------------------------------------- phase 8: the ladder ----

def crude_reference(index, q):
    """The crude rung composed by hand from the plain versions on the same
    CUDA tensors: the crude top-k the full path bootstraps its threshold
    from (ids through the slab for IVF); for FlatADC the full search.
    Returns (ids, distances)."""
    import torch
    from repro_torch.index.base import build_lut
    from repro_torch.index.flat import FlatADC
    from repro_torch.index.ivf import (IVFTwoStep, coarse_probe,
                                       gather_candidates)
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import crude_lut_operands
    if isinstance(index, FlatADC):
        return plain_composition(index, q)
    quant, bits, topk = index.lut_dtype == "int8", index.code_bits, index.topk
    lf, sc, of = crude_lut_operands(build_lut(q, index.C),
                                    index.structure.fast_mask,
                                    quantized=quant, code_bits=bits)
    if isinstance(index, IVFTwoStep):
        probes = coarse_probe(q, index.ivf.centroids, index.n_probe)
        cand_ids, cand_codes = gather_candidates(probes, index.ivf.lists,
                                                 index.list_codes, topk)
        _, vals, pos = bs.ivf_crude_topk_torch(cand_codes, cand_ids, lf,
                                               topk, sc, of, code_bits=bits)
        safe = torch.where(cand_ids >= 0, cand_ids,
                           torch.zeros_like(cand_ids))
        return safe.gather(1, pos.long()), vals
    _, vals, idx = bs.crude_topk_torch(index.codes, lf, topk, sc, of,
                                       want_crude=False, code_bits=bits)
    return idx, vals


def rung_launches(index, level, batches):
    """Launches of one served window at a rung: the full and probes rungs
    as ``expected_launches``; the crude rung the crude kernel once a
    tile and the refine never."""
    want = expected_launches(index, batches)
    if level == "crude":
        for k in ("refine_topk", "ivf_refine_topk"):
            want[k] = 0
    return want


LADDER = {"TwoStep": ("full", "crude"), "FlatADC": ("full", "crude"),
          "IVFTwoStep": ("full", "probes", "crude")}


def ladder_cell(name, path, *, seed, batches, card):
    """Phase 8 on one saved cell: every rung the card offers, served in
    64-query tiles (warmed once, launch counts reset before and read
    after), each held against its reference on the same CUDA tensors;
    then a deadline below the crude rung's measured time, and the
    options the card refuses.  Returns the rungs' launches."""
    import numpy as np
    import torch
    from repro_torch.index.flat import FlatADC
    from repro_torch.resilience import SearchBudget

    engine = engine_load(f"ladder-{name}", path, query_tile=TILE)
    index = engine.index
    d = int(index.C.shape[-1])
    levels = engine._levels()
    check(levels == LADDER[type(index).__name__],
          f"ladder {name}: rungs {levels}")
    rng = np.random.default_rng(seed + 17)
    queries = [torch.from_numpy(rng.standard_normal((TILE, d),
                                                    dtype=np.float32)).cuda()
               for _ in range(batches)]
    total = {k: 0 for k in read_launches()}
    for level in levels:
        budget = SearchBudget(force_level=level)
        engine.warm(TILE, budget=budget)
        torch.cuda.synchronize()
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        results = [engine.search(q, budget=budget) for q in queries]
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / batches
        dev_ms = start.elapsed_time(end) / batches
        launches = read_launches()
        lidx = engine._level_index(level, budget)
        want = rung_launches(lidx, level, batches)
        check(launches == want, f"ladder {name} {level}: launch counts "
                                f"{launches} != {want}")
        for k in total:
            total[k] += launches[k]
        r, q = results[-1], queries[-1]
        check(all(x.meta.level_name == level and x.meta.backend == "cuda"
                  for x in results), f"ladder {name} {level}: meta "
                                     f"{r.meta}")
        if level == "crude":
            ids, dist = crude_reference(index, q)
            what = "the plain crude top-k"
        elif level == "probes":
            check(lidx.n_probe == index.n_probe // 2 == 4,
                  f"ladder {name}: probes rung at n_probe {lidx.n_probe}")
            at4 = engine_load(f"ladder-{name}-n_probe4", path,
                              {"index.n_probe": 4}, query_tile=TILE)
            w = at4.search(q)
            ids, dist = w.indices, w.distances
            p_ids, p_dist = plain_composition(lidx, q)
            check(torch.equal(p_ids, ids) and torch.equal(p_dist, dist),
                  f"ladder {name}: n_probe 4 != its plain composition")
            what = "full at n_probe 4"
        else:
            ids, dist = plain_composition(index, q)
            what = "the plain composition"
        same = torch.equal(ids, r.indices) and torch.equal(dist, r.distances)
        check(same, f"ladder {name} {level}: served top-k != {what}")
        log(f"ladder {name} rung {level}: {dev_ms:.4f} ms per 64-query "
            f"tile (events), {host_ms:.4f} ms (host clock), {batches} "
            f"tiles; stages {r.meta.stages}, degraded {r.meta.degraded}, "
            f"pass_rate={float(r.pass_rate):.6f} "
            f"avg_ops={float(r.avg_ops):.6f}; launches {launches}; equal "
            f"to {what}: {same}; {card}")
    # every rung has a warm estimate now; a deadline below the crude
    # rung's fits none, and the crude floor serves
    crude_ms = engine._ema["crude"]
    deadline = 0.5 * crude_ms
    r = engine.search(queries[0], budget=SearchBudget(deadline_ms=deadline))
    check(r.meta.level_name == "crude" and r.meta.degraded
          and r.meta.deadline_ms == deadline,
          f"ladder {name}: deadline {deadline} ms served {r.meta}")
    log(f"ladder {name}: EMAs {dict(engine._ema)} ms; deadline "
        f"{deadline:.4f} ms (half the crude rung's) served rung "
        f"{r.meta.level_name} (level {r.meta.level}, degraded "
        f"{r.meta.degraded}, wall {r.meta.wall_ms:.4f} ms, exceeded "
        f"{r.meta.deadline_exceeded})")
    # options the card refuses with the reference's words
    q = queries[0]
    refused = []
    calls = [("filter", "filtered search requires backend='jnp'",
              lambda: engine.search(q, filter=torch.ones(
                  engine.n, dtype=torch.bool, device="cuda")))]
    if not isinstance(index, FlatADC):
        calls += [("refine_cap", "refine_cap compaction requires "
                   "backend='jnp'", lambda: engine_load(
                       f"ladder-{name}-refine_cap", path,
                       {"index.refine_cap": 64}).search(q)),
                  ("capped rung", "not servable", lambda: engine.search(
                      q, budget=SearchBudget(force_level="capped")))]
    for what, words, call in calls:
        try:
            call()
            msg = ""
        except ValueError as e:
            msg = str(e)
        check(words in msg, f"ladder {name}: {what} on the card did not "
                            f"raise ({msg!r})")
        refused.append(what)
    log(f"ladder {name}: on the card {', '.join(refused)} raise the "
        f"reference's ValueError")
    return total


def raise_then_pass_seed(p: float) -> int:
    """The first seed whose ``FaultInjector`` raises on its first check
    and not on its second (each check draws three uniforms: raise, delay,
    corrupt)."""
    import numpy as np
    for seed in range(1000):
        u = np.random.default_rng(seed).random(6)
        if u[0] < p <= u[3]:
            return seed
    raise SmokeFailure("no fault seed found")


def fault_check(path, *, seed):
    """A ``FaultInjector`` fault at ``kernels.batched_crude_topk`` fails
    the first attempt of a two-step batch; the engine (max_retries 1)
    retries it in place: one retry, no failover, the clean top-k."""
    import numpy as np
    import torch
    from repro_torch.api import load_ann_engine
    from repro_torch.resilience import FaultInjector, FaultSpec
    stage = "kernels.batched_crude_topk"
    rng = np.random.default_rng(seed + 19)
    q = torch.from_numpy(rng.standard_normal((TILE, SIFT["d"]),
                                             dtype=np.float32)).cuda()
    clean = engine_load("fault-clean", path, query_tile=TILE).search(q)
    engine = load_ann_engine(path, query_tile=TILE, overrides={
        "resilience.max_retries": 1, "resilience.backoff_base_ms": 1.0})
    inj = FaultInjector(seed=raise_then_pass_seed(0.5),
                        spec=FaultSpec(p_raise=0.5, targets=(stage,)))
    reset_launches()
    with inj.installed():
        r = engine.search(q)
    torch.cuda.synchronize()
    launches = read_launches()
    same = (torch.equal(r.indices, clean.indices)
            and torch.equal(r.distances, clean.distances))
    log(f"fault check two-step-f32: {inj.counts} at {stage}, "
        f"max_retries=1: retries {engine.stats['retries']}, failovers "
        f"{engine.stats['failovers']}, launches {launches}; same top-k as "
        f"the clean engine: {same}")
    check(inj.counts == {f"{stage}:raise": 1}
          and engine.stats["retries"] == 1
          and engine.stats["failovers"] == 0 and same
          and launches["crude_topk"] == 1 and launches["refine_topk"] == 1,
          "fault check: the injected fault was not retried once in place")


# --------------------------------------------- phase 9: wide-code cells ----

# codes wider than a byte at SIFT1M's width: m = 1024 codewords, stored
# as int32 rows (32 MB of codes at 1M points)
WIDE = dict(d=128, K=8, m=1024, num_fast=2)


def wide_cells(seed, n, batches, workdir):
    """Phase 9: a two-step f32 and an IVF f32 index at m = 1024 (int32
    rows), each saved, loaded with ``load_ann_engine``, served in
    64-query tiles equal to the plain composition; the four scan
    kernels timed over int32 rows beside their byte bounds.  Returns
    the launches."""
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    time_kernels(seed + 300, n, m=WIDE["m"])
    path = save_flat_cell("wide-two-step", WIDE, "two-step", "f32", 8,
                          seed=seed + 5, n=n, workdir=workdir)
    launches, engine, _ = serve_saved("two-step-f32-m1024", path,
                                      seed=seed, n=n, batches=batches)
    add(launches)
    del engine
    path, launches, _, _ = build_ivf_cell(
        "ivf-m1024", WIDE, "f32", 8, seed=seed + 5, n=n, workdir=workdir,
        check_repeat=False)
    add(launches)
    launches, engine, q = serve_saved("ivf-f32-m1024", path, seed=seed,
                                      n=n, batches=batches)
    add(launches)
    time_ivf_kernels(engine, q)
    return total


# ------------------------------------------ phase 10: the request path ----

# the pipelined cells: batches of 512 queries (8 tiles of 64, the
# reference's block_q) and one ragged batch of 200 (3 tiles and 8 rows)
PIPE_BATCH, PIPE_RAGGED = 512, 200
# the serving-loop cell: Poisson arrivals at 1000 requests/s for 2 s
# (seed 0), 1, 2 or 4 rows a request, over two tenants whose lanes take
# the config's serve.batch_tile (32 rows) and serve.batch_window_ms (2)
LOOP = dict(rate_hz=1000.0, duration_s=2.0, seed=0, rows=(1, 2, 4),
            pool=256)
GT_QUERIES = 64
SCALARS = ("pass_rate", "avg_ops")
TOPK_FIELDS = ("indices", "distances")


def same_result(a, b, fields=TOPK_FIELDS + SCALARS) -> bool:
    import torch
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def served_window(engine, batches, budget):
    """Serve ``batches`` at one rung with the launch counts reset before
    and read after.  Returns (results, ms per batch (events), ms per
    batch (host clock), launches, peak MB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results = [engine.search(q, budget=budget) for q in batches]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    return (results, start.elapsed_time(end) / len(batches), host_ms,
            read_launches(), torch.cuda.max_memory_allocated() / 2 ** 20)


def trace_kernels(trace_path):
    """(name, stream, start us, end us) of every device kernel in a
    Chrome trace written by ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for ev in events:
        if ev.get("cat") == "kernel" and "dur" in ev:
            stream = ev.get("args", {}).get("stream", ev.get("tid"))
            out.append((ev.get("name", ""), stream, float(ev["ts"]),
                        float(ev["ts"]) + float(ev["dur"])))
    return out


def busy_union_us(kernels) -> float:
    """Device time covered by at least one kernel (us)."""
    busy, end = 0.0, float("-inf")
    for _, _, s, e in sorted(kernels, key=lambda k: k[2]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_pipelined(label, engine, batches, out_dir, card):
    """With ``--profile``: ``torch.profiler`` over ``batches`` served by
    one engine.  Prints the device's idle share (1 - the time at least
    one kernel ran / host wall), the time two kernels ran at once, and
    the streams the crude and refine scan kernels ran on.  Returns the
    number of distinct streams of those kernels (None when the trace
    shows no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in batches:
            engine.search(q)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{label}.json")
    prof.export_chrome_trace(path)
    kernels = trace_kernels(path)
    if not kernels:
        log(f"profile {label}: the trace holds no device kernel: idle "
            f"share and streams not measured")
        return None
    busy = busy_union_us(kernels)
    total = sum(e - s for _, _, s, e in kernels)
    crude = sorted({s for n, s, _, _ in kernels if "crude_scan_kernel" in n})
    refine = sorted({s for n, s, _, _ in kernels
                     if "refine_scan_kernel" in n})
    n_b = len(batches)
    log(f"profile {label}: {wall_us / 1e3 / n_b:.4f} ms per batch (host "
        f"clock, profiler on), device busy {busy / 1e3 / n_b:.4f} ms per "
        f"batch, idle share {1.0 - busy / wall_us:.4f}, kernels "
        f"overlapping {(total - busy) / 1e3 / n_b:.4f} ms per batch, "
        f"{len(kernels) / n_b:.1f} kernels per batch; crude scan kernel "
        f"on streams {crude}, refine scan kernel on streams {refine}: "
        f"{len(set(crude) | set(refine))} distinct; {card}")
    return len(set(crude) | set(refine))


def pipelined_cell(name, path, *, seed, batches, card, profile_dir=None):
    """Phase 10, one saved cell served pipelined (``serve.pipeline =
    "tiles"``, tile 64, no engine tiling) at every rung the card offers,
    over ``batches`` batches of 512 queries and one of 200.  Each result
    must equal the ``pipeline="off"``, ``query_tile=64`` engine's ids and
    distances bit for bit, and all four fields of the sequential index
    over the same 64-query blocks (``serve.query_chunk = 64``), whose
    pass_rate and avg_ops fold the same per-query vector; the launch
    counts must equal the tiled engine's.  Returns the pipelined
    windows' launches."""
    import numpy as np
    import torch
    from repro_torch.resilience import SearchBudget

    piped = engine_load(f"pipelined-{name}", path, {
        "serve.pipeline": "tiles", "serve.pipeline_tile": TILE})
    off = engine_load(f"off-{name}", path, query_tile=TILE)
    chunked = engine_load(f"off-chunked-{name}", path,
                          {"serve.query_chunk": TILE})
    d = int(piped.index.C.shape[-1])
    rng = np.random.default_rng(seed + 23)

    def batch(nq):
        return torch.from_numpy(rng.standard_normal(
            (nq, d), dtype=np.float32)).cuda()

    full = [batch(PIPE_BATCH) for _ in range(batches)]
    ragged = batch(PIPE_RAGGED)
    total = {k: 0 for k in read_launches()}
    for level in piped._levels():
        budget = SearchBudget(force_level=level)
        for e in (piped, off, chunked):
            e.warm(PIPE_BATCH, budget=budget)
        res_p, ms_p, host_p, l_p, mb_p = served_window(piped, full, budget)
        res_o, ms_o, host_o, l_o, mb_o = served_window(off, full, budget)
        want = rung_launches(piped._level_index(level, budget), level,
                             batches * PIPE_BATCH // TILE)
        check(l_p == want and l_o == want,
              f"pipelined {name} {level}: launches {l_p} (off {l_o}) != "
              f"{want}")
        for k in total:
            total[k] += l_p[k]
        res_p.append(piped.search(ragged, budget=budget))
        res_o.append(off.search(ragged, budget=budget))
        seq = [chunked.search(q, budget=budget) for q in full + [ragged]]
        topk_equal = all(same_result(p, o, TOPK_FIELDS)
                         for p, o in zip(res_p, res_o))
        seq_equal = all(same_result(p, s) for p, s in zip(res_p, seq))
        tiled_scalars = all(same_result(p, o, SCALARS)
                            for p, o in zip(res_p, res_o))
        check(all(r.meta.level_name == level and r.meta.backend == "cuda"
                  for r in res_p), f"pipelined {name} {level}: meta "
                                   f"{res_p[-1].meta}")
        check(tuple(res_p[-1].indices.shape) == (PIPE_RAGGED, TOPK),
              f"pipelined {name}: ragged shape "
              f"{tuple(res_p[-1].indices.shape)}")
        check(topk_equal, f"pipelined {name} {level}: ids or distances != "
                          f"the pipeline=off, query_tile=64 engine")
        check(seq_equal, f"pipelined {name} {level}: result != the "
                         f"sequential index over the same tiles")
        r = res_p[0]
        log(f"pipelined {name} rung {level}: {PIPE_BATCH}-query batch "
            f"{ms_p:.4f} ms (events), {host_p:.4f} ms (host clock), "
            f"pipelined; {ms_o:.4f} / {host_o:.4f} ms off (query_tile "
            f"64); {batches} batches each, then one of {PIPE_RAGGED}; "
            f"launches {l_p} (off {l_o}); peak {mb_p:.1f} MB pipelined, "
            f"{mb_o:.1f} MB off; pass_rate={float(r.pass_rate):.6f} "
            f"avg_ops={float(r.avg_ops):.6f}; ids and distances equal to "
            f"the off engine: {topk_equal}; all four fields equal to the "
            f"sequential index over the same tiles (query_chunk 64): "
            f"{seq_equal}; pass_rate and avg_ops equal to the off "
            f"engine's tile means too: {tiled_scalars}; {card}")
    if profile_dir:
        streams = profile_pipelined(f"pipelined_{name}", piped, full,
                                    profile_dir, card)
        profile_pipelined(f"off_{name}", off, full, profile_dir, card)
        check(streams in (None, 2), f"pipelined {name}: the crude and "
                                    f"refine kernels ran on {streams} "
                                    f"streams, not 2")
    return total


def serving_loop_cell(paths, *, card):
    """Phase 10, the serving loop: the two-step-f32 and ivf-f32
    artifacts as two tenants of one ``ServingLoop`` (lanes of the
    config's 32 rows and 2 ms; each engine's ``query_tile`` pinned to
    32), warmed once, under ``run_open_loop`` of ``make_workload``
    (1000 requests/s for 2 s, seed 0, 1, 2 or 4 rows a request).  Every
    response must equal its tenant engine's direct call on the request's
    rows bit for bit.  Returns the window's launches."""
    import numpy as np
    import torch
    from repro_torch.serve import (ServingLoop, load_tenants,
                                   make_workload, run_open_loop, summarize)

    names = ("two-step-f32", "ivf-f32")
    tenants = load_tenants([f"{n}={paths[n]}" for n in names],
                           overrides=NO_RETRIES)
    for n, t in tenants.items():
        ENGINES.append((f"loop-{n}", t.engine.stats))
    rng = np.random.default_rng(LOOP["seed"])
    pools = {n: rng.standard_normal((LOOP["pool"], t.d)).astype(np.float32)
             for n, t in sorted(tenants.items())}
    work = make_workload(pools, LOOP["rate_hz"], LOOP["duration_s"],
                         rng=rng, rows_choices=LOOP["rows"])
    with ServingLoop(tenants) as loop:
        for n in tenants:
            loop.warm(n)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        records = run_open_loop(loop, work)
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        stats = dict(loop.stats)
    tiles = {t.engine.query_tile for t in tenants.values()}
    check(tiles == {32}, f"serving loop: engine tiles {tiles}")
    check(launches["crude_topk"] == launches["refine_topk"] > 0
          and launches["ivf_crude_topk"] == launches["ivf_refine_topk"] > 0
          and launches["crude_topk"] + launches["ivf_crude_topk"]
          == stats["batches"],
          f"serving loop: launches {launches} for {stats['batches']} "
          f"flushes")
    mismatched = 0
    for spec, rec in zip(work, records):
        direct = tenants[spec.tenant].engine.search(spec.queries)
        mismatched += not (
            np.array_equal(rec["ids"], direct.indices.cpu().numpy())
            and np.array_equal(rec["dists"], direct.distances.cpu().numpy()))
    check(len(records) == len(work) and mismatched == 0,
          f"serving loop: {mismatched} of {len(records)} responses differ "
          f"from the direct engine call")
    rows = sum(spec.queries.shape[0] for spec in work)
    log(f"serving loop: {len(work)} requests ({rows} rows) at "
        f"{LOOP['rate_hz']:.0f}/s for {LOOP['duration_s']} s "
        f"(seed {LOOP['seed']}), wall {wall_s:.4f} s; {stats['batches']} "
        f"flushes (full {stats['flush_full']}, window "
        f"{stats['flush_window']}, drain {stats['flush_drain']}); "
        f"launches {launches}; every response equal to the direct engine "
        f"call bit for bit: {mismatched == 0}; {card}")
    for n in names:
        s = summarize([r for r in records if r["tenant"] == n],
                      wall_s=wall_s)
        log(f"serving loop tenant {n}: {s['requests']} requests, "
            f"{s['rows']} rows, p50 {s['p50_ms']:.4f} ms, p99 "
            f"{s['p99_ms']:.4f} ms (host clock, submit to result), "
            f"{s['qps']:.2f} requests/s, mean fill "
            f"{s['mean_batch_fill']:.4f}, mean queue "
            f"{s['mean_queue_ms']:.4f} ms, degraded rate "
            f"{s['degraded_rate']:.4f}; {card}")
    # a finding, not a gate: the same direct calls with the engines'
    # tiling off, each request at its own row count
    differ = {"ids": 0, "dists": 0, "either": 0}
    for t in tenants.values():
        t.engine.query_tile = None
    for spec, rec in zip(work, records):
        direct = tenants[spec.tenant].engine.search(spec.queries)
        ids = not np.array_equal(rec["ids"], direct.indices.cpu().numpy())
        dists = not np.array_equal(rec["dists"],
                                   direct.distances.cpu().numpy())
        differ["ids"] += ids
        differ["dists"] += dists
        differ["either"] += ids or dists
    log(f"serving loop with query_tile=None (each direct call at the "
        f"request's own row count): {len(records) - differ['either']} of "
        f"{len(records)} responses equal bit for bit; ids differ in "
        f"{differ['ids']}, distances in {differ['dists']}")
    return launches


def ground_truth_cell(paths, *, seed, card):
    """Phase 10, the eval core: ``ground_truth`` of 64 queries over the
    1M decoded points of the two-step-f32 cell on the card (ms, host
    clock, second call), its ids equal to the CPU ``exact_search``
    wherever the k-th and (k+1)-th distances are more than 1e-5 relative
    apart, and the served cell's recall@100 against it."""
    import numpy as np
    import torch
    from repro_torch import eval as ev
    from repro_torch.core.codebooks import decode
    from repro_torch.index.base import exact_search

    engine = engine_load("ground-truth", paths["two-step-f32"],
                         query_tile=TILE)
    index = engine.index
    db = decode(index.C, index.codes)
    rng = np.random.default_rng(seed + 29)
    q = rng.standard_normal((GT_QUERIES, db.shape[1])).astype(np.float32)
    ev.ground_truth(db, q, TOPK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dist = ev.ground_truth(db, q, TOPK)
    gt_ms = (time.perf_counter() - t0) * 1e3
    want_i, want_d = exact_search(torch.from_numpy(q), db.cpu(), TOPK + 1,
                                  query_chunk=GT_QUERIES)
    want_i, want_d = want_i.numpy(), want_d.numpy()
    gap = np.abs(np.diff(want_d, axis=1)) > 1e-5 * np.abs(want_d[:, 1:])
    clear = gap[:, :TOPK].copy()
    clear[:, 1:] &= gap[:, :TOPK - 1]
    same = np.array_equal(ids[clear], want_i[:, :TOPK][clear])
    dist_ok = np.allclose(dist, want_d[:, :TOPK], rtol=1e-5,
                          atol=1e-5 * float(np.abs(want_d).max()))
    check(same and dist_ok and clear.mean() > 0.5,
          f"ground truth: ids equal where apart {same}, distances "
          f"{dist_ok}, {clear.mean():.4f} of the slots apart")
    served = engine.search(torch.from_numpy(q).cuda())
    recall = ev.recall_at_k(served.indices.cpu().numpy(), ids, TOPK)
    log(f"ground truth: {GT_QUERIES} queries over {db.shape[0]} points, "
        f"d={db.shape[1]}, k={TOPK}: {gt_ms:.4f} ms on the card (host "
        f"clock, second call, to numpy); ids equal to the CPU exact_search "
        f"on the {clear.mean():.4f} of slots whose rank is apart by > 1e-5: "
        f"{same}; distances to rtol 1e-5: {dist_ok}; the two-step-f32 "
        f"cell's recall@{TOPK} against it {recall:.4f} (random "
        f"codebooks: the LUT sum leaves out the cross-codebook terms of "
        f"the decoded point's norm); {card}")


def request_path(paths, *, seed, batches, card, profile_dir=None):
    """Phase 10: the pipelined cells, the serving loop and the ground
    truth.  Returns the launches of the pipelined and loop windows."""
    total = {k: 0 for k in read_launches()}
    for launches in (
            pipelined_cell("two-step-f32", paths["two-step-f32"], seed=seed,
                           batches=batches, card=card,
                           profile_dir=profile_dir),
            pipelined_cell("ivf-f32", paths["ivf-f32"], seed=seed,
                           batches=batches, card=card,
                           profile_dir=profile_dir),
            serving_loop_cell(paths, card=card)):
        for k in total:
            total[k] += launches[k]
    ground_truth_cell(paths, seed=seed, card=card)
    return total


# --------------------------------------- phase 11: training on the card ----

# the paper's Figure 1 full protocol (benchmarks/fig1_synthetic_pq.py,
# full=True) for its K = 8 cell: Table 1's dataset1, d = 16, K = 8,
# m = 256, 2 fast codebooks, the linear embedder, 10 epochs of batch 256
# at lr 1e-3, served two-step at topk 50 (benchmarks/common.py evaluate)
FIG1 = dict(dataset="dataset1", d=16, K=8, m=256, num_fast=2, epochs=10,
            batch=256, lr=1e-3, topk=50, sample=4096)
# the JAX package's run of the same protocol on the CPU (key PRNGKey(8);
# scripts/fig1_reference_cpu.py): a yardstick printed beside the port's,
# not a target
FIG1_REFERENCE_CPU = dict(map50=0.8518922328948975,
                          avg_ops=6.889345169067383,
                          pass_rate=0.8148908615112305)
# epochs of the card-against-CPU gate
GATE_EPOCHS = 2
# the gate's least atol on params and optimizer / variance state, a
# fraction of each leaf's largest magnitude, and how many times the CPU's
# own rounding spread it allows where that is larger: the card's step
# lands up to 5.8e-6 from the CPU's (the first moment of W, at entries
# under 1% of the leaf's magnitude, where the batch sum x^T dL/demb
# cancels), the CPU's own step on the batch's rows reversed 5.9e-6
STATE_ATOL, SPREAD_FACTOR = 1e-5, 4


def tree_apply(fn, tree):
    """``fn`` over the tensor leaves of nested dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_apply(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_apply(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def atol_needed(got, want) -> list:
    """For each leaf of two param/state trees (got on the card, want on
    the CPU): the smallest atol, as a fraction of the leaf's largest
    magnitude, that with rtol 1e-4 holds every entry of got to want."""
    import torch
    need = []
    for g, w in zip(leaves(got), leaves(want)):
        g, w = g.detach().cpu().double(), w.detach().double()
        scale = float(w.abs().max()) if w.numel() else 0.0
        over = torch.clamp_min((g - w).abs() - 1e-4 * w.abs(), 0.0)
        need.append(float(over.max()) / scale if scale else 0.0)
    return need


def batch_codes(params, x, embed_apply):
    """The hard codes the step's L^C takes for batch x: (codes (n, K),
    embeddings)."""
    import torch
    from repro_torch.core.encode import soft_assign
    from repro_torch.index.base import full_f32_matmul
    with full_f32_matmul(), torch.no_grad():
        emb = embed_apply(params["embed"], x)
        return soft_assign(emb, params["C"])[1], emb


def near_ties(codes_a, codes_b, emb, C):
    """Codes that differ between the devices: True when each such code's
    two scores ``||c||^2 - 2 x.c`` (float64, from the CPU's embedding)
    lie within 1e-5 of the terms' size, the kmeans_assign criterion."""
    import torch
    codes_a = codes_a.cpu()
    diff = (codes_a != codes_b).nonzero()
    x, Cd = emb.double(), C.double()
    for i, k in diff.tolist():
        s = (Cd[k] ** 2).sum(1) - 2.0 * Cd[k] @ x[i]
        size = float((x[i] ** 2).sum() + (Cd[k] ** 2).sum(1).max())
        if abs(float(s[codes_a[i, k]] - s[codes_b[i, k]])) > 1e-5 * size:
            return False, len(diff)
    return True, len(diff)


def profile_train_steps(step, state, batches, out_dir):
    """With ``--profile``: ``torch.profiler`` over the joint steps of
    ``batches`` ((x, y) pairs on the card) from ``state``: step time
    (host clock, profiler on), device busy time per step, the device's
    idle share, kernel launches per step, the ops by device and host
    time, and a Chrome trace ``<out_dir>/profile_train_step.json``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p, o, v = state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            p, o, v, _ = step(p, o, v, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / len(batches)
    launches = sum(e.count for e in kernels) / len(batches)
    log(f"profile train step: {wall_ms:.4f} ms a step (host clock, "
        f"profiler on), device busy {busy_ms:.4f} ms a step, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {launches:.1f} kernel launches a "
        f"step")
    log("--- train step: ops by device time ---\n"
        + _op_table(prof, "self_device_time_total", 20))
    log("--- train step: ops by host time ---\n"
        + _op_table(prof, "self_cpu_time_total", 20))
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          "profile_train_step.json"))


def train_gate(cfg, xs, ys, *, seed, profile_dir=None):
    """Phase 11's gate: init on the card, then GATE_EPOCHS epochs of
    ``run_epoch`` on the card, each step's inputs kept; every step is
    run again on the CPU from the card's inputs (copied) and must give
    the card's loss terms (rtol 1e-4), psi_size and updated params,
    optimizer and variance state (rtol 1e-4 and an atol of each leaf's
    magnitude times the larger of ``STATE_ATOL`` and ``SPREAD_FACTOR``
    x the CPU's own spread), unless the batch's hard codes differ
    between the devices at a near tie (then that step is counted, not
    compared).  The CPU's own spread: it also runs each step on the
    batch's rows reversed (the same loss in exact arithmetic, other
    summation orders in the batch reductions); the largest difference
    of that run from its own, relative to a leaf's magnitude, over all
    steps and leaves.  The same
    trained state is finalized on both devices: xi and fast_mask equal,
    sigma to rtol 1e-5, codes equal on >= 99.9% of the rows.  The CPU
    also trains on its own from the init (free-running): its drift from
    the card is printed, not gated (training is chaotic: a near-tie code
    flip moves the codebooks by ~1e-3, scripts/train_divergence.py).
    Returns the init's state, the timings and the launches of init and
    finalize."""
    import numpy as np
    import torch
    from repro_torch.kernels import kmeans as km
    from repro_torch.trainer import (epoch_batches, finalize,
                                     init_train_state, make_train_step,
                                     run_epoch)

    def cpu(tree):
        return tree_apply(lambda a: a.detach().cpu(), tree)

    n = xs.shape[0]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = init_train_state(seed, cfg, d_raw=xs.shape[1], mode="icq",
                          lr=FIG1["lr"], sample_batch=(
                              xs[:FIG1["sample"]], ys[:FIG1["sample"]]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = read_launches()
    want = cfg.num_codebooks * (25 + 1)      # init_residual: 25 iterations
    check(init_launches["kmeans_assign"] == want
          and init_launches["icm_encode"] == 0,
          f"init launched {init_launches}, expected {want} kmeans_assign")
    # kmeans_assign at the init's shape: the sample's embeddings against
    # the first codebook (not counted: a comparison launch)
    with torch.no_grad():
        emb0 = st["embed_apply"](st["params"]["embed"],
                                 xs[:FIG1["sample"]])
    cent = st["params"]["C"][0].contiguous()
    ok, err, same, clear = compare_assign(km.kmeans_assign_cuda(emb0, cent),
                                          km.kmeans_assign_torch(emb0, cent),
                                          emb0, cent)
    log(f"train kmeans_assign n={emb0.shape[0]} L={cent.shape[0]} "
        f"d={cent.shape[1]}: ids equal on {same:.6f} ({clear} clear), "
        f"max_abs_err {err}")
    check(ok, "kmeans_assign at the init's shape disagrees with its plain "
              "version")
    init_cpu = cpu((st["params"], st["opt_state"]))
    gen = torch.Generator().manual_seed(seed + 1)
    stacks = [epoch_batches(gen, xs.cpu(), ys.cpu(), FIG1["batch"])
              for _ in range(GATE_EPOCHS)]
    step = make_train_step(cfg, st["embed_apply"], st["opt"], "icq")
    kept, times = [], []

    def kept_step(params, opt_state, var_state, batch):
        inputs = tree_apply(torch.clone, (params, opt_state, var_state))
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = step(params, opt_state, var_state, batch)
        e.record()
        times.append((s, e))
        kept.append((inputs, batch, out))
        return out

    params, opt_state = st["params"], st["opt_state"]
    epoch_s = []
    for xb, yb in stacks:
        xb, yb = xb.cuda(), yb.cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, var_state, _ = run_epoch(kept_step, params,
                                                    opt_state, xb, yb)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    step_ms = [s.elapsed_time(e) for s, e in times]
    if profile_dir:
        xb, yb = stacks[0]
        profile_train_steps(step, (params, opt_state, var_state),
                            [(xb[i].cuda(), yb[i].cuda()) for i in range(10)],
                            profile_dir)

    # every step again on the CPU from the card's inputs, and on the
    # batch's rows reversed for the CPU's own rounding spread
    terms = ("l_e", "l_c", "l_cq", "l_p", "l_icq", "total")
    needs, flips, spread = {}, [], 0.0
    for i, (inputs, (x, y), out) in enumerate(kept):
        p, o, v = cpu(inputs)
        xc, yc = x.cpu(), y.cpu()
        got = cpu(out)
        want = step(p, o, v, (xc, yc))
        rev = step(p, o, v, (xc.flip(0), yc.flip(0)))
        codes_card, _ = batch_codes(inputs[0], x, st["embed_apply"])
        codes_cpu, emb = batch_codes(p, xc, st["embed_apply"])
        if not torch.equal(codes_card.cpu(), codes_cpu):
            tie, count = near_ties(codes_card, codes_cpu, emb, p["C"])
            check(tie, f"train step {i}: hard codes differ between the "
                       f"card and the CPU beyond a near tie")
            flips.append((i, count))
            continue
        check(all(np.isclose(float(got[3][k]), float(want[3][k]),
                             rtol=1e-4, atol=0.0) for k in terms)
              and int(got[3]["psi_size"]) == int(want[3]["psi_size"]),
              f"train step {i}: the card's loss terms != the CPU's from "
              f"the same inputs: {got[3]} against {want[3]}")
        needs[i] = atol_needed(got[:3], want[:3])
        spread = max(spread, max(atol_needed(rev[:3], want[:3])))
    atol = max(STATE_ATOL, SPREAD_FACTOR * spread)
    worst = max(max(n) for n in needs.values())
    off = [(i, j, n) for i, ns in needs.items() for j, n in enumerate(ns)
           if n > atol]
    log(f"train gate: {len(kept)} steps ({GATE_EPOCHS} epochs of "
        f"{len(kept) // GATE_EPOCHS}); {len(needs)} compared with the CPU's "
        f"step from the same inputs: loss terms to rtol 1e-4 and psi_size "
        f"equal in each; params, opt_state and var_state need an atol of "
        f"{worst:.3e} of a leaf's magnitude beside rtol 1e-4 (allowed "
        f"{atol:.3e}: {STATE_ATOL} or {SPREAD_FACTOR}x the CPU's own "
        f"spread on reversed rows, {spread:.3e}); steps with a near-tie "
        f"code flip between the devices (step, codes): {flips}")
    check(not off, f"train gate: (step, leaf, atol needed) beyond {atol}: "
                   f"{off}")
    check(len(needs) >= len(kept) * 9 // 10,
          f"train gate: only {len(needs)} of {len(kept)} steps compared")

    # finalize the card's trained state on both devices
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = finalize(params, st["embed_apply"], var_state, cfg, xs)
    torch.cuda.synchronize()
    fin_s = time.perf_counter() - t0
    fin_launches = read_launches()
    p, v = cpu((params, var_state))
    ref = finalize(p, st["embed_apply"], v, cfg, xs.cpu())
    rows = float((model.codes.cpu() == ref.codes).all(1).float().mean())
    xi_ok = torch.equal(model.structure.xi.cpu(), ref.structure.xi)
    fm_ok = torch.equal(model.structure.fast_mask.cpu(),
                        ref.structure.fast_mask)
    sig = (float(model.structure.sigma), float(ref.structure.sigma))
    log(f"train finalize: {n} rows, card against CPU from the same state: "
        f"xi {xi_ok}, fast_mask {fm_ok}, sigma {sig[0]} / {sig[1]}, codes "
        f"equal on {rows:.6f} of rows; launches {fin_launches}")
    chunks = -(-n // 8192)
    check(xi_ok and fm_ok and np.isclose(sig[0], sig[1], rtol=1e-5)
          and rows >= 0.999
          and fin_launches["kmeans_assign"] == chunks * cfg.num_codebooks
          and fin_launches["icm_encode"] == chunks,
          "train finalize: the card's export != the CPU's")

    # the CPU training on its own from the same init (not gated)
    p, o = init_cpu
    cstep = make_train_step(cfg, st["embed_apply"], st["opt"], "icq")
    free = []

    def free_step(*a):
        out = cstep(*a)
        free.append(out[3])
        return out
    for xb, yb in stacks:
        p, o, v, _ = run_epoch(free_step, p, o, xb, yb)
    drift = max(abs(float(a[3]["total"]) - float(b["total"]))
                / abs(float(b["total"])) for (_, _, a), b in zip(kept, free))
    need = atol_needed((params, opt_state, var_state), (p, o, v))
    log(f"train free-running: the CPU trained from the same init drifts "
        f"from the card by up to {drift:.3e} in the total loss; after "
        f"{GATE_EPOCHS} epochs the state needs an atol of {max(need):.3e} "
        f"of a leaf's magnitude, {sum(n > atol for n in need)} of "
        f"{len(need)} leaves beyond the gate's {atol:.3e} (not gated)")
    return (dict(init_s=init_s, step_ms=float(np.median(step_ms)),
                 epoch_s=epoch_s, finalize_s=fin_s),
            init_launches, fin_launches)


def train_cell(seed: int, card: str, profile_dir=None):
    """Phase 11: train at the Figure 1 full protocol on the card through
    ``fit`` (launch counts reset before, read after; peak MB), its loss
    terms per epoch, then serve the model with ``TwoStep`` at topk 50
    over the 1000 test queries (launches counted; equal to the plain
    composition) and score MAP@50, Average Ops and pass_rate beside the
    JAX package's CPU run.  ``train_gate`` first holds the card's steps
    and export to the CPU's (and, with ``profile_dir``, profiles 10
    steps).  Returns the launches of the fit and the
    served window, and the fitted model."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import ICQConfig
    from repro_torch.data import make_table1_dataset
    from repro_torch.index import make_index
    from repro_torch.index.base import mean_average_precision
    from repro_torch.trainer import fit

    f = FIG1
    xtr, ytr, xte, yte = make_table1_dataset(f["dataset"])
    cfg = ICQConfig(d=f["d"], num_codebooks=f["K"], codebook_size=f["m"],
                    num_fast=f["num_fast"])
    xs, ys = torch.from_numpy(xtr).cuda(), torch.from_numpy(ytr).cuda()
    timing, init_launches, fin_launches = train_gate(
        cfg, xs, ys, seed=seed, profile_dir=profile_dir)

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model = fit(seed, xtr, ytr, cfg, mode="icq", epochs=f["epochs"],
                    batch_size=f["batch"], lr=f["lr"], verbose=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = read_launches()
    want = {k: init_launches[k] + fin_launches[k]
            for k in ("kmeans_assign", "icm_encode")}
    check(all(launches[k] == want[k] for k in want)
          and sum(launches.values()) == sum(want.values()),
          f"fit launched {launches}, expected {want}")
    epochs = [dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
              for line in out.getvalue().splitlines()]
    for ep, mets in enumerate(epochs):
        log(f"train epoch {ep}: " + " ".join(f"{k}={v}"
                                              for k, v in mets.items()))
    totals = [float(m["total"]) for m in epochs]
    check(len(totals) == f["epochs"] and totals[-1] < totals[0],
          f"train: the total loss did not fall ({totals})")

    index = make_index("two-step", model.codes, model.C, model.structure,
                       topk=f["topk"])
    q = model.embed(torch.from_numpy(xte).cuda())
    reset_launches()
    res = index.search(q)
    torch.cuda.synchronize()
    served = read_launches()
    check(served == expected_launches(index, 1),
          f"train serve: launches {served}")
    ids, dist = plain_composition(index, q)
    same = torch.equal(ids, res.indices) and torch.equal(dist, res.distances)
    mapv = float(mean_average_precision(res.indices, ys,
                                        torch.from_numpy(yte).cuda()))
    check(same and tuple(res.indices.shape) == (len(xte), f["topk"])
          and bool(torch.isfinite(res.distances[:, 0]).all()) and mapv > 0.1,
          f"train serve: MAP@{f['topk']} {mapv}, served == plain "
          f"composition {same}")
    ref = FIG1_REFERENCE_CPU
    log(f"train fig1 {f['dataset']} K={f['K']} m={f['m']} d={f['d']} "
        f"num_fast={f['num_fast']} n={len(xtr)} epochs={f['epochs']} "
        f"batch={f['batch']}: init {timing['init_s']:.4f} s, "
        f"{timing['step_ms']:.4f} ms a step (CUDA events, median of "
        f"{GATE_EPOCHS} epochs), epochs {timing['epoch_s']} s, finalize "
        f"{timing['finalize_s']:.4f} s (host clock, synchronized); fit "
        f"{fit_s:.4f} s; peak {peak_mb:.1f} MB; launches {launches}; "
        f"{card}")
    log(f"train fig1 served two-step topk={f['topk']} over {len(xte)} test "
        f"queries: MAP@{f['topk']} {mapv:.6f}, avg_ops "
        f"{float(res.avg_ops):.6f}, pass_rate {float(res.pass_rate):.6f} "
        f"(the JAX package on the CPU, scripts/fig1_reference_cpu.py: "
        f"{ref['map50']:.6f}, {ref['avg_ops']:.6f}, {ref['pass_rate']:.6f}"
        f"); served == plain composition: {same}; launches {served}")
    return {k: launches[k] + served[k] for k in launches}, model


# ------------------------------------------ phase 12: the front door ----

# (a) the unsupervised baselines at SIFT1M's geometry: PQ and OPQ are
# trained on SIFT1M's 100,000-point learn set and index its 1M-point
# base (Jegou et al., TPAMI 2011); 1000 of its queries, recall@100
# against the exact neighbours in the raw space (OPQ's R is orthogonal)
FRONT = dict(d=128, K=8, m=256, num_fast=2, n_train=100_000, nq=1000,
             topk=100)
# each kind with its rounds (train.epochs): PQ is closed-form (its one
# step is the identity), OPQ alternates 8 rounds of 10 k-means
# iterations, CQ runs 10 rounds of 50 AdamW steps on C
FRONT_KINDS = (("pq", 1), ("opq", 8), ("cq", 10))
# the quantizers' own constants (trainer/quantizers.py defaults): PQ's
# k-means iterations, OPQ's per round, CQ's residual init
PQ_ITERS, OPQ_ITERS, CQ_INIT_ITERS = 25, 10, 10
# (b) the supervised pipelines through the session: Figure 2's full
# protocol (benchmarks/fig2_synthetic_cq.py, full=True) for its K = 8
# cell (sq: Table 1's dataset1, the linear embedder, served two-step at
# topk 50) and Figure 5's (benchmarks/fig5_pqn.py, full=True, K = 8;
# pqn: pseudo_mnist, 8000 train / 800 test, the cnn embedder, served
# one-step as that benchmark's evaluate does)
FIG2 = dict(dataset="dataset1", d=16, K=8, m=256, num_fast=2, epochs=10,
            batch=256, lr=1e-3, topk=50, kind="two-step")
FIG5 = dict(n_train=8000, n_test=800, hw=28, channels=1, d=16, K=8, m=256,
            num_fast=2, epochs=6, batch=256, lr=1e-3, topk=50, kind="flat")
# (c) the checkpointed fit of phase 11's cell: one fault before this
# epoch, a checkpoint every epoch
RESUME_FAULT_EPOCH = 4
ENCODE_CHUNK = 8192          # the config's encode.chunk
# CQ's AdamW updates held one by one against the CPU's (of the round's 50)
CQ_HELD = 10


def chunks(n: int) -> int:
    return -(-n // ENCODE_CHUNK)


def front_config(overrides):
    """An api config with no engine retries (the script's rule)."""
    from repro_torch.api import ICQConfig
    return ICQConfig().with_overrides({**NO_RETRIES, **overrides})


def register(name, searcher):
    """A session's engine with no retries, registered in ``ENGINES``."""
    from repro_torch.api import ResilienceConfig
    searcher.engine.resilience = ResilienceConfig(max_retries=0)
    ENGINES.append((name, searcher.engine.stats))
    return searcher


def serve_tiles(call, q):
    """``call`` over q in 64-query tiles: (ids, distances) of all rows
    and the median device ms of a full tile (CUDA events)."""
    import numpy as np
    import torch
    ids, dist, times = [], [], []
    for s in range(0, q.shape[0], TILE):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        r = call(q[s:s + TILE])
        e1.record()
        ids.append(r.indices)
        dist.append(r.distances)
        times.append((e0, e1, r.indices.shape[0]))
    torch.cuda.synchronize()
    full = [a.elapsed_time(b) for a, b, rows in times if rows == TILE]
    return (torch.cat(ids), torch.cat(dist),
            float(np.median(full)) if full else float("nan"))


def reload_gate(name, searcher, q, want, workdir, *, tiled=True):
    """``Searcher.save`` -> ``load_ann_engine`` fed the embeddings of
    ``ICQSession.from_artifacts(...).model`` serves ``want`` (the
    in-process (ids, distances) over q) bit for bit, tile by tile as it
    was served.  An OPQ model's reload raises ``ArtifactError``; its
    index, fed the searcher's own embeddings, must still serve ``want``.
    Returns the path."""
    import torch
    from repro_torch.api import ArtifactError, ICQSession
    path = searcher.save(os.path.join(workdir, f"front-{name}"))
    engine = engine_load(f"front-{name}-reload", path)
    try:
        embed = ICQSession.from_artifacts(path).model.embed
        raised = None
    except ArtifactError as e:
        embed, raised = searcher.embed, str(e)
    if name == "opq":
        check(raised is not None and "OPQ rotation" in raised,
              f"front opq: the reload did not raise ArtifactError "
              f"({raised})")
    else:
        check(raised is None, f"front {name}: reload raised {raised}")

    def call(t):
        with torch.no_grad():
            return engine.search(embed(t))
    if tiled:
        ids, dist, _ = serve_tiles(call, q)
    else:
        r = call(q)
        ids, dist = r.indices, r.distances
    same = torch.equal(ids, want[0]) and torch.equal(dist, want[1])
    log(f"front {name} reload: load_ann_engine + "
        + ("the searcher's embed (from_artifacts raised ArtifactError: "
           f"{raised[:60]}...)" if raised else
           "ICQSession.from_artifacts(...).model.embed")
        + f": ids and distances equal to the in-process Searcher: {same}")
    check(same, f"front {name}: the reloaded model and index serve other "
                "answers than the in-process Searcher")
    return path


def baseline_launches(kind, rounds, n_train, n_base, K):
    """The kernel launches a fit and an index build of ``kind`` imply:
    (fit, index) dicts of kmeans_assign / icm_encode counts."""
    if kind == "pq":            # k-means per subspace, the PQ export
        fit = dict(kmeans_assign=K * (PQ_ITERS + 1) + chunks(n_train) * K,
                   icm_encode=0)
    elif kind == "opq":         # per round: k-means + encode_pq
        fit = dict(kmeans_assign=rounds * K * (OPQ_ITERS + 2)
                   + chunks(n_train) * K, icm_encode=0)
    else:                       # residual init, ICM init + one a round
        fit = dict(kmeans_assign=K * (CQ_INIT_ITERS + 1) + K,
                   icm_encode=1 + rounds)
    index = dict(kmeans_assign=chunks(n_base) * K,
                 icm_encode=chunks(n_base) if kind == "cq" else 0)
    return fit, index


def front_baseline(kind, rounds, data, gt_ids, *, seed, card, workdir):
    """Phase 12 (a) for one kind: ``icq_session(cfg).fit`` on the train
    points, ``.index(base)`` (flat), ``Searcher.search`` of the queries
    in 64-query tiles, each with the launch counts reset before and read
    after; recall@100; then the reload gate.  Returns (launches, the
    session, the searcher)."""
    import torch
    from repro_torch import eval as eval_mod
    from repro_torch.api import icq_session
    xtr, xdb, q = data
    f = FRONT
    cfg = front_config({
        "train.quantizer": kind, "train.d": f["d"],
        "train.num_codebooks": f["K"], "train.codebook_size": f["m"],
        "train.num_fast": f["num_fast"], "train.epochs": rounds,
        "index.kind": "flat", "serve.topk": f["topk"]})
    session = icq_session(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    session.fit(xtr, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_l = read_launches()
    reset_launches()
    t0 = time.perf_counter()
    searcher = register(f"front-{kind}", session.index(xdb))
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    idx_l = read_launches()
    want_fit, want_idx = baseline_launches(kind, rounds, xtr.shape[0],
                                           xdb.shape[0], f["K"])
    for got, want, what in ((fit_l, want_fit, "fit"),
                            (idx_l, want_idx, "index")):
        check(all(got[k] == want[k] for k in want)
              and sum(got.values()) == sum(want.values()),
              f"front {kind} {what} launched {got}, expected {want}")
    reset_launches()
    ids, dist, tile_ms = serve_tiles(searcher.search, q)
    srv_l = read_launches()
    tiles = -(-q.shape[0] // TILE)
    check(srv_l == expected_launches(searcher.index, tiles),
          f"front {kind} serve launched {srv_l}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    recall = eval_mod.recall_at_k(ids.cpu().numpy(), gt_ids, f["topk"])
    chance = f["topk"] / xdb.shape[0]
    last = (q.shape[0] - 1) // TILE * TILE
    with torch.no_grad():
        plain = plain_composition(searcher.index,
                                  searcher.embed(q[last:]))
    same = (torch.equal(plain[0], ids[last:])
            and torch.equal(plain[1], dist[last:]))
    check(tuple(ids.shape) == (q.shape[0], f["topk"])
          and bool(torch.isfinite(dist).all())
          and bool((dist[:, 1:] >= dist[:, :-1]).all())
          and recall > 10 * chance and same,
          f"front {kind}: recall@{f['topk']} {recall} (chance {chance}), "
          f"served == plain composition {same}, or bad results")
    log(f"front {kind} (SIFT1M geometry: d={f['d']} K={f['K']} "
        f"m={f['m']}, {rounds} round(s), flat): fit {fit_s:.4f} s on "
        f"{xtr.shape[0]} points, encode {enc_s:.4f} s (index of "
        f"{xdb.shape[0]} points), {tile_ms:.4f} ms per 64-query tile "
        f"(median, events), recall@{f['topk']} {recall:.6f} over "
        f"{q.shape[0]} queries (served == plain composition: {same}), "
        f"peak {peak:.1f} MiB; launches: fit "
        f"{fit_l['kmeans_assign']} kmeans_assign, {fit_l['icm_encode']} "
        f"icm_encode; index {idx_l['kmeans_assign']} kmeans_assign, "
        f"{idx_l['icm_encode']} icm_encode; serve {srv_l['crude_topk']} "
        f"crude_topk; {card}")
    reload_gate(kind, searcher, q, (ids, dist), workdir)
    total = {k: fit_l[k] + idx_l[k] + srv_l[k] for k in fit_l}
    return total, session, searcher


def cpu_tree(tree):
    return tree_apply(lambda a: a.detach().cpu()
                      if hasattr(a, "detach") else a, tree)


def rows_equal(a, b) -> float:
    return float((a.cpu() == b.cpu()).all(1).float().mean())


def finalize_gate(kind, card_model, cpu_model):
    """``finalize`` on the card and on the CPU from the same state:
    codes equal on >= 99.9% of rows (the rest near ties, counted), lam
    to rtol 1e-4 (atol 1e-5 of its magnitude), C equal."""
    import torch
    same = rows_equal(card_model.codes, cpu_model.codes)
    lam_need = max(atol_needed(card_model.lam, cpu_model.lam))
    c_same = torch.equal(card_model.C.cpu(), cpu_model.C)
    n = card_model.codes.shape[0]
    log(f"front {kind} finalize, card against CPU from the same state: "
        f"codes equal on {same:.6f} of {n} rows "
        f"({round((1 - same) * n)} differ), lam needs atol "
        f"{lam_need:.3e} of its magnitude beside rtol 1e-4, C equal "
        f"{c_same}")
    check(same >= 0.999 and lam_need <= STATE_ATOL and c_same,
          f"front {kind}: the card's finalize != the CPU's")


def step_atol(got, want, rev):
    """Phase 11's step gate for one card step ``got`` against the CPU's
    ``want`` from the same inputs (lists of tensors): (atol needed,
    atol allowed).  Each leaf is held to rtol 1e-4 and an atol of its
    magnitude times the larger of ``STATE_ATOL`` and ``SPREAD_FACTOR``
    x the CPU's own spread: ``rev``, the CPU's step on the batch's rows
    reversed (the same function in exact arithmetic, other summation
    orders)."""
    spread = max(atol_needed(rev, want))
    return (max(atol_needed(got, want)),
            max(STATE_ATOL, SPREAD_FACTOR * spread))


def quantizer_gates(seed, xtr, hyper):
    """PQ's, OPQ's and CQ's ``step`` and ``finalize`` on the card, each
    run again on the CPU from the card's state (copied), held to phase
    11's step gate (``step_atol``).  OPQ's round k-means draws the same
    rows on both devices, but Lloyd's iterations then round apart, so
    the CPU's round is fed the card's round init (``init_pq`` recorded
    and replayed); R = U V^T of an f32 X^T Xbar whose singular values
    span orders of magnitude moves by ~1e-5-1e-4 under any reordering
    of the sums, which the CPU's reversed-rows spread measures.  CQ's
    step is 50 AdamW updates
    of C: AdamW divides a gradient near zero by itself, so two devices'
    rounding compounds over a free-running round (one entry of 8192
    0.00045 apart after 50 updates, a card test), and even one update
    from shared inputs moves an entry whose gradient cancels to ~eps by
    AdamW's normalization of that gradient's rounding.  So the gate
    holds each update from the card's inputs in its two parts, the
    gradient (phase 11's step gate) and the AdamW update from the
    card's gradient (rtol 1e-4, atol 1e-5), and prints the state against
    the CPU's own step: the first ``CQ_HELD`` updates of the round (a
    CPU update of 100,000 points takes seconds), the whole round run
    twice on the card bit for bit, and its warm ICM re-encode against
    the CPU's from the card's C on >= 99.9% of rows."""
    import torch
    from repro_torch.core import codebooks as cbm
    from repro_torch.core import encode as enc
    from repro_torch.trainer import make_quantizer
    xc = xtr.cpu()

    def pair(kind):
        return (make_quantizer(kind, hyper),
                make_quantizer(kind, hyper, device="cpu"))

    q, qc = pair("pq")
    s = q.init(seed, xtr)
    s1, s1c = q.step(s, xtr), qc.step(cpu_tree(s), xc)
    check(torch.equal(s1["C"].cpu(), s1c["C"]), "front pq: step")
    log("front pq step: the identity on both devices (C equal)")
    finalize_gate("pq", q.finalize(s1, xtr), qc.finalize(cpu_tree(s1), xc))

    q, qc = pair("opq")
    s1 = q.step(q.init(seed, xtr), xtr)
    orig, seen = cbm.init_pq, []

    def record(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]
    try:
        cbm.init_pq = record
        s2 = q.step(s1, xtr)
        cbm.init_pq = lambda *a, **kw: seen[-1].cpu()
        s2c = qc.step(cpu_tree(s1), xc)
        s2r = qc.step(cpu_tree(s1), xc.flip(0))
    finally:
        cbm.init_pq = orig
    need, allowed = step_atol([s2["R"]], [s2c["R"]], [s2r["R"]])
    log(f"front opq step (round 2, its k-means init the card's on both "
        f"devices), card against CPU from the same state: R needs an atol "
        f"of {need:.3e} of its magnitude beside rtol 1e-4 (allowed "
        f"{allowed:.3e}: {STATE_ATOL} or {SPREAD_FACTOR}x the CPU's own "
        f"spread on reversed rows)")
    check(need <= allowed, f"front opq: the card's step != the CPU's "
                           f"({need} > {allowed})")
    finalize_gate("opq", q.finalize(s2, xtr), qc.finalize(cpu_tree(s2), xc))

    q, qc = pair("cq")
    s0 = q.init(seed, xtr)
    C, opt, held, state_need = s0["C"], s0["opt_state"], [], []
    codes_c = s0["codes"].cpu()

    def leaves_of(c, o):
        return [c, o["m"]["C"], o["v"]["C"]]
    for _ in range(CQ_HELD):
        g = q.c_grad(C, s0["codes"], xtr)
        gc = qc.c_grad(C.cpu(), codes_c, xc)
        grev = qc.c_grad(C.cpu(), codes_c.flip(0), xc.flip(0))
        nxt = q.c_update(C, g, opt)
        upd = qc.c_update(C.cpu(), g.cpu(), cpu_tree(opt))
        own = qc.c_update(C.cpu(), gc, cpu_tree(opt))
        held.append(step_atol([g], [gc], [grev])
                    + (max(atol_needed(leaves_of(*nxt), leaves_of(*upd))),))
        state_need.append(max(atol_needed(leaves_of(*nxt),
                                          leaves_of(*own))))
        C, opt = nxt
    off = [(i, h) for i, h in enumerate(held)
           if h[0] > h[1] or h[2] > STATE_ATOL]
    s1 = q.step(s0, xtr)
    again = q.c_steps(s0["C"], s0["codes"], s0["opt_state"], xtr)[0]
    codes = enc.icm_encode(xc, s1["C"].cpu(), q.icq_cfg.icm_iters,
                           init_codes=s0["codes"].cpu())
    same = rows_equal(s1["codes"], codes)
    det = torch.equal(again, s1["C"])
    log(f"front cq step (its {q.grad_steps} AdamW updates of C, then the "
        f"warm ICM re-encode): the first {CQ_HELD} updates from the card's "
        f"inputs: the gradient on the card against the CPU's needs an atol "
        f"of {max(h[0] for h in held):.3e} of its magnitude beside rtol "
        f"1e-4 (allowed per update {[round(h[1], 9) for h in held]}: "
        f"{STATE_ATOL} or {SPREAD_FACTOR}x the CPU's own spread on reversed "
        f"rows); the card's AdamW update against the CPU's from the card's "
        f"gradient needs {max(h[2] for h in held):.3e} (allowed "
        f"{STATE_ATOL}); the state against the CPU's own step (each device "
        f"its own gradient, not gated: AdamW divides a gradient that "
        f"cancels to ~eps by itself) needs {max(state_need):.3e}; the "
        f"round again on the card gives C bit for bit: {det}; the "
        f"re-encode from the card's C equal on the CPU on {same:.6f} of "
        f"{xtr.shape[0]} rows")
    check(not off and det and same >= 0.999,
          f"front cq: the card's step != the CPU's (update, (gradient "
          f"needed, allowed, update needed)): {off}")
    finalize_gate("cq", q.finalize(s1, xtr), qc.finalize(cpu_tree(s1), xc))


def front_kernels(xtr, pq_model, cq_model):
    """``kmeans_assign`` at the PQ subspace shape (the train points'
    first 16 dimensions against PQ's first codebook) and ``icm_encode``
    with CQ's trained codebooks at d = 128, against their plain versions
    on the same card tensors (phases 2 and 6's criteria)."""
    import torch
    from repro_torch.core.encode import encode_pq
    from repro_torch.kernels import icm_encode as icm
    from repro_torch.kernels import kmeans as km
    sub = FRONT["d"] // FRONT["K"]
    x = xtr[:, :sub].contiguous()
    cent = pq_model.C[0][:, :sub].contiguous()
    ok, err, same, clear = compare_assign(km.kmeans_assign_cuda(x, cent),
                                          km.kmeans_assign_torch(x, cent),
                                          x, cent)
    log(f"front kmeans_assign n={x.shape[0]} L={cent.shape[0]} d={sub}: "
        f"ids equal on {same:.6f} ({clear} clear), max_abs_err {err}")
    check(ok, "kmeans_assign at the PQ subspace shape disagrees with its "
              "plain version")
    C = cq_model.C.contiguous()
    init = encode_pq(xtr, C)
    got = icm.icm_encode_cuda(xtr, init, C, iters=ICM_ITERS)
    want = icm.icm_encode_torch(xtr, init, C, iters=ICM_ITERS)
    differ = int((got != want).any(1).sum())
    mse = [float(row_errors(xtr, C, c).double().mean()) for c in (got,
                                                                 want)]
    log(f"front icm_encode n={xtr.shape[0]} K={C.shape[0]} m={C.shape[1]}"
        f" d={C.shape[2]} (CQ's trained codebooks): {differ} rows differ "
        f"from the plain version, MSE {mse[0]!r} vs plain {mse[1]!r}")
    check(differ <= xtr.shape[0] // 1000
          and abs(mse[0] - mse[1]) <= 1e-5 * abs(mse[1]),
          "icm_encode with CQ's codebooks disagrees with its plain version")


def front_supervised(kind, seed, card, workdir):
    """Phase 12 (b): ``sq`` on Figure 2's protocol or ``pqn`` on Figure
    5's through the session: fit, index the train set, serve the test
    queries in one call (launches counted), MAP@50, Average Ops and
    pass_rate; then the reload gate on that call.  Returns the
    launches."""
    import numpy as np
    import torch
    from repro_torch.data import make_table1_dataset, pseudo_mnist
    from repro_torch.index.base import mean_average_precision
    from repro_torch.api import icq_session
    if kind == "sq":
        f = FIG2
        xtr, ytr, xte, yte = make_table1_dataset(f["dataset"])
        extra = {"train.embed": "linear"}
        what = f"Figure 2 {f['dataset']}"
    else:
        f = FIG5
        xtr, ytr, xte, yte = pseudo_mnist(n_train=f["n_train"],
                                          n_test=f["n_test"], seed=seed)
        shape = (-1, f["hw"], f["hw"], f["channels"])
        xtr, xte = xtr.reshape(shape), xte.reshape(shape)
        extra = {"train.embed": "cnn", "train.img_hw": f["hw"],
                 "train.channels": f["channels"]}
        what = "Figure 5 pseudo_mnist"
    cfg = front_config({
        "train.quantizer": kind, "train.d": f["d"],
        "train.num_codebooks": f["K"], "train.codebook_size": f["m"],
        "train.num_fast": f["num_fast"], "train.epochs": f["epochs"],
        "train.batch_size": f["batch"], "train.lr": f["lr"],
        "index.kind": f["kind"], "serve.topk": f["topk"], **extra})
    session = icq_session(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    session.fit(xtr, ytr, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_l = read_launches()
    searcher = register(f"front-{kind}", session.index())
    # contiguous rows, as Searcher.embed makes them (the reload gate
    # embeds them with the reloaded model directly; on the card a
    # product's rounding depends on its operands' strides)
    q = torch.from_numpy(np.ascontiguousarray(xte)).cuda()
    reset_launches()
    res = searcher.search(q)
    torch.cuda.synchronize()
    srv_l = read_launches()
    check(srv_l == expected_launches(searcher.index, 1),
          f"front {kind} serve launched {srv_l}")
    mapv = float(mean_average_precision(res.indices,
                                        torch.from_numpy(ytr).cuda(),
                                        torch.from_numpy(yte).cuda()))
    check(tuple(res.indices.shape) == (len(xte), f["topk"])
          and bool(torch.isfinite(res.distances[:, 0]).all())
          and mapv > 0.1, f"front {kind}: MAP@{f['topk']} {mapv}")
    log(f"front {kind} ({what}, n={len(xtr)}, d={f['d']} K={f['K']} "
        f"m={f['m']}, {f['epochs']} epochs of {f['batch']}, served "
        f"{f['kind']} topk={f['topk']} over {len(xte)} test queries): fit "
        f"{fit_s:.4f} s, MAP@{f['topk']} {mapv:.6f}, avg_ops "
        f"{float(res.avg_ops):.6f}, pass_rate {float(res.pass_rate):.6f},"
        f" peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
        f"launches: fit {fit_l['kmeans_assign']} kmeans_assign, "
        f"{fit_l['icm_encode']} icm_encode; serve {srv_l}; {card}")
    reload_gate(kind, searcher, q, (res.indices, res.distances), workdir,
                tiled=False)
    return {k: fit_l[k] + srv_l[k] for k in fit_l}, searcher


def tenant_gate(searcher):
    """``Tenant.from_searcher`` in a ``ServingLoop``: one request of 16
    raw rows answers what ``searcher.search`` answers on them (the loop
    pins the engine's tile, so both run the same tiles)."""
    import numpy as np
    from repro_torch.serve import ServingLoop, Tenant
    rows = np.random.default_rng(5).standard_normal(
        (16, FRONT["d"])).astype(np.float32)
    with ServingLoop(Tenant.from_searcher("front", searcher)) as loop:
        got = loop.search(rows)
        want = searcher.search(rows)
    same = (np.array_equal(got.indices, want.indices.cpu().numpy())
            and np.array_equal(got.distances, want.distances.cpu().numpy()))
    log(f"front tenant: Tenant.from_searcher in a ServingLoop answers a "
        f"16-row request as Searcher.search does: {same}")
    check(same, "Tenant.from_searcher answers otherwise than the searcher")


def resume_gate(seed, uninterrupted, workdir):
    """Phase 11's Figure 1 cell trained by ``fit(ckpt_dir=)`` with a
    fault raised once before epoch ``RESUME_FAULT_EPOCH``: one restart
    (the hook is called once an attempt: epochs + restarts calls), and
    C, codes and structure equal the uninterrupted fit's bit for bit."""
    import torch
    from repro_torch.configs import ICQConfig
    from repro_torch.data import make_table1_dataset
    from repro_torch.trainer import fit
    f = FIG1
    xtr, ytr, _, _ = make_table1_dataset(f["dataset"])
    cfg = ICQConfig(d=f["d"], num_codebooks=f["K"], codebook_size=f["m"],
                    num_fast=f["num_fast"])
    calls = []

    def fault(epoch):
        calls.append(epoch)
        if epoch == RESUME_FAULT_EPOCH and calls.count(epoch) == 1:
            raise RuntimeError("injected fault")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fit(seed, xtr, ytr, cfg, mode="icq", epochs=f["epochs"],
                batch_size=f["batch"], lr=f["lr"],
                ckpt_dir=os.path.join(workdir, "fig1-ckpt"),
                fault_hook=fault)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    restarts = len(calls) - f["epochs"]
    same = {"C": torch.equal(model.C, uninterrupted.C),
            "codes": torch.equal(model.codes, uninterrupted.codes),
            "structure": all(torch.equal(a, b) for a, b in
                             zip(model.structure, uninterrupted.structure))}
    log(f"front resume: fit(ckpt_dir=) of the Figure 1 cell with a fault "
        f"before epoch {RESUME_FAULT_EPOCH}: {restarts} restart(s), "
        f"{fit_s:.4f} s; equal to the uninterrupted fit bit for bit: "
        f"{same}")
    check(restarts == 1 and all(same.values()),
          f"front resume: {restarts} restarts, equal {same}")


def front_door(seed: int, n_base: int, card: str, fig1_model):
    """Phase 12: the front door (see the module docstring).  Returns
    the main path's launches."""
    import torch
    from repro_torch import eval as eval_mod
    from repro_torch.data import pseudo_sift
    f = FRONT
    n_train = min(f["n_train"], n_base // 10)
    t0 = time.perf_counter()
    x, q, _ = pseudo_sift(n=n_train + n_base, n_queries=f["nq"], d=f["d"],
                          seed=seed)
    xtr = torch.from_numpy(x[:n_train]).cuda()
    xdb = torch.from_numpy(x[n_train:]).cuda()
    q = torch.from_numpy(q).cuda()
    del x
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_ids, _ = eval_mod.ground_truth(xdb, q, f["topk"])
    gt_s = time.perf_counter() - t0
    log(f"front data: pseudo_sift (seed {seed}) {n_train} train + "
        f"{n_base} base points, {f['nq']} queries, d={f['d']}, made in "
        f"{gen_s:.2f} s (host); ground truth top-{f['topk']} in "
        f"{gt_s:.4f} s")
    total = {k: 0 for k in read_launches()}
    models = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as workdir:
        for kind, rounds in FRONT_KINDS:
            launches, session, searcher = front_baseline(
                kind, rounds, (xtr, xdb, q), gt_ids, seed=seed, card=card,
                workdir=workdir)
            for k in total:
                total[k] += launches[k]
            models[kind] = session.model
            if kind == "pq":
                tenant_gate(searcher)
            del session, searcher
        for kind in ("sq", "pqn"):
            launches, _ = front_supervised(kind, seed, card, workdir)
            for k in total:
                total[k] += launches[k]
        hyper = front_config({
            "train.d": f["d"], "train.num_codebooks": f["K"],
            "train.codebook_size": f["m"]}).train.hyperparams(
                icm_iters=ICM_ITERS)
        quantizer_gates(seed, xtr, hyper)
        front_kernels(xtr, models["pq"], models["cq"])
        resume_gate(seed, fig1_model, workdir)
    return total


# ------------------ phase 13: sharded serving and the data-parallel fit ----

# the sharded cells: (artifact of phases 4-5, shards).  D = 4 lays four
# shards of 250,000 rows (IVF: 256 of the 1024 lists) on the first card,
# D = 3 gives a shorter last shard, D = 1 takes make_mesh_auto's device
# list (the visible cards)
SHARDED = tuple((name, D) for D in (4, 1) for name in (
    "two-step-f32", "two-step-int8", "flat-f32", "two-step-int8-4bit",
    "ivf-f32")) + (("two-step-f32", 3),)
DEAD_SHARD = 1          # the shard the dead-shard cells fail over
GROW = 100_000          # points the grow cell adds


def data_mesh(D, devices=None):
    """A D-way ``data`` mesh: over ``devices`` (one card repeated D
    times for ``["cuda"]``), else over the visible cards."""
    from repro_torch.distributed import make_mesh_auto
    return make_mesh_auto((D,), ("data",), devices=devices)


def query_tiles(seed, d, batches):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 13)
    return [torch.from_numpy(rng.standard_normal(
        (TILE, d), dtype=np.float32)).cuda() for _ in range(batches)]


def shard_launches(index, live, batches):
    """A sharded window's launches: every live shard's crude (and
    refine) kernel once a tile."""
    return {k: v * live for k, v in expected_launches(index, batches).items()}


def add_into(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def sharded_cell(name, path, D, *, seed, batches, card):
    """One artifact served unsharded and through ``load_ann_engine(path,
    mesh=)`` over D shards, 64-query tiles, launch counts reset before
    and read after each window: the sharded answers equal the unsharded
    ones in all four fields, bit for bit, tile by tile.  Returns the
    sharded window's launches."""
    from repro_torch.resilience import SearchBudget
    devices = None if D == 1 else ["cuda"]
    plain = engine_load(name, path, query_tile=TILE)
    eng = engine_load(f"{name}-D{D}", path, mesh=data_mesh(D, devices),
                      query_tile=TILE)
    qs = query_tiles(seed, int(plain.index.C.shape[-1]), batches)
    plain.warm(TILE)
    eng.warm(TILE)
    want, p_ms, p_host, _, p_mb = served_window(plain, qs, SearchBudget())
    got, s_ms, s_host, launches, s_mb = served_window(eng, qs,
                                                      SearchBudget())
    expect = shard_launches(plain.index, D, batches)
    check(launches == expect,
          f"sharded {name} D={D}: launches {launches} != {expect}")
    same = all(same_result(g, w) for g, w in zip(got, want))
    check(same, f"sharded {name} D={D}: answers != the unsharded engine's")
    check(all(r.meta.backend == "cuda" and r.meta.level_name == "full"
              and r.meta.coverage == 1.0 and not r.meta.degraded
              for r in got), f"sharded {name} D={D}: meta {got[0].meta}")
    per_tile = {k: v // batches for k, v in launches.items() if v}
    log(f"sharded {name} D={D} on {[str(d) for d in eng._view.devices]}: "
        f"{s_ms:.4f} ms a tile (events), {s_host:.4f} ms (host clock); "
        f"unsharded {p_ms:.4f} / {p_host:.4f} ms; launches a tile "
        f"{per_tile}; peak {s_mb:.1f} MiB (unsharded {p_mb:.1f}); ids, "
        f"distances, pass_rate, avg_ops == unsharded over {batches} tiles: "
        f"{same}; {card}")
    return launches


def dead_shard_cell(name, path, *, seed, batches, card):
    """Shard ``DEAD_SHARD`` of 4 failed over: the sharded engine answers
    as an unsharded engine over the survivors (two-step: the codes
    without the dead rows, ids mapped back; IVF: the dead lists emptied
    to id -1), bit for bit in ids and distances (IVF: all four fields);
    ``coverage`` is the surviving share, every batch counts as
    degraded, the dead shard launches nothing and marking all four dead
    raises.  Returns the window's launches."""
    import dataclasses
    import torch
    from repro_torch.index.ivf import IVFTwoStep
    from repro_torch.resilience import SearchBudget
    eng = engine_load(f"{name}-dead", path, mesh=data_mesh(4, ["cuda"]),
                      query_tile=TILE)
    eng.mark_shard_dead(DEAD_SHARD)
    view, index = eng._view, eng.index
    n = index.codes.shape[0]
    ivf = isinstance(index, IVFTwoStep)
    if ivf:
        a, b = view.list_rows[DEAD_SHARD]
        lists = index.ivf.lists.clone()
        lists[a:b] = -1
        survivors = dataclasses.replace(
            index, ivf=index.ivf._replace(lists=lists))
        alive = n - int(index.ivf.list_lens[a:b].sum())
    else:
        a, b = view.rows[DEAD_SHARD]
        survivors = dataclasses.replace(
            index, codes=torch.cat([index.codes[:a], index.codes[b:]]))
        alive = n - (b - a)
    ref = engine_over(f"{name}-survivors", survivors, query_tile=TILE)
    qs = query_tiles(seed, int(index.C.shape[-1]), batches)
    eng.warm(TILE)
    ref.warm(TILE)
    got, ms, host, launches, mb = served_window(eng, qs, SearchBudget())
    want = [ref.search(q) for q in qs]
    if not ivf:
        want = [w._replace(indices=torch.where(
            w.indices >= a, w.indices + (b - a), w.indices)) for w in want]
    fields = TOPK_FIELDS + (SCALARS if ivf else ())
    same = all(same_result(g, w, fields) for g, w in zip(got, want))
    check(same, f"dead {name}: answers != the survivors' engine's")
    expect = shard_launches(index, 3, batches)
    check(launches == expect, f"dead {name}: launches {launches} != "
                              f"{expect}")
    cov = got[0].meta.coverage
    check(cov == alive / n and all(r.meta.degraded for r in got)
          and eng.stats["degraded"] == batches,
          f"dead {name}: coverage {cov} (want {alive / n}), degraded "
          f"{eng.stats['degraded']}")
    try:
        eng.mark_shard_dead(0, 2, 3)
        raised = False
    except ValueError:
        raised = True
    check(raised and view.dead_shards == {DEAD_SHARD},
          f"dead {name}: marking all shards dead did not raise")
    log(f"dead shard {name}: shard {DEAD_SHARD} of 4 dead, coverage {cov} "
        f"({alive} of {n} points); {ms:.4f} ms a tile (events), "
        f"{host:.4f} ms (host clock); launches {launches}; peak {mb:.1f} "
        f"MiB; {', '.join(fields)} == the survivors' engine: {same}; "
        f"degraded batches {eng.stats['degraded']}; all four dead raises: "
        f"{raised}; {card}")
    return launches


def grow_sharded(path, *, seed, batches, card):
    """A sharded two-step engine (4 shards) ``add``s ``GROW`` points:
    equal bit for bit to the unsharded engine grown by the same points;
    a second sharded engine with a dead shard keeps it through the add
    and serves none of its rows.  Returns the launches of the adds and
    the windows."""
    import numpy as np
    import torch
    from repro_torch.core.codebooks import decode
    from repro_torch.resilience import SearchBudget
    plain = engine_load("grow-plain", path, query_tile=TILE)
    eng = engine_load("grow-D4", path, mesh=data_mesh(4, ["cuda"]),
                      query_tile=TILE)
    dead = engine_load("grow-D4-dead", path, mesh=data_mesh(4, ["cuda"]),
                       query_tile=TILE)
    dead.mark_shard_dead(DEAD_SHARD)
    C = plain.index.C
    K, m, d = C.shape
    rng = np.random.default_rng(seed + 17)
    new = (decode(C, torch.from_numpy(rng.integers(0, m, (GROW, K))).cuda())
           + 0.01 * torch.from_numpy(rng.standard_normal(
               (GROW, d), dtype=np.float32)).cuda())
    total = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.add(new)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    plain.add(new)
    dead.add(new)
    add_into(total, read_launches())
    qs = query_tiles(seed + 1, d, batches)
    want = [plain.search(q) for q in qs]
    got, ms, host, launches, _ = served_window(eng, qs, SearchBudget())
    add_into(total, launches)
    same = all(same_result(g, w) for g, w in zip(got, want))
    check(eng.n == plain.n == plain.index.codes.shape[0] and same,
          "grow: the sharded engine's answers != the grown unsharded "
          "engine's")
    res, _, _, launches, _ = served_window(dead, qs, SearchBudget())
    add_into(total, launches)
    a, b = dead._view.rows[DEAD_SHARD]
    n = dead.n
    kept = (dead._view.dead_shards == {DEAD_SHARD}
            and res[0].meta.coverage == (n - (b - a)) / n
            and all(bool(((r.indices < a) | (r.indices >= b)).all())
                    for r in res))
    check(kept, "grow: the dead shard did not survive the add")
    log(f"grow sharded: +{GROW} points through AnnEngine.add on 4 shards "
        f"in {add_s:.4f} s (host clock), n={n}; ids, distances, pass_rate, "
        f"avg_ops == the grown unsharded engine: {same}; {ms:.4f} ms a tile "
        f"(events); the dead shard {DEAD_SHARD} kept through the add, "
        f"coverage {res[0].meta.coverage}, none of its rows [{a}, {b}) "
        f"served: {kept}; {card}")
    return total


def sharded_serving(paths, *, seed, batches, card):
    """Phase 13's serving half: every sharded cell, the dead-shard cells
    and the grow cell.  Returns their launches."""
    total = {}
    for name, D in SHARDED:
        add_into(total, sharded_cell(name, paths[name], D, seed=seed,
                                     batches=batches, card=card))
    for name in ("two-step-f32", "ivf-f32"):
        add_into(total, dead_shard_cell(name, paths[name], seed=seed,
                                        batches=batches, card=card))
    add_into(total, grow_sharded(paths["two-step-f32"], seed=seed,
                                 batches=batches, card=card))
    return total


def dp_codes(params, x, D, embed_apply):
    """The hard codes of a data-parallel step's batch (its D row slices
    embedded one by one) and the embeddings, on the CPU."""
    import torch
    parts = [batch_codes(params, xs, embed_apply)
             for xs in torch.chunk(x, D)]
    return (torch.cat([c for c, _ in parts]).cpu(),
            torch.cat([e for _, e in parts]).cpu())


def fit_data_parallel(seed: int, card: str, fig1_model):
    """Phase 13's training half: phase 11's Figure 1 cell through
    ``fit(mesh=)`` on a 4-shard mesh on the card (64 rows a shard), with
    every step's inputs kept: each data-parallel step is run again on
    the CPU's 4-shard mesh and as the card's single-device step from the
    same inputs, both to phase 11's gate (loss terms rtol 1e-4, psi_size
    equal, state rtol 1e-4 with an atol of a leaf's magnitude times the
    larger of ``STATE_ATOL`` and ``SPREAD_FACTOR`` x the CPU's own
    spread; a step whose batch codes flip at a near tie is counted, not
    compared).  Then the model served two-step at topk 50 over the test
    queries: MAP@50 beside phase 11's model's.  Returns the launches of
    the fit and the served window."""
    import numpy as np
    import torch
    from repro_torch.configs import ICQConfig
    from repro_torch.data import make_table1_dataset
    from repro_torch.index import make_index
    from repro_torch.index.base import mean_average_precision
    from repro_torch.trainer import epoch as epoch_mod
    from repro_torch.trainer import fit

    f = FIG1
    D = 4
    xtr, ytr, xte, yte = make_table1_dataset(f["dataset"])
    cfg = ICQConfig(d=f["d"], num_codebooks=f["K"], codebook_size=f["m"],
                    num_fast=f["num_fast"])
    mesh, cpu_mesh = data_mesh(D, ["cuda"]), data_mesh(D, "cpu")
    kept, built = [], []
    joint = epoch_mod.joint
    make_step = joint.make_train_step

    def recording(*a, **kw):
        built.append((a, kw))
        step = make_step(*a, **kw)

        def kept_step(p, o, v, batch):
            inputs = tree_apply(torch.clone, (p, o, v))
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = step(p, o, v, batch)
            e.record()
            kept.append((inputs, batch, out, (s, e)))
            return out
        return kept_step

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    joint.make_train_step = recording
    t0 = time.perf_counter()
    try:
        model = fit(seed, xtr, ytr, cfg, mode="icq", epochs=f["epochs"],
                    batch_size=f["batch"], lr=f["lr"], mesh=mesh)
    finally:
        joint.make_train_step = make_step
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = read_launches()
    (a, kw), = built
    check(kw.get("axis_name") == "data" and kw.get("mesh") is mesh,
          f"fit(mesh=) built the step with {kw}")
    embed_apply = a[1]
    single = make_step(*a, **{**kw, "axis_name": None, "mesh": None})
    cpu_dp = make_step(*a, **{**kw, "mesh": cpu_mesh})
    step_ms = [s.elapsed_time(e) for _, _, _, (s, e) in kept]
    t0 = time.perf_counter()
    sd_times = []
    terms = ("l_e", "l_c", "l_cq", "l_p", "l_icq", "total")

    def cpu(tree):
        return tree_apply(lambda t: t.detach().cpu(), tree)

    def terms_close(got, want):
        return (all(np.isclose(float(got[k]), float(want[k]), rtol=1e-4,
                               atol=0.0) for k in terms)
                and int(got["psi_size"]) == int(want["psi_size"]))

    needs = {"cpu": {}, "single": {}}
    flips = {"cpu": [], "single": []}
    spread = 0.0
    for i, (inputs, (x, y), out, _) in enumerate(kept):
        got = cpu(out)
        p, o, v = cpu(inputs)
        xc, yc = x.cpu(), y.cpu()
        codes_dp, _ = dp_codes(inputs[0], x, D, embed_apply)
        # the CPU's data-parallel step from the same inputs
        want = cpu_dp(p, o, v, (xc, yc))
        rev = cpu_dp(p, o, v, (xc.flip(0), yc.flip(0)))
        spread = max(spread, max(atol_needed(rev[:3], want[:3])))
        codes_cpu, emb = dp_codes(p, xc, D, embed_apply)
        if torch.equal(codes_dp, codes_cpu):
            check(terms_close(got[3], want[3]),
                  f"dp step {i}: the card's loss terms != the CPU's "
                  f"data-parallel step's: {got[3]} against {want[3]}")
            needs["cpu"][i] = atol_needed(got[:3], want[:3])
        else:
            tie, count = near_ties(codes_dp, codes_cpu, emb, p["C"])
            check(tie, f"dp step {i}: codes differ between the card and "
                       f"the CPU beyond a near tie")
            flips["cpu"].append((i, count))
        # the card's single-device step from the same inputs
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        one = single(*inputs, (x, y))
        e.record()
        sd_times.append((s, e))
        codes_one, emb_one = batch_codes(inputs[0], x, embed_apply)
        if torch.equal(codes_dp, codes_one.cpu()):
            check(terms_close(got[3], cpu(one[3])),
                  f"dp step {i}: the loss terms != the card's "
                  f"single-device step's: {got[3]} against {one[3]}")
            needs["single"][i] = atol_needed(got[:3], cpu(one[:3]))
        else:
            tie, count = near_ties(codes_dp, codes_one.cpu(),
                                   emb_one.cpu(), p["C"])
            check(tie, f"dp step {i}: codes differ from the single-device "
                       f"step's beyond a near tie")
            flips["single"].append((i, count))
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    sd_ms = [s.elapsed_time(e) for s, e in sd_times]
    atol = max(STATE_ATOL, SPREAD_FACTOR * spread)
    for against, ns in needs.items():
        worst = max(max(n) for n in ns.values())
        off = [(i, j, n) for i, row in ns.items() for j, n in enumerate(row)
               if n > atol]
        log(f"dp gate against the {against} step: {len(ns)} of "
            f"{len(kept)} steps compared; loss terms to rtol 1e-4 and "
            f"psi_size equal in each; params, opt_state and var_state need "
            f"an atol of {worst:.3e} of a leaf's magnitude beside rtol 1e-4 "
            f"(allowed {atol:.3e}: {STATE_ATOL} or {SPREAD_FACTOR}x the "
            f"CPU's own data-parallel spread on reversed rows, "
            f"{spread:.3e}); near-tie code flips (step, codes): "
            f"{flips[against]}")
        check(not off, f"dp gate against the {against} step: (step, leaf, "
                       f"atol needed) beyond {atol}: {off}")
        check(len(ns) >= len(kept) * 9 // 10,
              f"dp gate against the {against} step: only {len(ns)} of "
              f"{len(kept)} steps compared")
    chunks_n = -(-xtr.shape[0] // 8192)
    want = {"kmeans_assign": cfg.num_codebooks * (25 + 1)
            + chunks_n * cfg.num_codebooks, "icm_encode": chunks_n}
    check(all(launches[k] == want[k] for k in want)
          and sum(launches.values()) == sum(want.values()),
          f"fit(mesh=) launched {launches}, expected {want}")

    def served_map(mdl):
        index = make_index("two-step", mdl.codes, mdl.C, mdl.structure,
                           topk=f["topk"])
        res = index.search(mdl.embed(torch.from_numpy(xte).cuda()))
        return index, res, float(mean_average_precision(
            res.indices, torch.from_numpy(ytr).cuda(),
            torch.from_numpy(yte).cuda()))

    reset_launches()
    index, res, mapv = served_map(model)
    served = read_launches()
    check(served == expected_launches(index, 1) and mapv > 0.1
          and bool(torch.isfinite(res.distances[:, 0]).all()),
          f"dp fit: MAP@{f['topk']} {mapv}, launches {served}")
    _, _, map11 = served_map(fig1_model)
    log(f"dp fit fig1 {f['dataset']} K={f['K']} m={f['m']} d={f['d']} on "
        f"{D} shards of {f['batch'] // D} rows on {mesh.lead}: fit "
        f"{fit_s:.4f} s (host clock, each step's inputs kept); data-parallel "
        f"step {float(np.median(step_ms)):.4f} ms (CUDA events, median of "
        f"{len(step_ms)}), the single-device step from the same inputs "
        f"{float(np.median(sd_ms)):.4f} ms; gate {gate_s:.1f} s; peak "
        f"{peak_mb:.1f} MiB; launches {launches}; MAP@{f['topk']} "
        f"{mapv:.6f} (phase 11's single-device model: {map11:.6f}), avg_ops "
        f"{float(res.avg_ops):.6f}, pass_rate {float(res.pass_rate):.6f}; "
        f"{card}")
    return {k: launches[k] + served[k] for k in launches}

# ------------------------------------------------ phase 14: LM serving ----

# the served LM cells: (label, arch, bf16 under scale_config, batch,
# prompt, decode steps, layers: 0 = the config's depth).  A:
# tinyllama-1.1b at full width in f32, a prompt within attn_chunk (the
# full_attention branch); B: gemma-7b at full width in bf16 (GeGLU, tied
# embeddings, head width 256), a prompt past attn_chunk (the chunked
# branch); C: moonshot-v1-16b-a3b (hf moonshotai/Moonlight-16B-A3B) at
# full width and depth in bf16, 1 dense + 47 MoE layers of 64 experts
# top-6 + 2 shared, batched chat serving; D: deepseek-v2-236b
# (arXiv:2405.04434) at full width in bf16, MLA (q_lora 1536, kv_lora
# 512, q/k 128 + 64, v 128) and 160 experts top-6 + 2 shared, its depth
# cut from 60 layers to 6 (1 MLA dense + 5 MLA MoE: 42.5 GB; the 60
# layers are 472 GB, past one card), a prompt past attn_chunk (on the
# card K/V materialized and one flash launch a layer)
LM_CELLS = (("A", "tinyllama-1.1b", False, 8, 512, 32, 0),
            ("B", "gemma-7b", True, 1, 2048, 16, 0),
            ("C", "moonshot-v1-16b-a3b", True, 8, 512, 16, 0),
            ("D", "deepseek-v2-236b", True, 1, 2048, 16, 6))
# gate 1: each arch's model on the card against the CPU from the same
# weights, in f32 at batch 1, a 64-token prompt and 4 decode steps (the
# MoE archs at depth 2: the first dense layer and one MoE layer).
# Logits within LM_TOL of the largest |logit|: each of tinyllama's 22
# layers sums 2048 to 5632 f32 products in cuBLAS's order against the
# CPU's, each sum about sqrt(n) 2^-24 ~ 5e-6 relative, the errors
# growing with depth; the flash kernel against the plain softmax adds
# 2e-5 (phase 7's)
LM_GATE = dict(batch=1, prompt=64, steps=4)
LM_TOL = 2e-4
LM_GATE_ARCHS = (("tinyllama-1.1b", 0), ("moonshot-v1-16b-a3b", 2),
                 ("deepseek-v2-236b", 2))
# gate 4: cell C's layer 1 (the first MoE layer) at this many tokens,
# capacity_factor = E so that no assignment drops, against the
# every-expert oracle in bf16 (TOL_BF16 of the largest output)
MOE_ORACLE_TOKENS = 512
TOL_BF16 = 2.0 ** -5


def lm_config(arch, bf16, layers=0):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import scale_config
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return scale_config(cfg) if bf16 else cfg


def lm_params(cfg, seed):
    import torch
    from repro_torch.models import build_model
    return build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed))


def lm_card_gate(seed: int, arch: str, layers: int = 0):
    """Gate 1: ``arch``'s model (f32, ``layers`` deep) on the card
    against the CPU from the same weights: prefill and decode logits
    within ``LM_TOL`` of the largest |logit|, greedy tokens equal
    wherever the CPU's top-2 gap exceeds that; both fed the card's
    greedy tokens.  Returns (worst error over bound, seconds)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = lm_config(arch, False, layers)
    model = build_model(cfg)
    card = lm_params(cfg, seed)
    cpu = cpu_tree(card)
    b, s, steps = LM_GATE["batch"], LM_GATE["prompt"], LM_GATE["steps"]
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)
    lg, cg = model.prefill(card, {"tokens": toks}, s + steps)
    lc, cc = model.prefill(cpu, {"tokens": toks}, s + steps)
    worst = 0.0
    for step in range(steps + 1):
        got, want = lg[:, -1].float().cpu(), lc[:, -1].float()
        bound = LM_TOL * max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        worst = max(worst, err / bound)
        top2 = want.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        log(f"lm gate card vs cpu {arch} f32 {cfg.num_layers} layers "
            f"{'prefill' if step == 0 else f'decode {step}'}: max |logit| "
            f"{float(want.abs().max()):.4f}, max_abs_err {err:.3e} (bound "
            f"{bound:.3e}), top-2 gap {float(gap.min()):.4e}, greedy "
            f"{'equal' if bool(same.all()) else 'DIFFERENT'}")
        check(err <= bound, f"lm gate {arch}: card logits {err} from the "
                            f"CPU's (bound {bound}) at step {step}")
        check(bool((same | (gap <= bound)).all()),
              f"lm gate {arch}: greedy token differs at step {step} with "
              f"top-2 gap {float(gap.min())} > {bound}")
        if step < steps:
            tok = got.argmax(-1).to(torch.int32)[:, None]
            lg, cg = model.decode_step(card, tok.cuda(), cg)
            lc, cc = model.decode_step(cpu, tok, cc)
    del card, cpu, cg, cc
    seconds = time.perf_counter() - t0
    log(f"lm gate card vs cpu {arch}: {seconds:.1f} s "
        f"({cfg.param_count() / 1e9:.2f} B params on each side)")
    return worst, seconds


def lm_icq_gate(seed: int):
    """Gate 3: at cell A's head geometry (b 8, S 544, 4 KV heads, 32
    query heads, dh 64) on the card, ICQ-KV attention with top_c = S
    (no pruning) equals exact attention over the dequantized cache
    (rtol 1e-5, atol 1e-5 of the largest output)."""
    import torch
    from repro_torch.index.base import full_f32_matmul
    from repro_torch.quant import (ICQKVConfig, build_icq_kv_cache,
                                   dequantize_int8, icq_kv_decode_attention)
    from repro_torch.quant.kv_cache import reference_decode_attention
    b, S, kvh, H, dh = 8, 544, 4, 32, 64
    g = torch.Generator(device="cuda").manual_seed(seed + 1400)
    hot = torch.where(torch.randperm(dh, generator=g, device="cuda") < 16,
                      3.0, 0.3)
    k = torch.randn((b, S, kvh, dh), generator=g, device="cuda") * hot
    v = torch.randn((b, S, kvh, dh), generator=g, device="cuda")
    q = torch.randn((b, 1, H, dh), generator=g, device="cuda") * hot
    cfg = ICQKVConfig(d_fast=16)
    with full_f32_matmul():
        cache = build_icq_kv_cache(cfg, k, v, max_len=S)
        got = icq_kv_decode_attention(q, cache, cfg, S - 1, top_c=S)
        inv = torch.argsort(cache["perm"].long(), dim=-1)
        kd = dequantize_int8(cache["kq"], cache["ks"])
        kd = torch.gather(kd, -1, inv[None, None].expand(kd.shape))
        vd = dequantize_int8(cache["vq"], cache["vs"])
        want = reference_decode_attention(q, kd, vd, S - 1)
        raw = reference_decode_attention(q, k, v, S - 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.isclose(got, want, rtol=1e-5, atol=1e-5 * max(
        1.0, float(want.abs().max()))).all())
    log(f"lm gate icq-kv top_c = S = {S} (b={b} kvh={kvh} H={H} dh={dh} "
        f"d_fast=16): max_abs_err {err:.3e} against exact attention over "
        f"the dequantized cache: {'within' if ok else 'OUTSIDE'}; "
        f"{float((got - raw).abs().max()):.3e} against the raw cache (int8 "
        f"error, reported)")
    check(ok, f"icq_kv_decode_attention at top_c = S != exact attention "
              f"over the dequantized cache: {err}")


def layer0_qkv(cfg, params, toks):
    """Layer 0's q, k, v of the prefill of ``toks`` (the shapes and
    types the model hands the flash kernel; MLA's per-head K and V
    materialized as its card path does)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import mla as mla_mod
    from repro_torch.models.nn import as_dtype
    from repro_torch.models.transformer import _layer, _norm_apply
    x = params["embed"][torch.from_numpy(toks).cuda().long()].to(
        as_dtype(cfg.compute_dtype))
    if cfg.tie_embeddings:
        x = x * torch.tensor(float(cfg.d_model) ** 0.5, dtype=x.dtype,
                             device="cuda")
    lp = _layer(params["seg0"], 0)
    h = _norm_apply(cfg, lp["norm1"], x)
    pos = torch.arange(toks.shape[1], device="cuda")
    if cfg.mla:
        return mla_mod.mla_qkv(lp["attn"], h, cfg, pos)
    return attn.qkv_project(lp["attn"], h, cfg, pos)


def sdpa_ms(q, k, v):
    """The library yardstick: ``scaled_dot_product_attention``'s time at
    the kernel's operands ((b, heads, s, width) views), or (None, its
    refusal) where PyTorch does not take them."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    call = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    try:
        call()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return time_ms(call, 10), None


def lm_flash_at_cell(label, arch, cfg, params, toks):
    """Gate 2 at a cell's served shape: ``ops.flash_attention``'s kernel
    on layer 0's q, k, v against its plain version (phase 7's
    tolerance), then its time beside the bound, the plain version and
    SDPA (or SDPA's refusal).  Returns the kernel's record at this
    shape."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = layer0_qkv(cfg, params, toks)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_torch(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = flash_tolerance(q.dtype)
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isclose(got.float(), want.float(), rtol=tol,
                            atol=tol).all())
    b, s, H, dh = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    name = str(q.dtype).split(".")[-1]
    shape = f"b={b} s={s} H={H} KVH={KVH} dh={dh} dv={dv}"
    log(f"lm gate flash cell {label} {arch} layer 0 {shape} {name} "
        f"({flash_body(q.dtype, dh, dv)}): max_abs_err {err} (tolerance "
        f"{tol}): {'within' if ok else 'OUTSIDE'}")
    check(ok, f"flash_attention kernel != plain version at cell {label}'s "
              f"shape: max_abs_err {err}")
    del want
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v), 5)
    plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v), 2)
    lib_ms, refused = sdpa_ms(q, k, v)
    nbytes, nops = attention_work(b, s, s, H, KVH, dh, True,
                                  q.element_size(), dv)
    b_ms, b_by = bound_ms(nbytes, nops, BF16_OPS_PER_S
                          if q.dtype == torch.bfloat16 else F32_OPS_PER_S)
    lib = (f"library scaled_dot_product_attention {lib_ms:.4f} ms, kernel "
           f"/ SDPA {ms / lib_ms:.2f}" if lib_ms is not None else
           f"library scaled_dot_product_attention refused: {refused}")
    log(f"kernel flash_attention cell {label} {arch} {shape} causal {name}:"
        f" {ms:.4f} ms ({nops / ms / 1e9:.2f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {lib}")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:71",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def mla_flash_f32_gate(seed: int):
    """Gate 2 (f32): the (192, 128) instance's FMA body against its plain
    version at a small MLA shape (b 1, s 300, 16 heads), 2e-5."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = attention_operands(seed + 1450, 1, 300, 300, 16, 16, 192,
                                 torch.float32, 128)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_torch(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = flash_tolerance(torch.float32)
    err = float((got - want).abs().max())
    ok = bool(torch.isclose(got, want, rtol=tol, atol=tol).all())
    log(f"lm gate flash f32 b=1 s=300 H=16 dh=192 dv=128 "
        f"({flash_body(torch.float32, 192, 128)}): max_abs_err {err} "
        f"(tolerance {tol}): {'within' if ok else 'OUTSIDE'}")
    check(ok, f"f32 (192, 128) flash kernel != plain version: {err}")


def moe_determinism_gate(cfg, params, toks, steps: int = 2):
    """Gate 3: two prefills of the cell from the same inputs give bit for
    bit equal logits and caches, and ``steps`` decode steps from those
    equal caches bit for bit equal logits and caches."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg)
    max_len = toks.shape[1] + steps
    (l1, c1), (l2, c2) = (model.prefill(params, {"tokens": toks}, max_len)
                          for _ in range(2))
    bufs = [(seg, name) for seg in c1 if seg != "pos" for name in c1[seg]]
    same = [torch.equal(l1, l2)]
    same_cache = [all(torch.equal(c1[g][n], c2[g][n]) for g, n in bufs)]
    tok = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(steps):
        d1, c1 = model.decode_step(params, tok, c1)
        d2, c2 = model.decode_step(params, tok, c2)
        same.append(torch.equal(d1, d2))
        tok = d1[:, -1].argmax(-1).to(torch.int32)[:, None]
    same_cache.append(all(torch.equal(c1[g][n], c2[g][n]) for g, n in bufs))
    same_cache = all(same_cache)
    log(f"lm gate moe determinism {cfg.name}: logits of 2 prefills and "
        f"{steps} decode steps {'equal' if all(same) else same}, caches "
        f"({len(bufs)} buffers) {'equal' if same_cache else 'DIFFERENT'} "
        "bit for bit")
    check(all(same) and same_cache,
          f"moe: two runs from the same inputs differ ({same}, caches "
          f"{same_cache})")


def moe_oracle_gate(cfg, params, seed: int):
    """Gate 4: the dispatch on the card at cell C's layer 1 (its first
    MoE layer), ``MOE_ORACLE_TOKENS`` tokens, capacity_factor = E (no
    assignment can drop: C >= T k), against the port's every-expert
    oracle ``moe_apply_dense_reference``, bf16 within ``TOL_BF16`` of
    the largest output."""
    import dataclasses
    import torch
    from repro_torch.index.base import full_f32_matmul
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer
    big = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    T = MOE_ORACLE_TOKENS
    check(moe.expert_capacity(T, big) >= T * cfg.experts_per_token,
          "gate 4's capacity can drop")
    ffn = _layer(params["seg1"], 0)["ffn"]
    g = torch.Generator(device="cuda").manual_seed(seed + 1460)
    x = torch.randn((1, T, cfg.d_model), generator=g, device="cuda").to(
        params["embed"].dtype)
    with full_f32_matmul():
        got, _ = moe.moe_apply(ffn, x, big)
        want = moe.moe_apply_dense_reference(ffn, x, big)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    bound = TOL_BF16 * max(1.0, float(want.float().abs().max()))
    log(f"lm gate moe dispatch vs every-expert oracle {cfg.name} layer 1, "
        f"T={T}, C={moe.expert_capacity(T, big)} (no drops), "
        f"{str(x.dtype).split('.')[-1]}: max_abs_err {err:.4e} (bound "
        f"{bound:.4e}, max |out| {float(want.float().abs().max()):.4f}): "
        f"{'within' if err <= bound else 'OUTSIDE'}")
    check(err <= bound, f"moe dispatch != oracle at layer 1: {err} > "
                        f"{bound}")


def profile_lm(label, cfg, params, toks, steps, out_dir):
    """With ``--profile``: ``torch.profiler`` over one prefill and 4
    decode steps of a cell (after its counted window): wall time (host
    clock, profiler on), device busy time, the device's idle share,
    kernel launches, the ops by device and by host time; a Chrome trace
    to ``<out_dir>/profile_lm_<label>.json``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import build_serve_fns
    prefill_fn, decode_fn, _ = build_serve_fns(cfg)
    max_len = toks.shape[1] + steps
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    logits, caches = prefill_fn(params, batch, max_len)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    for what, reps in (("prefill", 1), ("decode", 4)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                if what == "prefill":
                    prefill_fn(params, batch, max_len)
                else:
                    logits, caches = decode_fn(params, tok, caches)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / reps
        launches = sum(e.count for e in kernels) / reps
        log(f"profile lm cell {label} {what}: {wall_ms:.3f} ms a call "
            f"(host clock, profiler on), device busy {busy_ms:.3f} ms, "
            f"idle share {1.0 - busy_ms / wall_ms:.4f}, {launches:.1f} "
            f"kernel launches a call")
        log(f"--- lm cell {label} {what}: ops by device time ---\n"
            + _op_table(prof, "self_device_time_total", 15))
        log(f"--- lm cell {label} {what}: ops by host time ---\n"
            + _op_table(prof, "self_cpu_time_total", 15))
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"profile_lm_{label}_{what}.json"))


def lm_serving(seed: int, card: str, profile_dir=None):
    """Phase 14: the LMs served through ``launch.serve.serve_lm`` (the
    CLI's path) on the card at full width, cells ``LM_CELLS`` (A also
    through the ICQ-KV decode), one after the other, each freed before
    the next, with the gates: 1 card against CPU per arch, 2 the flash
    kernel at every cell's layer-0 shape (and the f32 (192, 128) body),
    3 and 4 (MoE determinism and the dispatch against its oracle) at
    cell C, the ICQ-KV top_c = S check, and the launch counts.  With
    ``profile_dir``, ``profile_lm`` of each cell.  Returns (the served
    cells' launches, the flash kernel's records at cell B's shape and at
    cell D's (the (192, 128) instance, with cell D's launches))."""
    import gc
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_lm
    log(f"phase 14: torch.get_float32_matmul_precision() = "
        f"{torch.get_float32_matmul_precision()!r}, "
        f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matrix products are on")
    t0 = time.perf_counter()
    for arch, layers in LM_GATE_ARCHS:
        lm_card_gate(seed, arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
    lm_icq_gate(seed)
    mla_flash_f32_gate(seed)
    total = {k: 0 for k in read_launches()}
    records = {}
    for label, arch, bf16, b, s, steps, layers in LM_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        t_cell = time.perf_counter()
        cfg = lm_config(arch, bf16, layers)
        t_init = time.perf_counter()
        params = lm_params(cfg, seed)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init
        reset_launches()
        out = serve_lm(cfg, prompt_len=s, decode_steps=steps, batch=b,
                       device="cuda", seed=seed, icq_kv=label == "A",
                       params=params, verbose=False)
        launches = read_launches()
        want = {k: 0 for k in launches}
        want["flash_attention"] = 2 * cfg.num_layers   # warm + timed
        log(f"lm cell {label} launches {launches} (prefill "
            f"{out['launches']['prefill']}, decode "
            f"{out['launches']['decode']})")
        check(launches == want and out["launches"] == dict(
            prefill=cfg.num_layers, decode=0),
            f"lm cell {label}: launches {launches} / {out['launches']}, "
            f"want {cfg.num_layers} flash a prefill and none a decode step")
        for k in total:
            total[k] += launches[k]
        lg, toks = out["logits"], out["tokens"]
        check(tuple(lg.shape) == (b, steps + 1, cfg.vocab_size)
              and bool(torch.isfinite(lg).all())
              and toks.shape == (b, steps + 1)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"lm cell {label}: logits {tuple(lg.shape)} or tokens wrong")
        depth = (f", depth cut to {cfg.num_layers} layers" if layers
                 else "")
        log(f"lm cell {label} {arch} {'bf16' if bf16 else 'f32'} "
            f"({cfg.param_count() / 1e9:.3f} B params{depth}, init "
            f"{t_init:.2f} s) batch {b} prompt {s} decode {steps}: "
            f"prefill {out['prefill_ms']:.3f} ms "
            f"({b * s / out['prefill_ms'] * 1e3:.0f} tokens/s), decode "
            f"{out['decode_ms']:.3f} ms a step (median, CUDA events) = "
            f"{out['tokens_per_s']:.1f} tokens/s, peak "
            f"{out['peak_mib']:.1f} MiB; {card}")
        if label == "A":
            r = out["icq"]
            log(f"lm cell A icq-kv d_fast={r['d_fast']} top_c={r['top_c']}:"
                f" {r['decode_ms']:.3f} ms a step (median) against dense "
                f"{out['decode_ms']:.3f}; max logit err "
                f"{r['max_logit_err']:.4e} against the dense steps (max "
                f"|logit| {float(lg[:, 1:].abs().max()):.4f}), greedy "
                f"tokens agree {r['agree']:.4f} (reported, not gated); "
                f"cache bytes a step {r['bytes']['dense']} dense -> "
                f"{r['bytes']['icq']} ICQ "
                f"({r['bytes']['dense'] / r['bytes']['icq']:.2f}x less); "
                f"{card}")
            # the same steps with no top-c cut: what int8 alone costs
            full = serve_lm(cfg, prompt_len=s, decode_steps=steps, batch=b,
                            device="cuda", seed=seed, icq_kv=True,
                            icq_top_c=s + steps, params=params,
                            verbose=False)["icq"]
            log(f"lm cell A icq-kv control top_c = S = {s + steps}: "
                f"{full['decode_ms']:.3f} ms a step, max logit err "
                f"{full['max_logit_err']:.4e}, greedy tokens agree "
                f"{full['agree']:.4f} (reported)")
        del out, lg
        toks0 = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                     (b, s), dtype=np.int32)
        rec = lm_flash_at_cell(label, arch, cfg, params, toks0)
        if label == "C":
            moe_determinism_gate(cfg, params, toks0)
            moe_oracle_gate(cfg, params, seed)
        if profile_dir:
            profile_lm(label, cfg, params, toks0, steps, profile_dir)
        if label == "B":
            records["flash_attention"] = rec
        if label == "D":
            records["flash_attention_mla"] = dict(
                rec, name="flash_attention (192, 128)",
                launches=launches["flash_attention"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"lm cell {label} ran {time.perf_counter() - t_cell:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB left "
            "allocated after it")
    log(f"phase 14 ran {time.perf_counter() - t0:.1f} s; the "
        "flash_attention records are cell B's and cell D's served prefill "
        "shapes")
    return total, records


def cuda_held(label: str) -> int:
    """``torch.cuda.memory_allocated()`` after ``gc.collect()``, and every
    live CUDA tensor of 64 MiB or more that gc reaches, with the types
    of the objects that refer to it."""
    import gc
    import warnings
    import torch
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    no_ws = torch.cuda.memory_allocated()
    big = []
    warnings.simplefilter("ignore", FutureWarning)   # deprecated aliases
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
            nbytes = obj.untyped_storage().nbytes()
        except Exception:        # objects gc tracks that torch cannot read
            continue
        if nbytes >= 64 << 20:
            refs = sorted({type(r).__name__ for r in gc.get_referrers(obj)}
                          - {"list", "frame"})
            big.append(f"{tuple(obj.shape)} {obj.dtype} "
                       f"{nbytes / 2**20:.0f} MiB held by {refs}")
    log(f"memory {label}: {alloc} B allocated ({alloc / 2**20:.1f} MiB), "
        f"{no_ws} B once PyTorch's cuBLAS workspaces are cleared; live "
        f"CUDA tensors >= 64 MiB: {big or 'none'}")
    return alloc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database points of the main-path cells")
    ap.add_argument("--batches", type=int, default=3,
                    help="64-query batches served per cell")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace 5 served tiles of the two-step-f32 "
                         "and ivf-f32 cells, phase 10's pipelined and "
                         "off batches, 10 of phase 11's train steps "
                         "and phase 14's prefill and decode steps, "
                         "with torch.profiler (Chrome traces to DIR)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    for src, inst, regs, st, ld in scan_kernel_registers(logs):
        log(f"registers {src} {inst}: {regs} registers, spill stores "
            f"{st} B, spill loads {ld} B")

    check_modes(args.seed)
    check_slab_modes(args.seed)
    check_slab_adversarial(args.seed)
    # codes wider than a byte: int32 rows at m = 512 and 1024
    wide = ((8, 8, 512), (8, 8, 1024))
    check_modes(args.seed + 1, wide)
    check_slab_modes(args.seed + 1, wide)
    check_slab_adversarial(args.seed + 1, ((8, 1024),))
    check_wide_codes(args.seed)
    check_kmeans(args.seed)
    records = time_kernels(args.seed, args.n)

    cells = (("two-step-f32", SIFT, "two-step", "f32", 8),
             ("two-step-int8", SIFT, "two-step", "int8", 8),
             ("flat-f32", SIFT, "flat", "f32", 8),
             ("two-step-int8-4bit", dict(d=128, K=16, m=16, num_fast=4),
              "two-step", "int8", 4))
    total = {k: 0 for k in read_launches()}
    paths = {}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as workdir:
        for name, *cell in cells:
            path = paths[name] = save_flat_cell(
                name, *cell, seed=args.seed, n=args.n, workdir=workdir)
            launches, engine, _ = serve_saved(name, path, seed=args.seed,
                                              n=args.n, batches=args.batches)
            for k in total:
                total[k] += launches[k]
            if args.profile and name == "two-step-f32":
                profile_served(name, engine, seed=args.seed, batches=5,
                               out_dir=args.profile)
            del engine
        ivf_total, ivf_records, paths["ivf-f32"] = ivf_cells(
            args.seed, args.n, args.batches, workdir, args.profile)
        for name in ("two-step-f32", "flat-f32", "ivf-f32"):
            add(ladder_cell(name, paths[name], seed=args.seed,
                            batches=args.batches, card=card))
        fault_check(paths["two-step-f32"], seed=args.seed)
        before = cuda_held("before phase 10")
        add(request_path(paths, seed=args.seed, batches=args.batches,
                         card=card, profile_dir=args.profile))
        log(f"memory: phase 10 left {cuda_held('after phase 10') - before}"
            " B more allocated than before it")
        add(wide_cells(args.seed, args.n, args.batches, workdir))
        enc_total, records["icm_encode"] = encode_and_grow(args.seed, args.n,
                                                           workdir)
        shard_total = sharded_serving(paths, seed=args.seed,
                                      batches=args.batches, card=card)
    check_kernel_ops(args.seed)
    ops_total, ops_records = kernel_ops(args.seed, args.n)
    train_total, fig1_model = train_cell(args.seed, card,
                                         profile_dir=args.profile)
    front_total = front_door(args.seed, args.n, card, fig1_model)
    dp_total = fit_data_parallel(args.seed, card, fig1_model)
    lm_total, lm_records = lm_serving(args.seed, card,
                                      profile_dir=args.profile)
    ops_records["flash_attention"] = lm_records["flash_attention"]
    for k in total:
        total[k] += (ivf_total[k] + enc_total[k] + ops_total[k]
                     + train_total[k] + front_total[k]
                     + shard_total.get(k, 0) + dp_total[k] + lm_total[k])
    records.update(ivf_records)
    records.update(ops_records)
    for k, rec in records.items():
        check(total[k] > 0, f"{k} was never launched on the main path")
        rec["launches"] = total[k]
    busy = [(name, st) for name, st in ENGINES
            if st["retries"] or st["failovers"]]
    log(f"{len(ENGINES)} engines served with max_retries=0 (all but the "
        f"fault check's): retries and failovers "
        + ("0 in every one" if not busy else f"in {busy}"))
    check(not busy, f"engines retried or failed over: {busy}")

    log(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s (host "
        "clock, the kernels' build included)")
    log(json.dumps({"kernels": [records[k] for k in (
        "crude_topk", "refine_topk", "ivf_crude_topk", "ivf_refine_topk",
        "kmeans_assign", "icm_encode", "adc", "two_step",
        "flash_attention")] + [lm_records["flash_attention_mla"]]}))
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
