#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds the hand-written kernels
from this checkout, holds each against its plain PyTorch version on the
card, then builds and serves the flat, two-step and IVF indexes at
SIFT1M geometry through the port's own entry points (``build_index``,
``load_ann_engine``), trains, and serves two dense LMs, a MoE LM, an
MLA + MoE LM, an SSM, a hybrid, an encoder-decoder and a VLM at full
width (``serve_lm``), trains a dense LM at full width through the
``launch.train --arch`` command and its resume, runs MLA's block-wise
attention at a 32k prompt, the sharded train step, the cross-pod combine
programs and a reshard, and checks what comes out.

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
   sq != sk, MHA, GQA and MQA, dh in {32, 64, 128, 256}, and the
   sliding window (``FLASH_WINDOW_MODES``: 1 key to wider than the
   prompt, inside, on and across key tiles), and the key-padding bound
   (``FLASH_KV_VALID_MODES``: 1 key, a key tile's edge and one past it,
   inside a tile, whisper's padded cross attention, MQA, (192, 128)),
   which the wrapper refuses with causal or a window; each line names
   the body that ran, ``mma.sync`` bf16 or 3xTF32 f32, with its registers
   and local-memory bytes), and in every one of these modes and both
   types the backward kernels (dQ, then dK / dV: ``mma.sync`` bf16, or
   ``mma.sync`` 3xTF32 in f32; each line names both kernels' bodies with
   their registers and local-memory bytes) against the plain backward
   from the same forward output, log-sum-exp and output gradient (2e-5 /
   2e-2 of each gradient's largest magnitude), two launches equal bit
   for bit, the forward with its log-sum-exp equal to the forward
   without it bit for bit; then the ops
   once each at full width, counts reset before and read after: ADC and
   two-step at SIFT1M geometry (1M uint8 rows, one query's LUT, 2 fast
   codebooks, the threshold at the crude 0.3% quantile), flash attention
   at tinyllama-1.1b's (f32 and bf16) and llama3-405b's (bf16) attention
   widths at s = 4096, causal; and their times beside their bounds (f32
   flash at 3xTF32's 165 TFLOP/s, its body's rate, the FMA-rate bound in
   the log line), their plain versions and a one-call library yardstick
   (``embedding_bag``, ``scaled_dot_product_attention``); and the
   backward kernels at the train cell's attention (8 x 2048, 32 / 4
   heads of 64, causal) in f32 and in bf16, and in bf16 at cell B's (1 x
   2048, 16 heads of 256), cell H's (4 x 1024, 64 / 8 heads of 128) and
   cell D's (1 x 2048, 128 heads of (192, 128)): each kernel's time with
   its registers and local-memory bytes, the pair's, the plain
   backward's and SDPA's backward beside their bounds (5 products
   against the forward's 2; in f32 at the FMA rate and at 3xTF32's 165
   TFLOP/s), and the forward with
   and without its log-sum-exp (at the train cell's shape in f32 also
   beside its bounds and SDPA's f32 forward: the kernels line's record
   ``flash_attention (train A f32)``);
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
   port's ``init`` from a generator on the card, eight cells served one
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
   batch 1, a 2048-token prompt (past ``attn_chunk``: MLA's block-wise
   attention, 2 blocks, the flash kernel's (192, 128) instance 3 times a
   layer), 16 steps; cell E, mamba2-1.3b in bf16 at full depth (48 SSD layers,
   no attention), batch 8, a 2048-token prompt (16 SSD chunks of 128),
   32 steps; cell F, recurrentgemma-9b in bf16 at full depth (12 groups
   of (rglru, rglru, local) and two rglru layers; MQA 16 / 1 heads of
   256, window 2048), batch 1, a 4096-token prompt (the band masks, the
   local ring of 2048 slots wraps), 16 steps; cell G, whisper-large-v3
   in bf16 at full depth (32 encoder and 32 decoder layers), batch 8,
   1500 seeded audio frames a row and a 64-token prompt, 32 steps;
   cell H, internvl2-76b in bf16, its depth cut to 32 of 80 layers
   (29.5 B parameters), batch 4, 256 seeded patch tokens and 768 text
   tokens, 16 steps.  Each prints prefill ms,
   decode ms a step, tokens/s and peak MiB (CUDA events) beside the
   card's name and power limit.
   Gates: (1) each arch's model on the card against the CPU from the
   same weights in f32 at batch 1, a 64-token prompt and 4 steps
   (tinyllama at full depth, the MoE archs at depth 2: the first dense
   layer and one MoE layer; mamba2 at depth 2; recurrentgemma at depth
   4, one group and a tail layer, at its window and again at a window
   of 32, which masks and wraps at 64 tokens; whisper at 2 + 2 layers
   over the 1500 frames, its cross caches too; internvl at depth 2 with
   its 256 patch tokens before the 64), logits within 2e-4 of
   the largest
   (``LM_TOL``), greedy tokens equal wherever the CPU's top-2 gap
   exceeds that; (2) at every attention cell, the flash kernel on the
   operands of each distinct call of a served prefill (captured by
   wrapping ``ops.flash_attention``: one call a cell, G's three:
   encoder, decoder self and cross attention) against its plain version
   (phase 7's tolerance), timed beside its bound and SDPA (or SDPA's
   refusal), and the f32 (192, 128) body at a small MLA shape; at cell
   F the windowed kernel in bf16 and in f32, its bound counting the
   band only, SDPA with the band as a boolean mask; and G's cross call on the unpadded keys against the reference's padded form
   with ``kv_valid`` (1024 queries, 2048 keys, 1500 valid), its first
   64 rows bit for bit; (3) cell C's and cell E's two prefills from
   the same inputs, and two decode steps from those caches, bit for bit
   equal (logits and caches); (4) cell C's layer 1 dispatch at 512
   tokens with capacity_factor = E (no drops) against the every-expert
   oracle within 2^-5 of the largest output; (5) at cell A's head
   geometry ICQ-KV attention at top_c = S equal to exact attention over
   the dequantized cache; (6) launch counts reset before and read after
   each cell: exactly one flash launch an attention layer a prefill,
   an MLA layer past ``attn_chunk`` one a (query block, key block <= it)
   pair (22, 28, 48, 6 x 3 = 18, none at cell E, the 12 local layers at
   cell F, 96 at cell G: 32 encoder, 32 self and 32 cross, 32 at cell H;
   the untimed warm prefill doubles the window's count) and none in the
   decode steps.  TF32 must be off; the phase logs
   ``torch.get_float32_matmul_precision()``.  The kernels' record of
   flash attention is cell B's served prefill shape, with the launches
   of the whole run; two more, ``flash_attention (192, 128, causal
   block)`` and ``(192, 128, non-causal block)``, are cell D's diagonal
   and earlier block calls, each with its own launches, a fourth,
   ``flash_attention (window 2048)``, cell F's, with cell F's, and two
   more, ``(non-causal, encoder)`` and ``(non-causal, cross)``, cell
   G's, with cell G's.

15. LM training (``launch.train --arch``, run last): tinyllama-1.1b's
   loss and every gradient at depth 2, batch 1, 64 tokens, f32, on the
   card against the CPU from the same weights (loss to 1e-5, each leaf
   within 2e-4 of its largest; 4 flash forward launches and 2 of each
   backward kernel); then cell "LM train A": tinyllama-1.1b at full width
   and depth in f32 (remat, 2 microbatches of 8 x 2048 a step, AdamW)
   through the command's ``main`` in process, ``--seq-len 2048
   --global-batch 16 --steps 4 --save-every 2``, two more steps from its
   final state in memory (the uninterrupted run, launches counted over
   one step: 88 flash forwards, 44 of each backward kernel), and
   ``--resume --steps 6`` from its checkpoint, whose two losses must
   equal the uninterrupted run's bit for bit; every loss finite; losses,
   dt a step, peak MiB.

16. MLA at length and LM sharding (run last, ~70 s): (a) one
   ``mla_dense`` layer's attention at DeepSeek-V2's full width (128
   heads, (192, 128)) in bf16 at ``prefill_32k``'s 32768 tokens, batch
   1: ``mla_blockwise_attention`` (32 blocks, 528 flash launches with the
   rows' log-sum-exp, merged in f32) against the materialized path (K and
   V of the whole sequence, one launch) from the same weights, within
   2e-2 of the largest output; each call's peak allocation above its
   inputs and output, the block-wise one within two blocks' working set;
   both timed (CUDA events); the same in f32 at 4096 tokens within 2e-5;
   (b) tinyllama-1.1b at full width, depth 2, f32, a global batch of 8 x
   512 through ``build_train_step`` over ``make_mesh_auto((2, 2, 1),
   ("pod", "data", "model"))`` on the first card, the plain and the
   ``icq_grad`` step, each against the unsharded step on the card and the
   same sharded step on the CPU from the same state, held on what
   carries the gradient (a first AdamW step moves a param by less than
   its 3e-7 learning rate whatever the gradient): the loss to 1e-5;
   plain, the pre-clip norm, params and both moments within 2e-4 of
   their largest; icq_grad, the gradient read back from the moments
   within one int8 step of each leaf's largest pod gradient, the norm
   within the norm of half steps, the error-feedback residuals equal to
   the plain gradient less the compressed one and within half a step,
   params within twice the learning rate; with 4 shards' flash
   launches; (b') FSDP (``distributed.fsdp``): each of the two steps
   again from params laid out by the full rule-table specs (plain: FSDP
   over (pod, data), 4 ways; icq_grad: over data), against the step
   above on the card: the loss to 1e-5 (bit for bit printed), params,
   m, v and the norm within 2e-4 of their largest, icq_grad's gradient
   and residuals within a rounding flip, each position's bytes of
   params, m and v at ``shard_bytes`` of the full specs, the flash
   launches equal, a second step keeping the layout, the peak MiB above
   the state no higher, both steps' seconds; (c) the fp32
   and int8 combine programs (``launch.combine``) over 2 pods of
   tinyllama's full parameter vector: ms, wire bytes a device, the int8
   mean equal to the plain formula bit for bit; (d) ``reshard_state`` of
   tinyllama's full params from (data 4) to (data 2, model 2) and back,
   bit for bit, with its peak MiB.
17. tensor parallelism (run last, all on the first card): the layers
   split over the mesh's ``model`` axis (``distributed.tensor_parallel``,
   each shard's heads, ``d_ff`` columns and experts, the flash kernel
   once a shard): (a) tinyllama-1.1b at full width, depth 2, f32, a
   global batch of 8 x 512 in one microbatch through ``build_train_step``
   over (pod 1, data 2, model 2), against the unsharded step on the card
   and the same split step on the CPU from the same state at phase 16
   (b)'s gates, each shard's parameter bytes beside ``shard_bytes`` of
   the model-only specs, the flash launches (4 shards a layer); (a'')
   its FSDP cell (over data beside the split over model) against it at
   (b')'s gates; (b)
   tinyllama-1.1b at full width and depth, f32, batch 8, a 512-token
   prompt and 8 greedy steps over (model 2) against the unsharded served
   path (phase 14's gate and near-tie rule), prefill ms, ms a step and
   peak MiB of both; (c) deepseek-v2-236b at full width, depth 60 -> 2,
   bf16, 1 x 2048 (past attn_chunk: each shard's 64 heads by the
   block-wise path), 8 steps over (model 2), its latent cache split by
   sequence, 80 experts a shard; (d) llama3-405b at full width, depth
   126 -> 1, bf16, 1 x 2048, 4 steps over (model 16): 8 query heads a
   shard, half a KV head's columns of wk / wv (all-gathered), the cache
   split by sequence; (c) and (d) at phase 14's bf16 gate; (a') the
   split train step of recurrentgemma-9b at full width, depth 38 -> 3
   (rglru, rglru, local), f32, 2 x 4096 over (pod 1, data 2, model 2) at
   (a)'s gates against the unsharded step (the windowed flash forward
   and both backward kernels on each shard; no CPU twin: ~300 s on the
   CPU); at full width and depth in bf16 over (model 2), each against
   the unsharded served path at phase 14's bf16 gate: (e) mamba2-1.3b
   8 x 2048, 16 steps (the SSM's segment layout, B / C all-gathered;
   held in f32 at LM_TOL and its bf16 drift from f32 against the
   unsplit path's; (e') the same at 1 layer at the bf16 gate); (f)
   recurrentgemma-9b 1 x 4096, 16 steps (the ring split by sequence and
   wrapped); (g) whisper-large-v3 8 x (1500 frames + 64), 16 steps
   (encoder, self and cross attention by heads, the cross cache by
   heads); every cell's shard holding ``shard_bytes`` of its params;
   (h) ICQ-KV's decode of phase 14's cell A (f32, 8 x 512, d_fast 16,
   top_c 128, 32 steps) over (model 2) by KV heads and (model 8) by
   positions, and over (model 8) at a 2048-token prompt (257 positions
   a shard, past top_c), against the unsplit ICQ-KV step: logits
   within LM_TOL, greedy tokens and the global survivors equal outside
   near ties; each split set the top-c of the split step's own recorded
   crude scores bit for bit, and both paths' scores within a score's
   rounding of each other.
18. (run after phase 13, on phase 4's and 5's artifacts) ``filter=`` and
   ``refine_cap`` on the card, served by the scan kernels at
   ``serve.backend = "jnp"``: (a) the crude kernel's row-predicate
   instance (f32, int8, int8 4-bit) under four filters drawn from
   ``--seed`` (Bernoulli 0.5 and 0.01, the rows [0, 50 000), 60 rows:
   fewer than topk), the survivor selection at caps 400, 1000 and topk
   and the re-rank of the survivors, each against its plain version bit
   for bit and timed (64 queries x 1M points) beside the unfiltered
   crude; (b) the two-step f32 / int8 / int8-4bit, flat f32, ivf-f32
   and ivf-int8 engines loaded with ``{"serve.backend": "jnp"}``, one
   64-query tile unfiltered and under each filter, launch counts reset
   before and read after: ids, distances (so the +inf slots) and
   pass_rate equal to the plain composition on the same operands bit
   for bit, no filtered row returned, recall@100 against
   ``eval.ground_truth(filter=)`` over the decoded points, ms filtered
   beside unfiltered; (c) on two-step f32 and ivf-f32, the rungs with
   the capped rung, the crude rung filtered, the capped rung at
   refine_cap 400 and 1000 (about 2,800 survivors a query at sigma 10:
   the cap bites) through ``SearchBudget(refine_cap=)`` and through
   ``index.refine_cap``, also filtered, each equal to the plain
   composition, the pipelined executor (tiles of 64, two streams)
   filtered and capped against the tiled engine, and the artifact at
   auto refusing ``filter`` (engine and
   index) and ``refine_cap`` with the reference's words, with no capped
   rung; (d) the same two artifacts over a 4-way mesh on the first card
   at auto, filtered, equal bit for bit to the unsharded jnp engine.

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
phase 14 one prefill and 4 decode steps of each LM cell (with the
SSM's and the RG-LRU's pieces as ranges), phase 17 the same of each
split serving cell and of its unsplit path.

The line before the last is the kernels' JSON record (the nine
kernels with phase 18's predicate crude, survivor selection and re-rank
after the four search kernels, then the flash kernel's (192, 128), windowed and non-causal
instances, then the two backward kernels at the train cell's shape; the
launches are the whole run's, phases 15 to 17 included);
the last line is
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
# what 3xTF32 (three TF32 tensor-core products per f32 product) leaves of
# the dense TF32 rate, 495e12: the f32 flash backward's body
TF32X3_OPS_PER_S = 495e12 / 3

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
                    # mask: 0 none, 1 the slab's ids, 2 a row filter;
                    # select: the refine_cap survivor selection
                    names = (("quant", "nibble", "mask")
                             if k.group(1) == "crude"
                             else ("nibble", "stages", "select"))
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
# the sliding band (recurrentgemma's local layers): b, sq, sk, H, KVH,
# dqk, dv, causal, window: the diagonal alone, a band inside one tile,
# exactly a tile, across tiles at dh 256 (32-key tiles in bf16) with
# MQA, wider than the prompt, sq < sk, non-causal (keys right of the
# query kept), MLA's widths
FLASH_WINDOW_MODES = (
    (1, 300, 300, 4, 1, 32, 32, True, 1),
    (1, 1000, 1000, 4, 2, 64, 64, True, 100),
    (2, 256, 256, 8, 8, 128, 128, True, 64),
    (1, 777, 777, 16, 1, 256, 256, True, 70),
    (1, 200, 500, 4, 4, 128, 128, True, 5000),
    (1, 333, 1111, 4, 2, 64, 64, True, 300),
    (1, 300, 500, 4, 4, 32, 32, False, 50),
    (1, 1000, 1000, 8, 8, 192, 128, True, 333),
)
# the key-padding bound (the reference's padded cross attention), non-
# causal: b, sq, sk, H, KVH, dqk, dv, kv_valid: one key, a key tile's
# edge (64) and one key past it, inside a tile, whisper-large-v3's padded
# cross attention (q 1024, k / v 2048, 1500 frames valid), MQA, MLA's
# widths
FLASH_KV_VALID_MODES = (
    (1, 100, 256, 4, 4, 64, 64, 1),
    (1, 100, 256, 4, 2, 64, 64, 64),
    (1, 100, 256, 4, 2, 64, 64, 65),
    (2, 77, 300, 4, 4, 32, 32, 150),
    (1, 1024, 2048, 20, 20, 64, 64, 1500),
    (2, 64, 200, 4, 1, 128, 128, 100),
    (1, 130, 257, 4, 2, 192, 128, 200),
)


# the query offset (query row i at position i + q_offset): b, sq, sk, H,
# KVH, dqk, dv, causal, window, q_offset: the triangular scan's sk - sq, a
# positive offset inside the keys, a negative one (the first rows see no
# key), a window with sq > sk, a window with a negative offset, a
# non-causal band whose last rows lie past the last key's band; the same
# kinds at MLA's widths; every length ragged against the tiles
FLASH_OFFSET_MODES = (
    (1, 333, 1111, 4, 2, 64, 64, True, 0, 778),
    (1, 200, 300, 4, 1, 64, 64, True, 0, 37),
    (2, 300, 130, 4, 4, 64, 64, True, 0, -70),
    (1, 500, 257, 4, 2, 64, 64, True, 100, 45),
    (1, 257, 500, 4, 4, 64, 64, True, 70, -33),
    (1, 300, 300, 4, 2, 64, 64, False, 50, 120),
    (1, 130, 1000, 8, 8, 192, 128, True, 0, 870),
    (1, 333, 200, 4, 2, 192, 128, True, 0, -45),
    (1, 400, 300, 4, 4, 192, 128, True, 64, 29),
    (1, 200, 333, 4, 1, 192, 128, True, 90, -61),
)
# the mask operand (random, 70% kept, rows 5 and sq - 1 fully masked):
# b, sq, sk, H, KVH, dqk, dv, causal, window, q_offset, its shape: "qk"
# one (sq, sk) mask for every batch row and head (stride 0 over both),
# "heads" one a (batch, head), whose fully masked rows are head 1's only
MASK_KEEP = 0.7
FLASH_MASK_MODES = (
    (2, 130, 200, 4, 2, 64, 64, False, 0, 0, "qk"),
    (1, 257, 257, 4, 4, 64, 64, True, 0, 0, "heads"),
    (1, 300, 500, 4, 1, 64, 64, True, 80, 200, "qk"),
    (1, 200, 130, 4, 4, 192, 128, False, 0, 0, "qk"),
    (2, 129, 300, 4, 2, 192, 128, True, 0, 171, "heads"),
)


def flash_tolerance(dtype) -> float:
    import torch
    return 2e-5 if dtype == torch.float32 else 2e-2


def flash_body(dtype, dh, dv=None, kernel="forward", general=False) -> str:
    """The flash body that runs for ``dtype`` at (``dh``, ``dv``; ``dv``
    defaults to ``dh``), the forward's or a backward kernel's, its
    general instance (a query offset, a mask) under ``general``: its
    path, and its registers and local-memory (spill) bytes per thread."""
    from repro_torch.kernels import flash_attention as fa
    a = fa.kernel_attributes(dtype, dh, dv, kernel, general)
    return (f"{a['path']}, {a['registers']} registers, "
            f"{a['local_bytes']} B local per thread")


def random_mask(seed, kind, b, H, sq, sk):
    """``FLASH_MASK_MODES``' mask on the card: (sq, sk) for "qk", (b, H,
    sq, sk) for "heads", ``MASK_KEEP`` of the pairs kept, rows 5 and sq -
    1 fully masked (in head 1 only for "heads")."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (sq, sk) if kind == "qk" else (b, H, sq, sk)
    m = torch.rand(shape, generator=g, device="cuda") < MASK_KEEP
    if kind == "qk":
        m[[5, sq - 1]] = False
    else:
        m[:, 1, [5, sq - 1]] = False
    return m


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
    modes = (tuple(m + (0, 0) for m in FLASH_MODES)
             + tuple(m + (0,) for m in FLASH_WINDOW_MODES)
             + tuple(m[:7] + (False, 0, m[7]) for m in FLASH_KV_VALID_MODES))
    for mode in modes:
        b, sq, sk, H, KVH, dh, dv, causal, window, kv_valid = mode
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attention_operands(seed + sq + dh + window + kv_valid,
                                         b, sq, sk, H, KVH, dh, dtype, dv)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, kv_valid=kv_valid)
            want = fa.flash_attention_torch(q, k, v, causal=causal,
                                            window=window, kv_valid=kv_valid)
            torch.cuda.synchronize()
            tol = flash_tolerance(dtype)
            err = float((got.float() - want.float()).abs().max())
            ok = (got.dtype == dtype and got.shape == want.shape
                  and bool(torch.isclose(got.float(), want.float(), rtol=tol,
                                         atol=tol).all()))
            log(f"mode flash_attention b={b} sq={sq} sk={sk} H={H} KVH={KVH}"
                f" dh={dh} dv={dv} causal={causal} window={window} "
                f"kv_valid={kv_valid} "
                f"{str(dtype).split('.')[-1]} ({flash_body(dtype, dh, dv)}):"
                f" max_abs_err {err} (tolerance "
                f"{tol}): {'within' if ok else 'OUTSIDE'}")
            check(ok, f"flash_attention kernel != plain version {mode} "
                      f"{dtype}: max_abs_err {err}")
            check_flash_backward(seed, f"b={b} sq={sq} sk={sk} H={H} "
                                 f"KVH={KVH} dh={dh} dv={dv}", dtype, q, k,
                                 v, got, dict(causal=causal, window=window,
                                              kv_valid=kv_valid))
    check_offsets_and_masks(seed)
    # kv_valid only in a non-causal call with no window (a row could keep
    # no key); the wrapper refuses the others before any launch
    q, k, v = attention_operands(seed, 1, 64, 64, 2, 2, 64, torch.float32)
    refused = []
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        try:
            fa.flash_attention_cuda(q, k, v, kv_valid=32, **kw)
        except ValueError:
            refused.append(kw)
    log(f"mode flash_attention kv_valid with causal / with a window: "
        f"{'refused' if len(refused) == 2 else 'SERVED'} (ValueError)")
    check(len(refused) == 2, "kv_valid with causal or a window was served")
    log(f"phase 7 check launches: {read_launches()}")


def check_flash_backward(seed, shape, dtype, q, k, v, out, masks):
    """Phase 7 (a), the backward in one mode (``shape`` its label,
    ``masks`` the flash call's mask arguments): the forward with its
    log-sum-exp equal to the forward without it (``out``) bit for bit;
    dq, dk, dv of the backward kernels each within phase 7's tolerance
    of its own largest magnitude in the plain backward, from the same
    forward output, log-sum-exp and output gradient; two launches bit
    for bit.  A plain gradient whose largest magnitude is below the
    tolerance times the whole gradient's (over dq, dk and dv) is
    rounding noise, and is held to the whole gradient's scale, named in
    the log: at window 1 or one valid key a row sees one key, P = 1 and
    dS = dP - D cancels exactly, so dq and dk are ~1e-7 against dv's
    ~1 on both sides."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dh = q.shape[-1]
    g = torch.Generator(device="cuda").manual_seed(seed + 7 * q.shape[1] + dh)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **masks)
    o2, lse2 = fa.flash_attention_cuda(q, k, v, with_lse=True, **masks)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **masks)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **masks)
    want = fa.flash_attention_bwd_torch(q, k, v, o, do, lse, **masks)
    torch.cuda.synchronize()
    tol = flash_tolerance(dtype)
    same_fwd = torch.equal(o, out)
    twice = (all(torch.equal(x, y) for x, y in zip(got, again))
             and torch.equal(o2, o) and torch.equal(lse2, lse))
    rel, noise = tolerance_ratios(got, want, tol)
    ok = (same_fwd and twice and max(rel) <= 1.0
          and all(x.dtype == dtype for x in got))
    noted = (f"; rounding noise, at the whole gradient's scale: "
             f"{', '.join(('dq', 'dk', 'dv')[i] for i in noise)}"
             if noise else "")
    dv = v.shape[-1]
    masked = masks.get("mask") is not None
    general = fa.general_instance(q.shape[1], k.shape[1],
                                  masks.get("window", 0),
                                  masks.get("q_offset", 0), masks.get("mask"))
    named = ", ".join(f"{key}={val}" for key, val in masks.items()
                      if key != "mask")
    log(f"mode flash_attention backward {shape} {named}"
        f"{', masked' if masked else ''} {str(dtype).split('.')[-1]} "
        f"({flash_body(dtype, dh, dv, 'dq', general)}; "
        f"{flash_body(dtype, dh, dv, 'dkdv', general)}): dq / dk / dv "
        f"max_abs_err over tolerance {rel[0]:.3f} / {rel[1]:.3f} / "
        f"{rel[2]:.3f} ({tol} of each one's largest magnitude{noted}); "
        f"two launches of the forward (output, log-sum-exp) and of the "
        f"backward {'equal' if twice else 'DIFFERENT'}; forward with the "
        f"log-sum-exp {'equal' if same_fwd else 'DIFFERENT'}: "
        f"{'within' if ok else 'OUTSIDE'}")
    check(ok, f"flash_attention backward {shape} {named} {dtype}: errors "
              f"over tolerance {rel}, twice equal {twice}, forward equal "
              f"{same_fwd}")


def check_offsets_and_masks(seed: int):
    """Phase 7 (a), the query offset and the mask operand: every mode of
    ``FLASH_OFFSET_MODES`` and ``FLASH_MASK_MODES`` in both types, the
    forward against the plain version (phase 7's tolerance; the rows
    that see no key included: the mean of V, log-sum-exp NEG_INF) and
    the backward through ``check_flash_backward``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    modes = ([m + (None,) for m in FLASH_OFFSET_MODES]
             + list(FLASH_MASK_MODES))
    for b, sq, sk, H, KVH, dh, dv, causal, window, q_offset, kind in modes:
        for dtype in (torch.float32, torch.bfloat16):
            seed_m = seed + sq + 3 * sk + dh + window + q_offset
            q, k, v = attention_operands(seed_m, b, sq, sk, H, KVH, dh,
                                         dtype, dv)
            mask = (random_mask(seed_m, kind, b, H, sq, sk) if kind
                    else None)
            masks = dict(causal=causal, window=window, q_offset=q_offset,
                         mask=mask)
            got, lse = fa.flash_attention_cuda(q, k, v, with_lse=True,
                                               **masks)
            want, wlse = fa.flash_attention_torch(q, k, v, with_lse=True,
                                                  **masks)
            torch.cuda.synchronize()
            tol = flash_tolerance(dtype)
            err = float((got.float() - want.float()).abs().max())
            empty = wlse < fa.NEG_INF / 2
            n_empty = int(empty.sum())
            ok = (got.dtype == dtype and bool(torch.isclose(
                got.float(), want.float(), rtol=tol, atol=tol).all())
                and torch.equal(lse < fa.NEG_INF / 2, empty))
            label = (f"b={b} sq={sq} sk={sk} H={H} KVH={KVH} dh={dh} "
                     f"dv={dv}")
            general = fa.general_instance(sq, sk, window, q_offset, mask)
            log(f"mode flash_attention {label} causal={causal} "
                f"window={window} q_offset={q_offset}"
                + (f" mask {kind} ({float(mask.float().mean()):.3f} kept)"
                   if kind else "")
                + f" {str(dtype).split('.')[-1]} "
                f"({flash_body(dtype, dh, dv, general=general)}): "
                f"max_abs_err {err} (tolerance {tol}), {n_empty} "
                f"(batch, head, row)s with no key, equal on both sides: "
                f"{'within' if ok else 'OUTSIDE'}")
            check(ok, f"flash_attention kernel != plain version {label} "
                      f"q_offset={q_offset} mask={kind} {dtype}: "
                      f"max_abs_err {err}")
            check_flash_backward(seed, label, dtype, q, k, v, got, masks)


def attention_work(b, sq, sk, H, KVH, dh, causal, itemsize, dv=None,
                   window=0):
    """(bytes, operations) of one attention call: q (width dh), k (dh),
    v (dv, default dh) read and out (dv) written once; per visible
    (query, key) pair 2 dh operations of Q . K^T and 2 dv of P . V,
    counting only the causal part, and under ``window`` only the band
    (keys i - window < j)."""
    dv = dv or dh
    pairs = 0
    for i in range(sq):
        last = min(i, sk - 1) if causal else sk - 1
        first = max(0, i - window + 1) if window else 0
        pairs += max(0, last - first + 1)
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
        # the body's own rate: bf16 tensor cores, or 3xTF32 (f32; the
        # FMA-rate bound in the log line only)
        b_ms, b_by = bound_ms(nbytes, nops,
                              BF16_OPS_PER_S if dtype == torch.bfloat16
                              else TF32X3_OPS_PER_S)
        fma = ("" if dtype == torch.bfloat16 else
               f", {bound_ms(nbytes, nops)[0]:.4f} ms at the f32 FMA rate")
        log(f"kernel flash_attention {name} b={w['b']} s={w['s']} H={w['H']}"
            f" KVH={w['KVH']} dh={w['dh']} causal "
            f"{str(dtype).split('.')[-1]} ({flash_body(dtype, w['dh'])}): "
            f"{ms:.4f} ms "
            f"({nops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}){fma}, library "
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


# phase 7 (e): the query offset and the mask operand at full width,
# through the attention layer's entry points on the card, under autograd
# (forward, then both backward kernels): tinyllama-1.1b's attention (32 /
# 4 heads of 64) in bf16 (scale_config's type).  OFFSET_CALL: a prompt's
# last prefill chunk, chunked_attention(q_offset=3072) of 1024 queries over
# its 4096 keys (a 4096-token prompt prefilled 1024 tokens at a time);
# MASK_CALL: full_attention(causal, mask=) over 4096 tokens packed from 4
# documents of 1024, each token seeing only its own document (the
# block-diagonal (4096, 4096) mask of packed-sequence training)
OFFSET_CALL = dict(b=1, sq=1024, sk=4096, H=32, KVH=4, dh=64, q_offset=3072)
MASK_CALL = dict(b=1, s=4096, H=32, KVH=4, dh=64, docs=4)
BWD_REPLACES = ("src/repro/kernels/flash_attention.py:71 (no Pallas "
                "backward; the gradient of src/repro/models/attention.py:62)")


def tolerance_ratios(got, want, tol) -> tuple:
    """Phase 7's gradient rule: each of ``got``'s max errors against
    ``want`` over ``tol`` times that gradient's largest magnitude, or the
    whole set's where its own is below ``tol`` of it (rounding noise).
    Returns (ratios, the indices held at the whole scale)."""
    peaks = [float(w.float().abs().max()) for w in want]
    whole = max(1e-30, max(peaks))
    noise = [i for i, p in enumerate(peaks) if p < tol * whole]
    bounds = [tol * (whole if i in noise else p) for i, p in enumerate(peaks)]
    return ([float((x.float() - w.float()).abs().max()) / bd
             for x, w, bd in zip(got, want, bounds)], noise)


def offset_mask_calls(seed: int, card: str):
    """Phase 7 (e): ``OFFSET_CALL`` and ``MASK_CALL`` through
    ``models.attention`` under autograd, launch counts reset before and
    read after around each call (one forward and one of each backward
    kernel; its records carry that call's counts, the backward pair's
    the sum of dq's and dkdv's);
    output and gradients against the plain versions (phase 7's
    tolerance); then each call's forward and backward pair timed beside
    the plain versions, the bound (the pairs its masks keep) and SDPA
    with the same boolean ``attn_mask``.  Returns (the launches, four
    records)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    dt = torch.bfloat16
    o_, m_ = OFFSET_CALL, MASK_CALL
    qkv_o = attention_operands(seed + 710, o_["b"], o_["sq"], o_["sk"],
                               o_["H"], o_["KVH"], o_["dh"], dt)
    qkv_m = attention_operands(seed + 711, m_["b"], m_["s"], m_["s"],
                               m_["H"], m_["KVH"], m_["dh"], dt)
    doc = torch.arange(m_["s"], device="cuda") // (m_["s"] // m_["docs"])
    docs = doc[:, None] == doc[None, :]
    calls = {
        "q_offset": (qkv_o, dict(causal=True, q_offset=o_["q_offset"]),
                     lambda q, k, v: attn.chunked_attention(
                         q, k, v, causal=True, chunk=1024,
                         q_offset=o_["q_offset"])),
        "mask": (qkv_m, dict(causal=True, mask=docs),
                 lambda q, k, v: attn.full_attention(q, k, v, causal=True,
                                                     mask=docs)),
    }
    g = torch.Generator(device="cuda").manual_seed(seed + 712)
    grads_in = {name: torch.randn(qkv[0].shape, generator=g,
                                  device="cuda").to(dt)
                for name, (qkv, _, _) in calls.items()}
    torch.cuda.synchronize()
    outs, counts, launches = {}, {}, None
    for name, (qkv, _, entry) in calls.items():
        leaves = [t.detach().requires_grad_() for t in qkv]
        reset_launches()
        out = entry(*leaves)
        out.backward(grads_in[name])
        torch.cuda.synchronize()
        counts[name] = read_launches()
        outs[name] = (out.detach(), [t.grad for t in leaves])
        want = {k: 0 for k in counts[name]}
        want.update(flash_attention=1, flash_attention_bwd_dq=1,
                    flash_attention_bwd_dkdv=1)
        log(f"phase 7 (e) {name} call under autograd: launches "
            f"{counts[name]}")
        check(counts[name] == want, f"{name} call launches {counts[name]} "
                                    f"!= {want}")
        launches = {k: (launches or {}).get(k, 0) + n
                    for k, n in counts[name].items()}
    records = {}
    tol = flash_tolerance(dt)
    for name, (qkv, masks, _) in calls.items():
        q, k, v = qkv
        do = grads_in[name]
        out, grads = outs[name]
        wo, wlse = fa.flash_attention_torch(q, k, v, with_lse=True, **masks)
        _, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **masks)
        wg = fa.flash_attention_bwd_torch(q, k, v, out, do, lse, **masks)
        torch.cuda.synchronize()
        err = float((out.float() - wo.float()).abs().max())
        ratios, _ = tolerance_ratios(grads, wg, tol)
        check(bool(torch.isclose(out.float(), wo.float(), rtol=tol,
                                 atol=tol).all()) and max(ratios) <= 1.0,
              f"{name} call != plain version: max_abs_err {err}, gradient "
              f"ratios {ratios}")
        g_err = max(float((x.float() - w.float()).abs().max())
                    for x, w in zip(grads, wg))
        del wo, wg
        b, sq, H, dh = q.shape
        sk, KVH = k.shape[1], k.shape[2]
        keep = fa._visible(sq, sk, True, 0, 0, "cuda",
                           masks.get("q_offset", 0))
        if "mask" in masks:
            keep = keep & masks["mask"]
        pairs = int(keep.sum())
        mask_bytes = sq * sk if "mask" in masks else 0
        item = q.element_size()
        q_rows, kv_rows, stats = b * sq * H, b * sk * KVH, 4 * b * H * sq
        f_ms, f_by = bound_ms(item * (q_rows + kv_rows) * 2 * dh
                              + mask_bytes, 2 * b * H * pairs * 2 * dh,
                              BF16_OPS_PER_S)
        b_ms_, b_by = bound_ms(item * (q_rows * 4 * dh + 2 * kv_rows * 2 * dh)
                               + stats + mask_bytes,
                               2 * b * H * pairs * 5 * dh, BF16_OPS_PER_S)
        ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **masks), 10)
        plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v,
                                                            **masks), 1)
        bwd = time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, do,
                                                          lse, **masks), 10)
        plain_bwd = time_ms(lambda: fa.flash_attention_bwd_torch(
            q, k, v, out, do, lse, **masks), 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep, enable_gqa=True), 10)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                 enable_gqa=True)
        dot = do.transpose(1, 2)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), 5)
        del lib_out
        label = (f"q_offset {o_['q_offset']}, {sq} x {sk}" if name ==
                 "q_offset" else f"mask, {m_['docs']} documents of "
                 f"{sq // m_['docs']}")
        log(f"kernel flash_attention ({label}) b={b} H={H} KVH={KVH} dh={dh}"
            f" causal bf16 ({flash_body(dt, dh, general=True)}): "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {f_ms:.4f} ms "
            f"({f_by}; {pairs} kept pairs a head), SDPA with the same "
            f"boolean attn_mask {lib:.4f} ms (kernel / SDPA {ms / lib:.2f});"
            f" backward pair {bwd:.4f} ms, plain {plain_bwd:.4f} ms, bound "
            f"{b_ms_:.4f} ms ({b_by}), SDPA's backward {lib_bwd:.4f} ms "
            f"({bwd / lib_bwd:.2f}); max_abs_err {err}, gradients {g_err} "
            f"(ratios to phase 7's bound {[round(r, 3) for r in ratios]}); "
            f"{card}")
        n = counts[name]
        common = dict(route="cuda")
        records[f"flash_attention ({name})"] = dict(
            common, name=f"flash_attention ({label})",
            launches=n["flash_attention"],
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:71",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=f_ms,
            bound_by=f_by, library_ms=lib)
        records[f"flash_attention_bwd ({name})"] = dict(
            common, name=f"flash_attention_bwd dq + dkdv ({label})",
            launches=(n["flash_attention_bwd_dq"]
                      + n["flash_attention_bwd_dkdv"]),
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces=BWD_REPLACES, max_abs_err=g_err, ms=bwd,
            plain_ms=plain_bwd, bound_ms=b_ms_, bound_by=b_by,
            library_ms=lib_bwd)
    return launches, records


# the backward's timed shapes: the train cell's attention (phase 15:
# tinyllama-1.1b, f32, 8 x 2048, 32 / 4 heads of 64, causal), the same in
# bf16 (scale_config's type), and the attention of cells B (gemma-7b, 1 x
# 2048, 16 heads of 256), H (internvl2-76b, 4 x 1024, 64 / 8 heads of 128)
# and D (deepseek-v2, 1 x 2048, 128 heads of (192, 128)) in bf16; the
# records keep the first
FLASH_BWD_SHAPES = (
    ("train A", dict(b=8, s=2048, H=32, KVH=4, dh=64, dv=64), "float32"),
    ("train A bf16", dict(b=8, s=2048, H=32, KVH=4, dh=64, dv=64),
     "bfloat16"),
    ("cell B", dict(b=1, s=2048, H=16, KVH=16, dh=256, dv=256), "bfloat16"),
    ("cell H", dict(b=4, s=1024, H=64, KVH=8, dh=128, dv=128), "bfloat16"),
    ("cell D", dict(b=1, s=2048, H=128, KVH=128, dh=192, dv=128),
     "bfloat16"),
)


def attention_bwd_work(b, sq, sk, H, KVH, dh, dv, causal, itemsize, part):
    """(bytes, operations) of the backward ``part``: "dq" (S, dP and dQ
    per visible pair; q, k, v, O, dO and LSE read, dQ and D written),
    "dkdv" (S, dP, dV and dK; q, k, v, dO, LSE and D read, dK and dV
    written) or "all" (the 5 products S, dP, dV, dQ, dK; q, k, v, O, dO
    and LSE read, dq, dk and dv written)."""
    _, fwd_ops = attention_work(b, sq, sk, H, KVH, dh, causal, itemsize, dv)
    pair_ops = fwd_ops / (dh + dv)        # 2 b H pairs
    q_rows, kv_rows, stats = b * sq * H, b * sk * KVH, 4 * b * H * sq
    if part == "dq":
        return (itemsize * (q_rows * (2 * dh + 2 * dv) + kv_rows * (dh + dv))
                + 2 * stats, pair_ops * (2 * dh + dv))
    if part == "dkdv":
        return (itemsize * (q_rows * (dh + dv) + 2 * kv_rows * (dh + dv))
                + 2 * stats, pair_ops * (2 * dh + 2 * dv))
    return (itemsize * (q_rows * (2 * dh + 2 * dv) + 2 * kv_rows * (dh + dv))
            + stats, pair_ops * (3 * dh + 2 * dv))


def sdpa_bwd_ms(q, k, v, do):
    """The library yardstick of the backward: ``torch.autograd.grad`` of
    one ``scaled_dot_product_attention`` (causal, ``enable_gqa``) output,
    or (None, its refusal)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        call = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        call()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return time_ms(call, 5), None


def flash_backward_timing(seed: int, card: str):
    """Phase 7 (d): the backward kernels at ``FLASH_BWD_SHAPES``: each
    kernel's time (CUDA events) with its registers and local-memory
    bytes, the whole backward's, the plain backward's and SDPA's
    backward beside their bounds (5 products against the forward's 2; in
    bf16 at the tensor-core peak, in f32 at the FMA rate and at what
    3xTF32 leaves of the TF32 rate); the forward with and without its
    log-sum-exp.  Returns the records of the two kernels and of the
    forward with its log-sum-exp (``flash_attention (train A f32)``: its
    bytes with the log-sum-exp written, the plain forward with it, SDPA's
    f32 forward as the yardstick) at the train cell's shape, each bound
    at the rate of the body that ran (f32: 3xTF32's; the FMA-rate bound
    stays in the log line only)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    records = {}
    for label, w, dt in FLASH_BWD_SHAPES:
        dtype = getattr(torch, dt)
        b, s, H, KVH, dh, dv = (w[x] for x in ("b", "s", "H", "KVH", "dh",
                                               "dv"))
        q, k, v = attention_operands(seed + 900 + dh, b, s, s, H, KVH, dh,
                                     dtype, dv)
        g = torch.Generator(device="cuda").manual_seed(seed + 901)
        do = torch.randn((b, s, H, dv), generator=g, device="cuda").to(dtype)
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
        want = fa.flash_attention_bwd_torch(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        errs = [float((x.float() - y.float()).abs().max())
                for x, y in zip(grads, want)]
        tol = flash_tolerance(dtype)
        for name, x, y, e in zip(("dq", "dk", "dv"), grads, want, errs):
            check(e <= tol * float(y.float().abs().max()),
                  f"flash backward {label} {name}: max_abs_err {e}")
        del want
        outs = tuple(torch.empty_like(x) for x in grads)
        dbuf = torch.empty((b, H, s), dtype=torch.float32, device="cuda")
        ms = {part: time_ms(lambda part=part: fa.flash_attention_bwd_kernel(
            part, q, k, v, o, do, lse, *outs, dbuf), 5)
            for part in fa.BWD_KERNELS}
        ms_all = time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, do, lse), 5)
        fwd_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v), 5)
        fwd_lse_ms = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, with_lse=True), 5)
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_torch(
            q, k, v, o, do, lse), 1)
        lib_ms, refusal = sdpa_bwd_ms(q, k, v, do)
        # the body's own rate first: the records take their bound from it
        rates = ({"bf16 peak": BF16_OPS_PER_S} if dtype == torch.bfloat16
                 else {"3xTF32": TF32X3_OPS_PER_S,
                       "f32 FMA": F32_OPS_PER_S})
        body_rate = next(iter(rates))
        work = {part: attention_bwd_work(b, s, s, H, KVH, dh, dv, True,
                                         q.element_size(), part)
                for part in (*fa.BWD_KERNELS, "all")}
        bounds = {(part, r): bound_ms(*work[part], rate)
                  for part in work for r, rate in rates.items()}

        def bound_text(part):
            return ", ".join(f"{bounds[part, r][0]:.4f} ms at the {r} rate "
                             f"({bounds[part, r][1]})" for r in rates)
        log(f"kernel flash_attention backward {label} b={b} s={s} H={H} "
            f"KVH={KVH} dh={dh} dv={dv} causal {dt}: dq kernel "
            f"{ms['dq']:.4f} ms ({flash_body(dtype, dh, dv, 'dq')}; bound "
            f"{bound_text('dq')}), dkdv kernel {ms['dkdv']:.4f} ms "
            f"({flash_body(dtype, dh, dv, 'dkdv')}; bound "
            f"{bound_text('dkdv')}); the pair {sum(ms.values()):.4f} ms, "
            f"the backward {ms_all:.4f} ms ({work['all'][1] / ms_all / 1e9:.2f}"
            f" TFLOP/s of its 5 products), bound {bound_text('all')}, plain "
            f"{plain_ms:.2f} ms, library "
            + (f"scaled_dot_product_attention backward {lib_ms:.4f} ms "
               f"(backward / SDPA's {ms_all / lib_ms:.2f})" if lib_ms
               else f"SDPA backward refused ({refusal})")
            + f"; forward {fwd_ms:.4f} ms, with its log-sum-exp "
            f"{fwd_lse_ms:.4f} ms; max_abs_err dq / dk / dv {errs}; {card}")
        if label == "train A":
            for part, err in (("dq", errs[0]), ("dkdv", max(errs[1:]))):
                name = f"flash_attention_bwd_{part}"
                records[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/"
                           "flash_attention_bwd.cu",
                    replaces="src/repro/kernels/flash_attention.py:71 (no "
                             "Pallas backward; the gradient of "
                             "src/repro/models/attention.py:62)",
                    max_abs_err=err, ms=ms[part], plain_ms=plain_ms,
                    bound_ms=bounds[part, body_rate][0],
                    bound_by=bounds[part, body_rate][1], library_ms=lib_ms)
        if label == "train A":
            records["flash_attention (train A f32)"] = forward_record(
                label, q, k, v, o, lse, fwd_lse_ms, card)
        del q, k, v, o, do, lse, grads, outs, dbuf
        torch.cuda.empty_cache()
    return records


def forward_record(label, q, k, v, o, lse, ms, card):
    """The f32 forward with its log-sum-exp at one shape of
    ``FLASH_BWD_SHAPES`` (causal): its output and log-sum-exp (``o``,
    ``lse``) against the plain forward's (phase 7's tolerance), ``ms``
    (timed by the caller) beside its bounds at 3xTF32's rate (the
    record's) and at the FMA rate, the plain forward's time and SDPA's
    f32 forward (``library_ms``).  Returns its record."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s, H, dh = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    want, want_lse = fa.flash_attention_torch(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    tol = flash_tolerance(q.dtype)
    err = float((o - want).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    check(bool(torch.isclose(o, want, rtol=tol, atol=tol).all())
          and bool(torch.isclose(lse, want_lse, rtol=tol, atol=tol).all()),
          f"flash forward {label} != plain version: max_abs_err {err}, "
          f"log-sum-exp {lse_err}")
    del want, want_lse
    plain_ms = time_ms(lambda: fa.flash_attention_torch(
        q, k, v, with_lse=True), 1)
    lib_ms, refused = sdpa_ms(q, k, v)
    nbytes, nops = attention_work(b, s, s, H, KVH, dh, True,
                                  q.element_size(), dv)
    nbytes += lse.numel() * lse.element_size()
    b_ms, b_by = bound_ms(nbytes, nops, TF32X3_OPS_PER_S)
    fma_ms = bound_ms(nbytes, nops)[0]
    log(f"kernel flash_attention forward {label} b={b} s={s} H={H} "
        f"KVH={KVH} dh={dh} dv={dv} causal float32 with its log-sum-exp "
        f"({flash_body(q.dtype, dh, dv)}): {ms:.4f} ms "
        f"({nops / ms / 1e9:.2f} TFLOP/s), bound {b_ms:.4f} ms at the "
        f"3xTF32 rate ({b_by}), {fma_ms:.4f} ms at the f32 FMA rate; plain "
        f"{plain_ms:.2f} ms; library "
        + (f"scaled_dot_product_attention f32 {lib_ms:.4f} ms (kernel / "
           f"SDPA {ms / lib_ms:.2f})" if lib_ms is not None
           else f"SDPA refused ({refused})")
        + f"; max_abs_err {err}, log-sum-exp {lse_err}; {card}")
    return dict(name="flash_attention (train A f32)", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:71",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


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
# card K/V materialized and one flash launch a layer); E: mamba2-1.3b
# (arXiv:2405.21060) at full width and depth in bf16, 48 SSD layers (d
# 2048, 64 heads of 64, state 128, chunk 128), batched serving of an
# attention-free LM (16 SSD chunks a prompt, no flash launch); F:
# recurrentgemma-9b (arXiv:2402.19427) at full width and depth in bf16,
# 38 layers = 12 x (rglru, rglru, local) + 2 rglru, MQA 16 / 1 heads of
# 256, window 2048, a prompt of twice the window (the band masks, the
# local ring wraps), the windowed flash kernel in its 12 local layers; G:
# whisper-large-v3 (arXiv:2212.04356) at full width and depth in bf16,
# 32 encoder and 32 decoder layers (d 1280, 20 heads of 64, d_ff 5120,
# LayerNorm, GELU, learned positions, vocab 51866), batch 8, 1500 audio
# frames a row (a 30-s window), a 64-token decoder prompt, 32 greedy
# steps: batched transcription (the non-causal flash kernel at 1500 x
# 1500 in the encoder, cross attention over 1500 keys, 96 launches a
# prefill); H: internvl2-76b (arXiv:2404.16821) at full width in bf16
# (d 8192, 64 / 8 heads of 128, SwiGLU d_ff 28672, vocab 128256, 256
# patch tokens of 3200 projected), its depth cut from 80 layers to 32
# (29.5 B parameters, 59 GB; the 80 layers are 141 GB, past one card),
# batch 4, a 1024-position prompt (256 patch + 768 text tokens, the
# full_attention branch), 16 steps: batched image question answering
LM_CELLS = (("A", "tinyllama-1.1b", False, 8, 512, 32, 0),
            ("B", "gemma-7b", True, 1, 2048, 16, 0),
            ("C", "moonshot-v1-16b-a3b", True, 8, 512, 16, 0),
            ("D", "deepseek-v2-236b", True, 1, 2048, 16, 6),
            ("E", "mamba2-1.3b", True, 8, 2048, 32, 0),
            ("F", "recurrentgemma-9b", True, 1, 4096, 16, 0),
            ("G", "whisper-large-v3", True, 8, 64, 32, 0),
            ("H", "internvl2-76b", True, 4, 1024, 16, 32))
# gate 1: each arch's model on the card against the CPU from the same
# weights, in f32 at batch 1, a 64-token prompt and 4 decode steps (the
# MoE archs and mamba2 at depth 2: the first dense layer and one MoE
# layer; recurrentgemma at depth 4, one group and one tail layer, once
# at its window of 2048 and once with the window cut to 32, which is a
# correctness gate and not a cell: at a 64-token prompt the band masks
# and the ring of 32 slots wraps, at full width, cheaply on the CPU;
# whisper at 2 encoder and 2 decoder layers over the full 1500 frames,
# its cross caches too; internvl at depth 2, its 256 patch tokens before
# the 64 text tokens).
# Logits within LM_TOL of the largest |logit|: each of tinyllama's 22
# layers sums 2048 to 5632 f32 products in cuBLAS's order against the
# CPU's, each sum about sqrt(n) 2^-24 ~ 5e-6 relative, the errors
# growing with depth; the flash kernel against the plain softmax adds
# 2e-5 (phase 7's)
LM_GATE = dict(batch=1, prompt=64, steps=4)
LM_TOL = 2e-4
LM_GATE_ARCHS = (("tinyllama-1.1b", 0, 0), ("moonshot-v1-16b-a3b", 2, 0),
                 ("deepseek-v2-236b", 2, 0), ("mamba2-1.3b", 2, 0),
                 ("recurrentgemma-9b", 4, 0), ("recurrentgemma-9b", 4, 32),
                 ("whisper-large-v3", 2, 0), ("internvl2-76b", 2, 0))
# gate 4: cell C's layer 1 (the first MoE layer) at this many tokens,
# capacity_factor = E so that no assignment drops, against the
# every-expert oracle in bf16 (TOL_BF16 of the largest output)
MOE_ORACLE_TOKENS = 512
TOL_BF16 = 2.0 ** -5


def lm_config(arch, bf16, layers=0, window=0):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import scale_config
    cfg = get_config(arch)
    if layers:     # whisper: as many encoder layers as decoder layers
        cfg = dataclasses.replace(cfg, num_layers=layers, encoder_layers=(
            layers if cfg.encdec else cfg.encoder_layers))
    if window:
        cfg = dataclasses.replace(cfg, local_window=window)
    return scale_config(cfg) if bf16 else cfg


def attention_layers(cfg) -> int:
    """The attention calls of a prefill: every layer of the dense, MoE,
    MLA and VLM archs, none of the SSM, the hybrid's local layers,
    whisper's encoder layers and twice its decoder layers (self and
    cross attention)."""
    if cfg.ssm:
        return 0
    if cfg.encdec:
        return cfg.encoder_layers + 2 * cfg.num_layers
    if cfg.hybrid:
        pattern = cfg.block_pattern
        return sum(pattern[i % len(pattern)] == "local"
                   for i in range(cfg.num_layers))
    return cfg.num_layers


def mla_blocks(cfg, s: int) -> int:
    """MLA's query / key blocks at a prompt of ``s``: 1 up to
    ``attn_chunk``, past it ``attn_chunk`` reduced until it divides s
    (``models.mla._block``)."""
    if s <= cfg.attn_chunk:
        return 1
    c = cfg.attn_chunk
    while s % c:
        c -= 1
    return s // c


def prefill_flash_launches(cfg, s: int) -> int:
    """The flash launches of a prefill of ``s`` tokens: one an attention
    call, and an MLA layer past ``attn_chunk`` one a (query block, key
    block <= it) pair, n (n + 1) / 2 for n blocks."""
    n = mla_blocks(cfg, s) if cfg.mla else 1
    return attention_layers(cfg) * n * (n + 1) // 2


def lm_params(cfg, seed):
    import torch
    from repro_torch.models import build_model
    return build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed))


def prompt_positions(cfg, text: int) -> int:
    """The decoder positions of a prompt of ``text`` tokens: the VLM's
    patch tokens come first."""
    return text + (cfg.num_vision_tokens if cfg.frontend == "vision_stub"
                   else 0)


def n_params(params) -> int:
    return sum(a.numel() for a in leaves(params))


def lm_card_gate(seed: int, arch: str, layers: int = 0, window: int = 0):
    """Gate 1: ``arch``'s model (f32, ``layers`` deep, ``local_window``
    replaced by ``window`` when given) on the card against the CPU from
    the same weights: prefill and decode logits within ``LM_TOL`` of the
    largest |logit|, greedy tokens equal wherever the CPU's top-2 gap
    exceeds that; both fed the card's greedy tokens.  Returns (worst
    error over bound, seconds)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.launch.serve import lm_batch
    t0 = time.perf_counter()
    cfg = lm_config(arch, False, layers, window)
    model = build_model(cfg)
    card = lm_params(cfg, seed)
    cpu = cpu_tree(card)
    b, steps = LM_GATE["batch"], LM_GATE["steps"]
    s = prompt_positions(cfg, LM_GATE["prompt"])
    batch = lm_batch(cfg, b, s, seed)
    lg, cg = model.prefill(card, batch, s + steps)
    lc, cc = model.prefill(cpu, batch, s + steps)
    worst = 0.0
    for name in ("ck", "cv") if cfg.encdec else ():
        got, want = cg["seg0"][name].float().cpu(), cc["seg0"][name].float()
        bound = LM_TOL * max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        worst = max(worst, err / bound)
        log(f"lm gate card vs cpu {arch} f32 {cfg.num_layers} layers cross "
            f"cache {name} {tuple(want.shape)}: max |{name}| "
            f"{float(want.abs().max()):.4f}, max_abs_err {err:.3e} (bound "
            f"{bound:.3e})")
        check(err <= bound, f"lm gate {arch}: card {name} {err} from the "
                            f"CPU's (bound {bound})")
        del got, want
    for step in range(steps + 1):
        got, want = lg[:, -1].float().cpu(), lc[:, -1].float()
        bound = LM_TOL * max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        worst = max(worst, err / bound)
        top2 = want.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        log(f"lm gate card vs cpu {arch} f32 {cfg.num_layers} layers"
            f"{f' window {window}' if window else ''} "
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
    count = n_params(cpu)
    del card, cpu, cg, cc
    seconds = time.perf_counter() - t0
    log(f"lm gate card vs cpu {arch}"
        f"{f' window {window}' if window else ''}: {seconds:.1f} s "
        f"({count / 1e9:.3f} B params, {count * 4 / 1e9:.2f} GB in f32, on "
        f"each side)")
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


def sdpa_ms(q, k, v, window=0, causal=True):
    """The library yardstick: ``scaled_dot_product_attention``'s time at
    the kernel's operands ((b, heads, s, width) views; under ``window``
    the causal band as a boolean ``attn_mask``), or (None, its refusal)
    where PyTorch does not take them."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        sq, sk = q.shape[1], k.shape[1]
        gap = (torch.arange(sq, device=q.device)[:, None]
               - torch.arange(sk, device=q.device)[None, :])
        band = (gap >= 0) & (gap < window)
        call = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        call = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    try:
        call()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return time_ms(call, 10), None


class FlashCalls:
    """While entered, every ``ops.flash_attention`` call goes through a
    wrapper that counts it by (causal, window, kv_valid, shapes) in
    ``counts`` (a tuple and a dict update on the host a call) and, with
    ``capture``, copies the operands of each key's first call into
    ``calls`` as (q, k, v, causal, window), in call order (whisper: its
    encoder's layer 0, the decoder's layer-0 self and cross attention;
    the hybrid: its first local layer; the others: layer 0)."""

    def __init__(self, capture: bool = False):
        self.capture, self.counts, self.calls = capture, {}, []

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, launch = ops, ops.flash_attention

        def record(q, k, v, *, causal=True, window=0, kv_valid=0,
                   with_lse=False, **offset_mask):
            key = (causal, window, kv_valid, tuple(q.shape), tuple(k.shape),
                   tuple(v.shape))
            if key not in self.counts and self.capture:
                self.calls.append((q.clone(), k.clone(), v.clone(), causal,
                                   window))
            self.counts[key] = self.counts.get(key, 0) + 1
            return launch(q, k, v, causal=causal, window=window,
                          kv_valid=kv_valid, with_lse=with_lse,
                          **offset_mask)
        self.launch, ops.flash_attention = launch, record
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.launch


def flash_at_shape(label, arch, q, k, v, causal, window=0):
    """Gate 2 on one served call's operands: the kernel against its plain
    version (phase 7's tolerance; under a window also in f32), then its
    time beside the bound, the plain version and SDPA (or SDPA's
    refusal).  Returns the kernel's record at this shape."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, sq, H, dh = q.shape
    sk, KVH, dv = k.shape[1], k.shape[2], v.shape[-1]
    name = str(q.dtype).split(".")[-1]
    shape = (f"b={b} sq={sq} sk={sk} H={H} KVH={KVH} dh={dh} dv={dv}"
             + (f" window={window}" if window else ""))
    kind = "causal" if causal else "non-causal"
    err = None
    # the served type, and under a window also f32 at the same shape
    for dt in (q.dtype,) + ((torch.float32,) if window else ()):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        got = fa.flash_attention_cuda(qd, kd, vd, causal=causal,
                                      window=window)
        want = fa.flash_attention_torch(qd, kd, vd, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        tol = flash_tolerance(dt)
        e = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isclose(got.float(), want.float(), rtol=tol,
                                atol=tol).all())
        log(f"lm gate flash cell {label} {arch} {shape} {kind} "
            f"{str(dt).split('.')[-1]} ({flash_body(dt, dh, dv)}): "
            f"max_abs_err {e} (tolerance {tol}): "
            f"{'within' if ok else 'OUTSIDE'}")
        check(ok, f"flash_attention kernel != plain version at cell "
                  f"{label}'s shape ({dt}): max_abs_err {e}")
        err = e if err is None else err
        del got, want, qd, kd, vd
    ms = time_ms(lambda: fa.flash_attention_cuda(
        q, k, v, causal=causal, window=window), 5)
    plain_ms = time_ms(lambda: fa.flash_attention_torch(
        q, k, v, causal=causal, window=window), 2)
    lib_ms, refused = sdpa_ms(q, k, v, window, causal)
    nbytes, nops = attention_work(b, sq, sk, H, KVH, dh, causal,
                                  q.element_size(), dv, window)
    # the body's own rate: bf16 tensor cores, or 3xTF32 (f32; the
    # FMA-rate bound in the log line only)
    b_ms, b_by = bound_ms(nbytes, nops,
                          BF16_OPS_PER_S if q.dtype == torch.bfloat16
                          else TF32X3_OPS_PER_S)
    fma = ("" if q.dtype == torch.bfloat16 else
           f", {bound_ms(nbytes, nops)[0]:.4f} ms at the f32 FMA rate")
    lib = (f"library scaled_dot_product_attention {lib_ms:.4f} ms, kernel "
           f"/ SDPA {ms / lib_ms:.2f}" if lib_ms is not None else
           f"library scaled_dot_product_attention refused: {refused}")
    log(f"kernel flash_attention cell {label} {arch} {shape} {kind} {name}:"
        f" {ms:.4f} ms ({nops / ms / 1e9:.2f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}){fma}, {lib}")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:71",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def padding_identity(q, k, v, chunk: int = 1024):
    """At cell G's cross attention shape: the card's call on the unpadded
    operands (what the model launches) against the reference's padded
    form on the card (q and k / v zero-padded to multiples of
    ``chunk``, the padded keys masked by ``kv_valid``), rows [0, sq)
    compared bit for bit: each query row is computed on its own, and the
    ragged-tail mask (-inf past sk) and kv_valid's (NEG_INF) both give
    those keys p = 0 exactly."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    sq, sk = q.shape[1], k.shape[1]
    qp = F.pad(q, (0, 0, 0, 0, 0, -(-sq // chunk) * chunk - sq))
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, -(-sk // chunk) * chunk - sk))
              for t in (k, v))
    got = fa.flash_attention_cuda(q, k, v, causal=False)
    want = fa.flash_attention_cuda(qp, kp, vp, causal=False,
                                   kv_valid=sk)[:, :sq]
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    log(f"lm gate padding identity cell G: unpadded q {tuple(q.shape)}, k / "
        f"v {tuple(k.shape)} against padded q {tuple(qp.shape)}, k / v "
        f"{tuple(kp.shape)} at kv_valid {sk}, rows [0, {sq}): "
        f"{'equal bit for bit' if same else 'DIFFERENT'} (max_abs_err "
        f"{err})")
    check(same, f"cross attention unpadded != padded with kv_valid: {err}")


def mla_flash_f32_gate(seed: int):
    """Gate 2 (f32): the (192, 128) instance's 3xTF32 body against its plain
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


def determinism_gate(cfg, params, batch, steps: int = 2):
    """Gate 3: two prefills of the cell from the same inputs give bit for
    bit equal logits and caches, and ``steps`` decode steps from those
    equal caches bit for bit equal logits and caches."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg)
    max_len = batch["tokens"].shape[1] + steps
    (l1, c1), (l2, c2) = (model.prefill(params, batch, max_len)
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
    log(f"lm gate determinism {cfg.name}: logits of 2 prefills and "
        f"{steps} decode steps {'equal' if all(same) else same}, caches "
        f"({len(bufs)} buffers) {'equal' if same_cache else 'DIFFERENT'} "
        "bit for bit")
    check(all(same) and same_cache,
          f"{cfg.name}: two runs from the same inputs differ ({same}, "
          f"caches {same_cache})")


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


# the SSM's and the RG-LRU's pieces that ``profile_lm`` times as ranges:
# (module of repro_torch.models, function)
LM_PIECES = (("ssm", "ssd_chunked"), ("nn", "causal_conv"),
             ("ssm", "ssm_decode_step"), ("rglru", "_linear_scan"),
             ("rglru", "_gates"), ("rglru", "rglru_decode_step"))


class PieceRanges:
    """While entered, each ``LM_PIECES`` function runs inside a
    ``record_function`` range named ``module.function`` (the module
    attribute is swapped, so the port's code carries no annotation);
    ``labels`` holds the names."""

    def __enter__(self):
        import importlib
        from torch.profiler import record_function
        self.saved, self.labels = [], set()
        for mod_name, fn_name in LM_PIECES:
            mod = importlib.import_module(f"repro_torch.models.{mod_name}")
            fn, label = getattr(mod, fn_name), f"{mod_name}.{fn_name}"

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with record_function(_label):
                    return _fn(*a, **kw)
            self.saved.append((mod, fn_name, fn))
            self.labels.add(label)
            setattr(mod, fn_name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def profile_lm(label, cfg, params, batch, max_len, out_dir, mesh=None):
    """With ``--profile``: ``torch.profiler`` over one prefill and 4
    decode steps of a cell (after its counted window; split over
    ``mesh``'s model axis when given): wall time (host clock, profiler
    on), device busy time, the device's idle share, kernel launches, the
    ops by device and by host time, the SSM's and RG-LRU's pieces
    (``LM_PIECES``) as ranges; a Chrome trace to
    ``<out_dir>/profile_lm_<label>.json``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import build_serve_fns
    prefill_fn, decode_fn, _ = build_serve_fns(cfg, mesh=mesh)
    batch = {k: torch.from_numpy(a).cuda() for k, a in batch.items()}
    logits, caches = prefill_fn(params, batch, max_len)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    for what, reps in (("prefill", 1), ("decode", 4)):
        with PieceRanges() as ranges, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                if what == "prefill":
                    prefill_fn(params, batch, max_len)
                else:
                    logits, caches = decode_fn(params, tok, caches)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in ranges.labels]
        for e in prof.key_averages():
            if e.key in ranges.labels:
                side = ("device span" if e.device_type == DeviceType.CUDA
                        else "host")
                total = (getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0.0)
                         if side == "device span" else e.cpu_time_total)
                per = "prefill" if what == "prefill" else "step"
                log(f"profile lm cell {label} {what} range {e.key} "
                    f"({side}): {e.count / reps:.1f} calls and "
                    f"{total / 1e3 / reps:.3f} ms a {per}")
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
    the next, with the gates: 1 card against CPU per arch (the hybrid
    also at a window of 32), 2 the flash kernel on every distinct call of
    a served prefill of each attention cell (``FlashCalls``; the f32
    (192, 128) body; at cell F the windowed kernel in bf16 and f32; at
    cell G whisper's non-causal encoder and cross attention, with the
    padding identity), 3 two runs bit for bit at cells C (MoE) and E
    (SSM), 4 the dispatch against its oracle at cell C, the ICQ-KV
    top_c = S check, and the launch counts (one flash launch an attention
    a prefill, none at cell E, none a decode step; in ``serve_lm``'s run
    counted by distinct call too, the counts summing to the wrapper's).
    With ``profile_dir``, ``profile_lm`` of each cell.  Returns (the
    served cells' launches, the flash kernel's records at cell B's call,
    at cell D's two (the (192, 128) instance, the causal diagonal block
    and the non-causal earlier one), at cell F's (the window) and
    at cell G's encoder and cross attention (non-causal), each of the
    latter with its own call's launches in ``serve_lm``'s run))."""
    import gc
    import torch
    from repro_torch.launch.serve import lm_batch, serve_lm
    from repro_torch.models import build_model
    log(f"phase 14: torch.get_float32_matmul_precision() = "
        f"{torch.get_float32_matmul_precision()!r}, "
        f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matrix products are on")
    t0 = time.perf_counter()
    for arch, layers, window in LM_GATE_ARCHS:
        lm_card_gate(seed, arch, layers, window)
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
        with FlashCalls() as served:
            out = serve_lm(cfg, prompt_len=s, decode_steps=steps, batch=b,
                           device="cuda", seed=seed, icq_kv=label == "A",
                           params=params, verbose=False)
        launches = read_launches()
        n_attn = prefill_flash_launches(cfg, s)
        want = {k: 0 for k in launches}
        want["flash_attention"] = 2 * n_attn   # warm + timed
        log(f"lm cell {label} launches {launches} (prefill "
            f"{out['launches']['prefill']}, decode "
            f"{out['launches']['decode']}); flash by distinct call "
            f"{list(served.counts.values())}")
        check(launches == want and out["launches"] == dict(
            prefill=n_attn, decode=0)
            and sum(served.counts.values()) == launches["flash_attention"],
            f"lm cell {label}: launches {launches} / {out['launches']} / "
            f"{served.counts}, want {n_attn} flash a prefill and none a "
            "decode step")
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
            f"({n_params(params) / 1e9:.3f} B params, "
            f"{n_params(params) * params['embed'].element_size() / 1e9:.2f}"
            f" GB; param_count() {cfg.param_count() / 1e9:.3f} B{depth}; "
            f"init "
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
        batch0 = lm_batch(cfg, b, s, seed)         # the served batch
        with FlashCalls(capture=True) as seen:
            build_model(cfg).prefill(params, batch0, s + steps)
        calls = seen.calls
        # distinct calls: whisper's three; an MLA prefill past attn_chunk
        # two (the causal diagonal blocks, the non-causal earlier ones)
        distinct = (3 if cfg.encdec else 2 if cfg.mla
                    and mla_blocks(cfg, s) > 1 else min(n_attn, 1))
        check(list(seen.counts) == list(served.counts)
              and len(calls) == distinct,
              f"lm cell {label}: distinct flash calls {list(seen.counts)}, "
              f"served {list(served.counts)}")
        recs = [dict(flash_at_shape(label, arch, *call), launches=n)
                for call, n in zip(calls, served.counts.values())]
        if label == "C":
            determinism_gate(cfg, params, batch0)
            moe_oracle_gate(cfg, params, seed)
        if label == "E":
            determinism_gate(cfg, params, batch0)
        if profile_dir:
            profile_lm(label, cfg, params, batch0, s + steps, profile_dir)
        if label == "B":
            records["flash_attention"] = recs[0]
        if label == "D":     # the causal diagonal blocks, the earlier ones
            records["flash_attention_mla"] = dict(
                recs[0], name="flash_attention (192, 128, causal block)")
            records["flash_attention_mla_noncausal"] = dict(
                recs[1], name="flash_attention (192, 128, non-causal block)")
        if label == "F":
            records["flash_attention_window"] = dict(
                recs[0], name="flash_attention (window 2048)")
        if label == "G":     # encoder, decoder self, cross, in call order
            records["flash_attention_encoder"] = dict(
                recs[0], name="flash_attention (non-causal, encoder)")
            records["flash_attention_cross"] = dict(
                recs[2], name="flash_attention (non-causal, cross)")
            padding_identity(*calls[2][:3])
        del params, seen, calls      # the captured operands
        gc.collect()
        torch.cuda.empty_cache()
        log(f"lm cell {label} ran {time.perf_counter() - t_cell:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB left "
            "allocated after it")
    log(f"phase 14 ran {time.perf_counter() - t0:.1f} s; the "
        "flash_attention records are cell B's, cell D's (causal and "
        "non-causal blocks), cell F's and cell G's (encoder, cross) served "
        "prefill calls")
    return total, records


# phase 15: the train cell "LM train A", tinyllama-1.1b
# (src/repro/configs/tinyllama_1_1b.py, arXiv:2401.02385) at full width
# and depth in f32 as configured (remat on, microbatch_size 8, ce_chunk
# 2048), shapes.py's train_4k (4096 x 256) cut to 2048 x 16: two
# microbatches of 8 x 2048 a step; 4 steps with a checkpoint every 2,
# then the resume to 6, the command a user runs
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_ARGS = ("--seq-len", "2048", "--global-batch", "16",
              "--save-every", "2")
TRAIN_STEPS = (4, 6)
# gate: the model at depth 2, batch 1, 64 tokens, f32, card against CPU
# from the same weights: the loss to 1e-5 relative, every gradient leaf
# within LM_TOL of its largest magnitude on the CPU (the products' sums
# in cuBLAS's and the flash kernel's orders against the CPU's, through a
# forward and a backward)
TRAIN_GATE = dict(layers=2, batch=1, tokens=64)


def train_flash_launches(cfg, n_micro: int) -> dict:
    """The flash launches of one train step: every attention layer of
    every microbatch runs the forward twice under remat (the step and
    the recompute of its backward), once without it, and each backward
    kernel once."""
    n = attention_layers(cfg) * n_micro
    return {"flash_attention": n * (2 if cfg.remat else 1),
            "flash_attention_bwd_dq": n, "flash_attention_bwd_dkdv": n}


def train_card_gate(seed: int):
    """Phase 15 (a): tinyllama's loss and gradients at depth 2 on the
    card against the CPU from the same weights, with the step's flash
    launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_GATE["layers"])
    model = build_model(cfg)
    card = lm_params(cfg, seed)
    cpu = cpu_tree(card)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_GATE["batch"], TRAIN_GATE["tokens"]),
        dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}

    def loss_and_grads(params):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = model.train_forward(tree_unflatten(params, live), batch)
        return float(loss.detach()), torch.autograd.grad(loss, live)
    reset_launches()
    lc, gc = loss_and_grads(card)
    torch.cuda.synchronize()
    launches = read_launches()
    lp, gp = loss_and_grads(cpu)
    names = ["/".join(k) for k in _leaf_paths(card)]
    worst, worst_name = 0.0, ""
    for name, x, y in zip(names, gc, gp):
        bound = LM_TOL * max(1e-30, float(y.abs().max()))
        rel = float((x.cpu() - y).abs().max()) / bound
        if rel > worst:
            worst, worst_name = rel, name
    want = {k: 0 for k in launches}
    want.update(train_flash_launches(cfg, 1))
    loss_rel = abs(lc - lp) / abs(lp)
    log(f"train gate card vs cpu {TRAIN_ARCH} f32 {cfg.num_layers} layers "
        f"batch {TRAIN_GATE['batch']} x {TRAIN_GATE['tokens']}: loss "
        f"{lc!r} against {lp!r} (relative {loss_rel:.3e}, tolerance 1e-5); "
        f"{len(names)} gradient leaves, the worst {worst_name} at "
        f"{worst:.3f} of its bound ({LM_TOL} of the leaf's largest); "
        f"launches {launches}")
    check(loss_rel <= 1e-5, f"train gate: card loss {lc} != CPU's {lp}")
    check(worst <= 1.0, f"train gate: gradient {worst_name} at {worst} of "
                        "its bound")
    check(launches == want, f"train gate launches {launches} != {want}")
    del card, cpu, gc, gp


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


def lm_training(seed: int, card: str):
    """Phase 15: LM training on the card.  (a) ``train_card_gate``;
    (b) the full-width train command (``launch.train``'s ``main``, in
    process): ``--steps 4 --save-every 2``, then two more steps from its
    final state in memory (the uninterrupted run), then ``--resume
    --steps 6`` from its checkpoint, whose losses must equal the
    uninterrupted run's bit for bit; every loss finite and ``dt`` a step,
    peak MiB and the flash launches of one step (counts reset before the
    uninterrupted step 4, read after).  Returns the launches of the
    command's runs."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    train_card_gate(seed)
    gc.collect()
    torch.cuda.empty_cache()
    total = {k: 0 for k in read_launches()}

    def add(launches):
        for k in total:
            total[k] += launches[k]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as workdir:
        ck = os.path.join(workdir, "ck")
        disk = shutil.disk_usage(workdir)
        log(f"phase 15: {disk.free / 2**30:.1f} GiB free for checkpoints")
        argv = ["--arch", TRAIN_ARCH, *TRAIN_ARGS, "--ckpt-dir", ck]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_run = time.perf_counter()
        run = train_cli.main(argv + ["--steps", str(TRAIN_STEPS[0])])
        t_run = time.perf_counter() - t_run
        add(read_launches())
        cfg, n_micro = run["cfg"], run["n_micro"]
        state = run.pop("state")
        log(f"lm train A: {TRAIN_STEPS[0]} steps in {t_run:.1f} s (host "
            f"clock, init and checkpoints included), n_micro {n_micro}; "
            "two more steps from the final state in memory (the "
            "uninterrupted run):")
        per_step = None
        for step in range(TRAIN_STEPS[0], TRAIN_STEPS[1]):
            reset_launches()
            state, _ = run["step_fn"](state, step)
            torch.cuda.synchronize()
            launches = read_launches()
            add(launches)
            per_step = per_step or launches
        peak = torch.cuda.max_memory_allocated() / 2**20
        whole = dict(run["losses"])
        dts = dict(run["dts"])
        del run, state
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        resumed = train_cli.main(argv + ["--steps", str(TRAIN_STEPS[1]),
                                         "--resume"])
        add(read_launches())
        same = {i: resumed["losses"][i] == whole[i]
                for i in resumed["losses"]}
        want = {k: 0 for k in per_step}
        want.update(train_flash_launches(cfg, n_micro))
        log(f"lm train A {TRAIN_ARCH} f32 ({cfg.num_layers} layers, d "
            f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}, remat {cfg.remat}, ce_chunk {cfg.ce_chunk}) "
            f"batch {TRAIN_ARGS[3]} x {TRAIN_ARGS[1]} in {n_micro} "
            f"microbatches: losses {whole}, resumed "
            f"{resumed['losses']} (equal {same}); dt a step (host clock, "
            f"synchronised by the loss read) {dts}, resumed "
            f"{resumed['dts']}; peak {peak:.1f} MiB; launches a step "
            f"{per_step}; {card}")
        check(all(np.isfinite(v) for v in whole.values())
              and sorted(whole) == list(range(TRAIN_STEPS[1])),
              f"lm train A: losses {whole}")
        check(resumed["report"].resumed_from == TRAIN_STEPS[0] - 1
              and sorted(resumed["losses"]) == list(
                  range(TRAIN_STEPS[0], TRAIN_STEPS[1])) and all(
                      same.values()),
              f"lm train A: resumed losses {resumed['losses']} != the "
              f"uninterrupted run's {whole}")
        check(per_step == want, f"lm train A launches a step {per_step} != "
                                f"{want}")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 15 ran {time.perf_counter() - t0:.1f} s")
    return total


# ------------------------------------- phase 16: MLA at length, sharding ----

# (a) one mla_dense layer's attention at DeepSeek-V2's full width
# (configs/deepseek_v2_236b.py: 128 heads, kv_lora 512, q/k 128 + 64, v
# 128) in bf16 at prefill_32k's length (32768 tokens, batch 1: 32 blocks of
# attn_chunk 1024, 528 flash launches), against the materialized path from
# the same weights within TOL_BF16_LM of the largest output; the same in
# f32 at MLA_F32's length (4 blocks) within 2e-5
MLA_LEN = dict(s=32768, b=1)
MLA_F32 = dict(s=4096, b=1)
TOL_BF16_LM = 2e-2
# (a) under autograd: the same layer's attention (_MLABlockwise from the
# layer's q_nope, q_rope, latent, k_rope and w_uk, w_uv) against the
# materialized path (_materialize + full_attention: K and V of the whole
# sequence, one flash launch forward, one of each backward kernel), the
# six gradients within phase 7's backward rule, at MLA_LEN in bf16 and
# MLA_F32 in f32; at MLA_CPU in f32 also against the CPU's
# mla_chunked_attention (autograd of the reference's twin); the bytes each
# path saves for its backward (saved_tensors_hooks, by storage), the
# backward's ms and peak.  MLA_STEP: deepseek-v2's train step cut to its
# one mla_dense layer (60 -> 1; 1.39 B parameters in f32 as configured),
# train_4k's 4096 tokens, batch 1 (4 blocks of attn_chunk 1024), against
# the same step at attn_chunk 4096 (the materialized path): the loss and
# gnorm of build_train_step's step, and every gradient of train_forward,
# within LM_TOL (phase 15's 2e-4) of the leaf's largest
MLA_CPU = dict(s=2048, b=1)
MLA_STEP = dict(layers=1, tokens=4096, rows=1)
# (b) the sharded train step: tinyllama-1.1b at full width, depth 2, f32
# as configured, over make_mesh_auto((2, 2, 1), (pod, data, model)) on the
# first card, a global batch of 8 x 512 in one microbatch (2 rows a
# shard); the plain step and the icq_grad step (compressed cross-pod
# mean).  The first AdamW step moves a param by less than the learning
# rate (3e-7 at step 1 of the warmup) whatever the gradient, so the
# gates hold what carries the gradient: the combined gradient read back
# from the moments (m = (1 - b1) c g, v = (1 - b2) (c g)^2, c the clip
# factor), the pre-clip norm and the residuals.  Plain, against the
# unsharded step on the card and the same sharded step on the CPU: the
# loss to 1e-5, the norm to LM_TOL, params, m and v within LM_TOL of
# each leaf's largest.  icq_grad (each pod's gradient rows rounded to
# their int8 grid, step = the row's largest / 127: an element moves by
# at most half a step, the pods' mean by B / 2, B = M / 127, M the leaf's
# largest over the pods' own gradients, each from the unsharded step
# over the pod's rows): against the unsharded plain step, the gradient
# (from m; |g| from v) within B, the norm within the norm of the half
# steps, the residuals' pod mean equal to the plain gradient less the
# compressed one within LM_TOL of M, each residual within (1 + LM_TOL)
# M / 254, params within twice the first step's rate and f32 rounding;
# against the CPU's icq_grad step, the gradient and the residuals within
# B + 3 LM_TOL M (a rounding flip moves an element by one step of its
# row, the two sides' inputs and row maxima agreeing within LM_TOL of
# M), the norm to LM_TOL
SHARD_STEP = dict(layers=2, rows=8, tokens=512, mesh=(2, 2, 1))
EPS32 = 2.0 ** -23
# (c) the combine programs over 2 pods of tinyllama's full parameter
# vector ((rows, 256) f32, one device a pod); (d) reshard_state of
# tinyllama's full params from (data 4) to (data 2, model 2) and back


def mla_block_bytes(cfg, b: int, c: int, item: int) -> int:
    """One (query block, key block) pair's working set in
    ``mla_blockwise_attention``: q_blk, k_nope, k_blk, v_blk and o_b in
    the latent's type (``item`` bytes), the log-sum-exp, the f32
    accumulator and one f32 merge temporary."""
    rows = b * c * cfg.num_heads
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    return rows * (item * (2 * dqk + dn + 2 * dv) + 4 + 8 * dv)


def mla_at_length(seed: int, card: str, bf16: bool, b: int, s: int):
    """Phase 16 (a) at one type and length: the block-wise attention and
    the materialized one (K and V of the whole sequence, one flash
    launch) from the same weights and inputs; each call's peak
    allocation above its inputs and output.  Returns (launches of the
    block-wise call, max_abs_err / largest, ms, peak bytes)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import mla as mla_mod
    cfg = lm_config("deepseek-v2-236b", bf16, 1)
    dt = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed + 1600)
    p = mla_mod.mla_init(gen, cfg, dt)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.float32).to(dt)
    pos = torch.arange(s, device="cuda")
    with torch.no_grad():
        qn, qr = mla_mod._queries(p, x, cfg, pos)
        lat, kr = mla_mod._latent(p, x, cfg, pos)
        args = (p, qn, qr, lat, kr, cfg)

        def blockwise():
            return mla_mod.mla_blockwise_attention(*args)

        def materialized():
            q, k, v = mla_mod._materialize(*args)
            return fa.flash_attention_cuda(q, k, v, causal=True)

        def peak(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            extra = (torch.cuda.max_memory_allocated() - base
                     - out.numel() * out.element_size())
            return out, extra
        blockwise()                   # warm: cuBLAS workspaces, launches
        reset_launches()
        got, peak_b = peak(blockwise)
        launches = read_launches()["flash_attention"]
        want, peak_m = peak(materialized)
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        del want
        ms = time_ms(blockwise, 2)
        ms_m = time_ms(materialized, 2)
    n = mla_blocks(cfg, s)
    work = mla_block_bytes(cfg, b, s // n, x.element_size())
    kv = b * s * cfg.num_heads * (cfg.qk_nope_head_dim
                                  + cfg.qk_rope_head_dim
                                  + cfg.v_head_dim) * x.element_size()
    tol = TOL_BF16_LM if bf16 else flash_tolerance(torch.float32)
    log(f"phase 16 (a) mla block-wise deepseek-v2-236b "
        f"{'bf16' if bf16 else 'f32'} b={b} s={s} ({n} blocks, H "
        f"{cfg.num_heads}, (192, 128)): {launches} flash launches (want "
        f"{n * (n + 1) // 2}), max_abs_err {err} against the materialized "
        f"path (largest {top}; {err / top:.3e} of it, tolerance {tol}), "
        f"{ms:.3f} ms against {ms_m:.3f} ms materialized (CUDA events); "
        f"peak above inputs and output {peak_b / 2**20:.1f} MiB (bound: two "
        f"blocks' working set, 2 x {work / 2**20:.1f} MiB), materialized "
        f"{peak_m / 2**20:.1f} MiB (its K + V alone {kv / 2**20:.1f} MiB); "
        f"{card}")
    check(launches == n * (n + 1) // 2,
          f"mla block-wise: {launches} flash launches")
    check(err <= tol * top, f"mla block-wise != materialized: {err}")
    check(peak_b <= 2 * work, f"mla block-wise peak {peak_b} B > 2 x {work}")
    del got, p, x, qn, qr, lat, kr, args
    return launches, err / top, ms, peak_b


def saved_for_backward(fn):
    """``fn()``'s output and what autograd saved for its backward while it
    ran: {storage pointer: (shape, storage bytes)} (a storage saved twice
    counted once)."""
    import torch
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen.setdefault(st.data_ptr(), (tuple(t.shape), st.nbytes()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, seen


def mla_grad_at_length(seed: int, card: str, bf16: bool, b: int, s: int,
                       cpu: bool = False):
    """Phase 16 (a) under autograd at one type and length (the comment
    above ``MLA_CPU``).  Returns the launches of the block-wise forward
    and backward."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import mla as mla_mod
    cfg = lm_config("deepseek-v2-236b", bf16, 1)
    dt = torch.bfloat16 if bf16 else torch.float32
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv = cfg.v_head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed + 1610)
    p = mla_mod.mla_init(gen, cfg, dt)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.float32).to(dt)
    pos = torch.arange(s, device="cuda")
    with torch.no_grad():
        qn, qr = mla_mod._queries(p, x, cfg, pos)
        lat, kr = mla_mod._latent(p, x, cfg, pos)
    base = (qn, qr, lat, kr, p["w_uk"], p["w_uv"])
    do = torch.randn((b, s, h, dv), generator=gen, device="cuda",
                     dtype=torch.float32).to(dt)
    del x

    def paths(leaves):
        pp = dict(p, w_uk=leaves[4], w_uv=leaves[5])

        def materialized():
            q, k, v = mla_mod._materialize(pp, *leaves[:4], cfg)
            return attn.full_attention(q, k, v, causal=True)
        return {"block-wise": lambda: mla_mod.mla_blockwise_attention(
            pp, *leaves[:4], cfg), "materialized": materialized}

    res = {}
    for name in ("block-wise", "materialized"):
        leaves = [t.detach().requires_grad_() for t in base]
        inputs = {t.untyped_storage().data_ptr() for t in leaves}
        torch.cuda.synchronize()
        reset_launches()
        out, saved = saved_for_backward(paths(leaves)[name])
        torch.cuda.synchronize()
        fwd = read_launches()
        made = {k: v for k, v in saved.items() if k not in inputs}
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        grads = torch.autograd.grad(out, leaves, do)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        res[name] = dict(
            out=out.detach(), grads=grads, made=made,
            saved_bytes=sum(nb for _, nb in made.values()),
            ms=start.elapsed_time(end), fwd=fwd,
            bwd={k: launches[k] - fwd[k] for k in launches},
            peak=torch.cuda.max_memory_allocated() - base_mem)
        del out, leaves
    got, want = res["block-wise"], res["materialized"]
    tol = flash_tolerance(dt)
    ratios, noise = tolerance_ratios(got["grads"], want["grads"], tol)
    top = float(want["out"].float().abs().max())
    err = float((got["out"].float() - want["out"].float()).abs().max())
    n = mla_blocks(cfg, s)
    pairs = n * (n + 1) // 2
    k_shape, v_shape = (b, s, h, dn + dr), (b, s, h, dv)
    shapes = sorted(sh for sh, _ in got["made"].values())
    # the block-wise path saves, besides its inputs, only its output O (V's
    # shape: the attention's output, which the materialized path saves
    # too) and L; nothing of K's shape, no second tensor of V's
    saves_ok = (k_shape not in shapes and shapes.count(v_shape) == 1
                and shapes == sorted([v_shape, (b, h, s)]))
    log(f"phase 16 (a) mla block-wise under autograd deepseek-v2-236b "
        f"{'bf16' if bf16 else 'f32'} b={b} s={s} ({n} blocks): "
        f"forward {got['fwd']['flash_attention']} flash launches (want "
        f"{pairs}), backward dq {got['bwd']['flash_attention_bwd_dq']} / "
        f"dkdv {got['bwd']['flash_attention_bwd_dkdv']} (want {pairs} each); "
        f"against the materialized path (forward "
        f"{want['fwd']['flash_attention']}, backward "
        f"{want['bwd']['flash_attention_bwd_dq']} + "
        f"{want['bwd']['flash_attention_bwd_dkdv']}): output {err / top:.3e}"
        f" of its largest, gradients of q_nope / q_rope / latent / k_rope /"
        f" w_uk / w_uv at {[round(r, 4) for r in ratios]} of phase 7's bound "
        f"({tol}; at the whole gradient's scale: {noise}); saved for "
        f"backward beyond the inputs {got['saved_bytes'] / 2**20:.1f} MiB "
        f"{shapes} against {want['saved_bytes'] / 2**20:.1f} MiB "
        f"{sorted(sh for sh, _ in want['made'].values())}; backward "
        f"{got['ms']:.3f} ms against {want['ms']:.3f} ms (CUDA events), "
        f"peak above its inputs {got['peak'] / 2**20:.1f} MiB against "
        f"{want['peak'] / 2**20:.1f} MiB; {card}")
    check(got["fwd"]["flash_attention"] == pairs
          and got["bwd"]["flash_attention_bwd_dq"] == pairs
          and got["bwd"]["flash_attention_bwd_dkdv"] == pairs,
          f"mla block-wise under autograd launches {got['fwd']}, "
          f"{got['bwd']}")
    check(err <= tol * top and max(ratios) <= 1.0,
          f"mla block-wise gradients != materialized: {ratios}, out {err}")
    check(saves_ok, f"mla block-wise saved {shapes} for backward")
    if cpu:
        leaves = [t.detach().cpu().requires_grad_() for t in base]
        cpu_p = dict(w_uk=leaves[4], w_uv=leaves[5])
        out = mla_mod.mla_chunked_attention(cpu_p, *leaves[:4], cfg)
        cg = torch.autograd.grad(out, leaves, do.cpu())
        c_ratios, c_noise = tolerance_ratios([x.cpu() for x in got["grads"]],
                                             cg, tol)
        c_err = float((got["out"].cpu().float() - out.detach().float())
                      .abs().max())
        log(f"phase 16 (a) mla block-wise under autograd f32 s={s} against "
            f"the CPU's mla_chunked_attention: output {c_err:.3e} (largest "
            f"{float(out.detach().abs().max()):.4f}), gradients at "
            f"{[round(r, 4) for r in c_ratios]} of phase 7's bound ({tol};"
            f" at the whole scale: {c_noise})")
        check(c_err <= tol * float(out.detach().abs().max())
              and max(c_ratios) <= 1.0,
              f"mla block-wise gradients != the CPU's: {c_ratios}")
        del out, cg, leaves
    launches = {k: got["fwd"][k] + got["bwd"][k] for k in got["fwd"]}
    del res, got, want, base, p, qn, qr, lat, kr
    return launches


def mla_train_step(seed: int, card: str):
    """Phase 16 (a), the train step (the comment above ``MLA_CPU``).
    Returns the launches of the block-wise step and gradient pass."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=MLA_STEP["layers"])
    tokens = MLA_STEP["tokens"]
    paths = {"block-wise": cfg,
             "materialized": dataclasses.replace(cfg, attn_chunk=tokens)}
    params = lm_params(cfg, seed + 1620)
    toks = np.random.default_rng(seed + 1621).integers(
        0, cfg.vocab_size, (1, MLA_STEP["rows"], tokens), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}
    total = {k: 0 for k in read_launches()}
    res = {}
    for name, c in paths.items():
        step, model, _, init = build_train_step(c, n_micro=1)
        step_s = []
        for _ in range(2):      # the first step of a path warms it
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = step(params, init(params), batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            step_launches = read_launches()
            metrics = {k: float(v) for k, v in out[2].items()}
            del out
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss, _ = model.train_forward(tree_unflatten(params, live),
                                      {"tokens": toks[0], "labels": toks[0]})
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        torch.cuda.synchronize()
        launches = read_launches()
        if name == "block-wise":
            for k in total:
                total[k] += launches[k]
        res[name] = dict(metrics=metrics, loss=float(loss.detach()),
                         grads=grads, step_s=step_s, launches=step_launches)
        del live, loss
    got, want = res["block-wise"], res["materialized"]
    names = ["/".join(k) for k in _leaf_paths(params)]
    worst, worst_name = 0.0, ""
    # leaves the one-layer model does not read (no gradient on either side)
    unused = [n for n, x, y in zip(names, got["grads"], want["grads"])
              if x is None or y is None]
    same_unused = all((x is None) == (y is None)
                      for x, y in zip(got["grads"], want["grads"]))
    for name, x, y in zip(names, got["grads"], want["grads"]):
        if x is None or y is None:
            continue
        rel = float((x - y).abs().max()) / (
            LM_TOL * max(1e-30, float(y.abs().max())))
        if rel >= worst:
            worst, worst_name = rel, name
    rel = {k: abs(got["metrics"][k] - want["metrics"][k])
           / abs(want["metrics"][k]) for k in ("loss", "gnorm")}
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    pairs = mla_blocks(cfg, tokens) * (mla_blocks(cfg, tokens) + 1) // 2
    remat = 2 if cfg.remat else 1
    want_launches = {k: 0 for k in got["launches"]}
    want_launches.update(flash_attention=remat * pairs,
                         flash_attention_bwd_dq=pairs,
                         flash_attention_bwd_dkdv=pairs)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"phase 16 (a) mla train step deepseek-v2-236b f32 "
        f"{cfg.num_layers} layer ({n_params} parameters), "
        f"{MLA_STEP['rows']} x {tokens}: block-wise loss "
        f"{got['metrics']['loss']!r}, gnorm {got['metrics']['gnorm']!r} "
        f"against materialized {want['metrics']['loss']!r}, "
        f"{want['metrics']['gnorm']!r} (relative {rel['loss']:.3e}, "
        f"{rel['gnorm']:.3e}; tolerance {LM_TOL}); train_forward's loss "
        f"{loss_rel:.3e} apart, {len(names) - len(unused)} gradient leaves "
        f"(unread by the model, on both sides: {unused}), the worst "
        f"{worst_name} at {worst:.4f} of its bound ({LM_TOL} of the leaf's "
        f"largest); first / second step {got['step_s'][0]:.3f} / "
        f"{got['step_s'][1]:.3f} s against {want['step_s'][0]:.3f} / "
        f"{want['step_s'][1]:.3f} s (host clock); launches a step "
        f"{got['launches']} (materialized {want['launches']}); {card}")
    check(max(rel.values()) <= LM_TOL and loss_rel <= LM_TOL,
          f"mla train step: loss / gnorm {rel}, train_forward {loss_rel}")
    check(worst <= 1.0 and same_unused,
          f"mla train step gradient {worst_name} at {worst}, unread "
          f"leaves {unused}")
    check(got["launches"] == want_launches,
          f"mla train step launches {got['launches']} != {want_launches}")
    del res, got, want, params
    return total


def _at_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _step_grads(opt, out):
    """The combined gradient that a first AdamW step (zero moments before
    it) took, read back from its moments and pre-clip norm, on the card:
    ({leaf: g from m}, {leaf: |g| from v})."""
    _, state, metrics = out
    c = min(1.0, opt.clip_norm / max(float(metrics["gnorm"]), 1e-9))
    g, a = {}, {}
    for path in _leaf_paths(state["m"]):
        m = _at_path(state["m"], path).float().cuda()
        v = _at_path(state["v"], path).float().cuda()
        g["/".join(path)] = m / ((1 - opt.b1) * c)
        a["/".join(path)] = (v / (1 - opt.b2)).sqrt() / c
    return g, a


def _flat(tree):
    return {"/".join(p): _at_path(tree, p).float().cuda()
            for p in _leaf_paths(tree)}


def _ratio(got, want, bound):
    """(worst ratio of a leaf's max |got - want| to ``bound[leaf]``, the
    leaf) over dicts of card tensors."""
    worst, name = 0.0, ""
    for k, w in want.items():
        r = float((got[k] - w).abs().max()) / max(bound[k], 1e-30)
        if r >= worst:
            worst, name = r, k
    return worst, name


def icq_step_ratios(opt, out, plain, pod_grads, cpu_out):
    """Phase 16 (b)'s icq_grad gates (the comment above SHARD_STEP): each
    {gate: (worst ratio to its bound, leaf)}, a ratio <= 1 passing."""
    import torch
    g, a = _step_grads(opt, out)
    g0, _ = _step_grads(opt, plain)
    gc, _ = _step_grads(opt, cpu_out)
    res = [_flat(r) for r in out[1]["ef_residual"]]
    res_c = [_flat(r) for r in cpu_out[1]["ef_residual"]]
    M = {k: max(float(pg[k].abs().max()) for pg in pod_grads) for k in g0}
    B = {k: m / 127 for k, m in M.items()}
    # a rounding flip: one step of its row, the rows' inputs and largest
    # agreeing within LM_TOL of M (the plain gates)
    flip = {k: B[k] + 3 * LM_TOL * M[k] for k in M}
    out_r = {
        "g vs unsharded": _ratio(g, g0, B),
        "|g| vs unsharded": _ratio(a, {k: w.abs() for k, w in g0.items()},
                                   B),
        "residual mean vs plain - icq": _ratio(
            {k: sum(r[k] for r in res) / len(res) for k in g0},
            {k: g0[k] - g[k] for k in g0}, {k: LM_TOL * M[k] for k in g0}),
        "residual half step": max(
            (float(r[k].abs().max()) / ((1 + LM_TOL) * M[k] / 254), k)
            for r in res for k in g0),
        "g vs CPU": _ratio(g, gc, flip),
        "residual vs CPU": max(_ratio(r, rc, flip)
                               for r, rc in zip(res, res_c)),
    }
    norm = sum(g0[k].numel() * (B[k] / 2) ** 2 for k in g0) ** 0.5
    gn, gn0 = float(out[2]["gnorm"]), float(plain[2]["gnorm"])
    gnc = float(cpu_out[2]["gnorm"])
    out_r["gnorm vs unsharded"] = (abs(gn - gn0) / (norm + 1e-5 * gn0),
                                   "gnorm")
    out_r["gnorm vs CPU"] = (abs(gn - gnc) / (LM_TOL * gnc), "gnorm")
    lr1 = float(opt.lr(torch.ones((), dtype=torch.int32)))
    p, p0 = _flat(out[0]), _flat(plain[0])
    out_r["params vs unsharded"] = _ratio(
        p, p0, {k: 2 * lr1 + 2 * EPS32 * float(w.abs().max())
                for k, w in p0.items()})
    return out_r


def plain_step_ratios(out, want, what, moments_only=()):
    """Phase 16 (b)'s plain gates against ``want`` (the unsharded step or
    the CPU's): params, m and v within LM_TOL of each leaf's largest,
    the pre-clip norm to LM_TOL.  The leaves named in ``moments_only``
    are held on m and v only: a leaf that starts at zero holds, after a
    first AdamW step, lr g / (|g| + eps) for each element, whose largest
    is the learning rate whatever the gradient, so an element whose
    gradient is near eps moves by a share of lr that no gradient bound
    limits to LM_TOL of it; its gradient is m's."""
    r = {}
    for name, got_t, want_t in (("params", out[0], want[0]),
                                ("m", out[1]["m"], want[1]["m"]),
                                ("v", out[1]["v"], want[1]["v"])):
        got_f, want_f = _flat(got_t), _flat(want_t)
        if name == "params":
            want_f = {k: w for k, w in want_f.items()
                      if k not in moments_only}
        r[f"{name} vs {what}"] = _ratio(
            got_f, want_f, {k: LM_TOL * float(w.abs().max())
                            for k, w in want_f.items()})
    gn, gw = float(out[2]["gnorm"]), float(want[2]["gnorm"])
    r[f"gnorm vs {what}"] = (abs(gn - gw) / (LM_TOL * gw), "gnorm")
    return r


# (b') and phase 17 (a''): FSDP (``distributed.fsdp``): the same step
# from params laid out by the full rule-table specs (each (pod, data)
# position holds its block of every leaf's FSDP dim; a layer is gathered
# where the model reads it and its gradient reduce-scattered into the
# owners' f32 accumulators), from the same state and batch as the cell's
# step on whole (or model-placed) params on the same mesh, which is the
# yardstick: (2, 2, 1) plain, FSDP over (pod, data), 4 ways; (2, 2, 1)
# icq_grad, FSDP over data (params whole across pods); (1, 2, 2), FSDP
# over data beside the split over model.  Gates against the yardstick:
# the loss to 1e-5 (bit for bit expected: the gathered layer holds the
# same values; printed), params, m, v and the norm within LM_TOL
# (plain_step_ratios: the clip's norm sums the blocks in another order);
# icq_grad, the gradient read back from m and each pod's residuals
# within a rounding flip (B + 3 LM_TOL M, phase 16 (b)'s rule against
# the CPU; bit for bit expected, printed); each position's bytes of
# params, m and v equal to ``shard_bytes`` of the full specs; the
# yardstick's flash launches; a second step from the first's output,
# the layout kept; the peak MiB above the state
# (``torch.cuda.max_memory_allocated``) no higher than the yardstick's.


def fsdp_gathered(out):
    """An FSDP step's output with every placed tree gathered whole."""
    from repro_torch.distributed import fsdp
    p, o, m = out
    o = dict(o, m=fsdp.gather(o["m"]), v=fsdp.gather(o["v"]))
    if "ef_residual" in o:
        o["ef_residual"] = [fsdp.gather(r) for r in o["ef_residual"]]
    return fsdp.gather(p), o, m


def timed_step(step, params, state, batch, mesh=None):
    """(the step's output, its seconds, its peak MiB above what was
    allocated before it, the largest over the cards of ``mesh`` (the
    current card without one), its launches).  The garbage collector
    runs first: an earlier step's cycles (a caught exception's frames)
    would otherwise be freed inside this one and hide part of its
    peak."""
    import gc
    import torch
    cards = (sorted({d.index for d in mesh.devices.flat}) if mesh is not None
             else [torch.cuda.current_device()])
    gc.collect()
    torch.cuda.synchronize()
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    reset_launches()
    t0 = time.perf_counter()
    out = step(params, state, batch)
    for c in cards:
        torch.cuda.synchronize(c)
    return (out, time.perf_counter() - t0,
            max(torch.cuda.max_memory_allocated(c) - base[c]
                for c in cards) / 2**20, read_launches())


def fsdp_cell(label, cfg, mesh, params, batch, today, want, card, *,
              icq=False, pod_grads=None):
    """Phase 16 (b') / 17 (a''): the FSDP step against ``today`` =
    (output, seconds, peak MiB) of the cell's step on the same mesh (the
    comment above). Returns (the launches of its two steps, its peak
    MiB, its seconds)."""
    import numpy as np
    import torch
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shrules
    from repro_torch.launch.steps import build_train_step
    t0 = time.perf_counter()
    step, _, opt, init = build_train_step(cfg, n_micro=1, multi_pod=True,
                                          icq_grad=icq, mesh=mesh)
    placed = fsdp.place(params, mesh, fsdp_over_pod=not icq)
    state = init(placed)
    rule = shrules.shard_bytes(params, shrules.param_shardings(
        params, mesh, fsdp_over_pod=not icq))
    held = {k: sorted({position_bytes(t, pos)
                       for pos in np.ndindex(*mesh.devices.shape)})
            for k, t in (("params", placed), ("m", state["m"]),
                         ("v", state["v"]))}
    check(all(h == [rule] for h in held.values()),
          f"FSDP {label}: positions hold {held} bytes, shard_bytes {rule}")
    out, secs, peak, launches = timed_step(step, placed, state, batch, mesh)
    (want_out, want_s, want_peak) = today
    got = fsdp_gathered(out)
    lf, lw = got[2]["loss"], want_out[2]["loss"]
    loss_r = abs(float(lf) - float(lw)) / abs(float(lw))
    same_loss = torch.equal(lf.to(lw.device), lw)
    ratios = plain_step_ratios(got, want_out, "without FSDP")
    bitwise = all(torch.equal(a.to(b.device), b) for a, b in zip(
        leaves(got[:2]), leaves(want_out[:2])))
    if icq:
        g, _ = _step_grads(opt, got)
        g0, _ = _step_grads(opt, want_out)
        M = {k: max(float(pg[k].abs().max()) for pg in pod_grads)
             for k in g0}
        flip = {k: M[k] / 127 + 3 * LM_TOL * M[k] for k in M}
        ratios["g vs without FSDP"] = _ratio(g, g0, flip)
        ratios["residual vs without FSDP"] = max(
            _ratio(_flat(r), _flat(r0), flip) for r, r0 in zip(
                got[1]["ef_residual"], want_out[1]["ef_residual"]))
    reset_launches()
    two = step(*out[:2], batch)
    torch.cuda.synchronize()
    second = read_launches()
    kept = all(a.sharding == b.sharding for t in (two[0], two[1]["m"])
               for a, b in shrules.zip_leaves(t, placed))
    loss2 = float(two[2]["loss"])
    over = "icq_grad, FSDP over data" if icq else "FSDP over the data axes"
    log(f"phase {label} FSDP train step {cfg.name} f32 {cfg.num_layers} "
        f"layers, mesh {tuple(mesh.devices.shape)} {mesh.axis_names} {over}"
        f": loss {float(lf)!r} against {float(lw)!r} without FSDP (rel "
        f"{loss_r:.3e}, {'bit for bit' if same_loss else 'NOT bit for bit'}"
        f"), gnorm {float(got[2]['gnorm'])!r} against "
        f"{float(want_out[2]['gnorm'])!r}; params, m, v "
        f"{'bit for bit' if bitwise else 'not bit for bit'}; worst leaf a "
        "gate, its ratio to the bound: "
        + ", ".join(f"{k} {n} {r:.4f}" for k, (r, n) in ratios.items())
        + f"; bytes a position of params / m / v {held} (shard_bytes "
        f"{rule}); launches {launches} (want {want}); second step loss "
        f"{loss2!r}, layout {'kept' if kept else 'LOST'}; {secs:.2f} s "
        f"against {want_s:.2f} s without FSDP; peak above the state "
        f"{peak:.1f} MiB against {want_peak:.1f} MiB without FSDP; "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    check(loss_r <= 1e-5, f"FSDP {label} loss {float(lf)}")
    bad = {k: v for k, v in ratios.items() if not v[0] <= 1.0}
    check(not bad, f"FSDP {label}: {bad}")
    check(launches == want, f"FSDP {label} launches {launches}")
    check(kept and np.isfinite(loss2), f"FSDP {label}: second step")
    check(peak <= want_peak, f"FSDP {label}: peak {peak:.1f} MiB above "
                             f"{want_peak:.1f} MiB without FSDP")
    return {k: launches[k] + second[k] for k in launches}, peak, secs


def sharded_step_gate(seed: int, card: str):
    """Phase 16 (b): the plain and the icq_grad train step over the (2,
    2, 1) mesh on the card against the unsharded step on the card and
    the same sharded step on the CPU, from the same state and batch, on
    the gradient that each step took (the comment above SHARD_STEP).
    Then (b'): the FSDP cell of each (``fsdp_cell``) against the card's
    sharded step.  Returns the launches of the two sharded steps and of
    the FSDP cells' on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.launch.steps import build_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=SHARD_STEP["layers"])
    rows, tokens = SHARD_STEP["rows"], SHARD_STEP["tokens"]
    names = ("pod", "data", "model")
    pods = SHARD_STEP["mesh"][0]
    shards = pods * SHARD_STEP["mesh"][1]
    toks = np.random.default_rng(seed + 1601).integers(
        0, cfg.vocab_size, (1, rows, tokens), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}
    card_params = lm_params(cfg, seed)
    cpu_params = cpu_tree(card_params)
    total = {k: 0 for k in read_launches()}
    step0, _, opt, init0 = build_train_step(cfg, n_micro=1)
    plain = step0(card_params, init0(card_params), batch)
    m0 = plain[2]
    # each pod's own gradient: the unsharded step over the pod's rows
    per = rows // pods
    pod_grads = [_step_grads(opt, step0(
        card_params, init0(card_params),
        {k: v[:, p * per:(p + 1) * per] for k, v in batch.items()}))[0]
        for p in range(pods)]
    for icq in (False, True):
        t0 = time.perf_counter()
        outs = {}
        for dev in ("cuda", "cpu"):
            mesh = make_mesh_auto(SHARD_STEP["mesh"], names, devices=dev)
            step, _, _, init = build_train_step(cfg, n_micro=1,
                                                multi_pod=True,
                                                icq_grad=icq, mesh=mesh)
            params = card_params if dev == "cuda" else cpu_params
            state = init(params)
            if dev == "cuda":
                outs[dev], secs, peak, launches = timed_step(
                    step, params, state, batch)
                for k in total:
                    total[k] += launches[k]
            else:
                outs[dev] = step(params, state, batch)
        want = {k: 0 for k in launches}
        for k, n in train_flash_launches(cfg, 1).items():
            want[k] = shards * n
        mc, mp = outs["cuda"][2], outs["cpu"][2]
        loss_u = abs(float(mc["loss"]) - float(m0["loss"])) / abs(
            float(m0["loss"]))
        loss_c = abs(float(mc["loss"]) - float(mp["loss"])) / abs(
            float(mp["loss"]))
        if icq:
            ratios = icq_step_ratios(opt, outs["cuda"], plain, pod_grads,
                                     outs["cpu"])
        else:
            ratios = dict(plain_step_ratios(outs["cuda"], plain,
                                            "unsharded"),
                          **plain_step_ratios(outs["cuda"], outs["cpu"],
                                              "CPU"))
        kind = "icq_grad" if icq else "plain"
        log(f"phase 16 (b) sharded train step {kind} {TRAIN_ARCH} f32 "
            f"{cfg.num_layers} layers, mesh {SHARD_STEP['mesh']} {names} on "
            f"one card, {rows} x {tokens} ({rows // shards} rows a shard): "
            f"loss {float(mc['loss'])!r}, unsharded {float(m0['loss'])!r} "
            f"(rel {loss_u:.3e}), CPU {float(mp['loss'])!r} (rel "
            f"{loss_c:.3e}), tolerance 1e-5; gnorm {float(mc['gnorm'])!r}, "
            f"unsharded {float(m0['gnorm'])!r}, CPU {float(mp['gnorm'])!r}; "
            "worst leaf a gate, its ratio to the bound: "
            + ", ".join(f"{k} {n} {r:.4f}" for k, (r, n) in ratios.items())
            + f"; launches {launches} (want {want}); "
            f"{time.perf_counter() - t0:.1f} s with the CPU's step; {card}")
        check(loss_u <= 1e-5 and loss_c <= 1e-5,
              f"sharded {kind} loss {float(mc['loss'])}")
        bad = {k: v for k, v in ratios.items() if not v[0] <= 1.0}
        check(not bad, f"sharded {kind}: {bad}")
        check(launches == want, f"sharded {kind} launches {launches}")
        if icq:
            check(len(outs["cuda"][1]["ef_residual"]) == pods,
                  "one residual tree a pod")
        del outs["cpu"]
        mesh = make_mesh_auto(SHARD_STEP["mesh"], names, devices="cuda")
        for k, n in fsdp_cell("16 (b')", cfg, mesh, card_params, batch,
                              (outs["cuda"], secs, peak), want, card,
                              icq=icq, pod_grads=pod_grads)[0].items():
            total[k] += n
        del outs
    return total


def combine_gate(card: str):
    """Phase 16 (c): the two combine programs over 2 pods of tinyllama's
    full parameter vector on the card: ms (CUDA events), the wire bytes a
    device, and the int8 result equal to the plain formula (the mean of
    dequantize(quantize(g + r)) over the pods) bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.launch import combine as cb
    from repro_torch.quant.int8 import dequantize_int8, quantize_int8
    cfg = get_config(TRAIN_ARCH)
    mesh = make_mesh_auto((2, 1, 1), ("pod", "data", "model"))
    gen = torch.Generator(device="cuda").manual_seed(1602)
    for compressed in (False, True):
        plan = cb.plan_combine_cell(cfg, mesh, compressed=compressed)
        shape = plan.args[0].shape
        g = [torch.randn(shape, generator=gen, device="cuda") * 1e-2
             for _ in range(2)]
        r = [torch.randn(shape, generator=gen, device="cuda") * 1e-4
             for _ in range(2)]

        def grid(ts):
            out = np.empty(mesh.devices.shape, dtype=object)
            for i, t in enumerate(ts):
                out.flat[i] = t
            return out
        means, res = cb.run_combine(plan, grid(g), grid(r))
        torch.cuda.synchronize()
        ms = time_ms(lambda: cb.run_combine(plan, grid(g), grid(r)), 3)
        mean = means[0, 0, 0]
        if compressed:
            want = None
            for gp, rp in zip(g, r):
                part = dequantize_int8(*quantize_int8(gp.float() + rp,
                                                      axis=-1))
                want = part if want is None else want + part
            want = want / 2
        else:
            want = (g[0] + g[1]) / 2
        same = torch.equal(mean, want)
        err = float((mean - want).abs().max())
        log(f"phase 16 (c) combine {'int8' if compressed else 'fp32'} over "
            f"2 pods of {TRAIN_ARCH}'s {cfg.param_count()} params as "
            f"{tuple(shape)} f32: {ms:.3f} ms (CUDA events), wire "
            f"{cb.wire_bytes(plan):.0f} B a device, result "
            f"{'equal' if same else 'DIFFERENT'} to the plain formula "
            f"(max_abs_err {err}); peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {card}")
        check(same, f"combine {'int8' if compressed else 'fp32'} != plain "
                    f"formula: {err}")
        del g, r, means, res, want, mean
        torch.cuda.empty_cache()


def reshard_gate(seed: int, card: str):
    """Phase 16 (d): ``reshard_state`` of tinyllama's full params (f32)
    from (data 4) to (data 2, model 2) and back on the card: every leaf
    gathered bit for bit the original; peak MiB and seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import reshard_state
    from repro_torch.distributed.sharding import make_mesh_auto
    cfg = get_config(TRAIN_ARCH)
    params = lm_params(cfg, seed)
    a = make_mesh_auto((4,), ("data",))
    b = make_mesh_auto((2, 2), ("data", "model"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    on_a = reshard_state(params, a, a)
    on_b = reshard_state(on_a, a, b, cfg)
    del on_a
    back = reshard_state(on_b, b, a)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    bad = [path for path in _leaf_paths(params) if not torch.equal(
        _at_path(back, path).gather(), _at_path(params, path))]
    split = sum(_at_path(on_b, path).shards.flat[0].numel()
                < _at_path(params, path).numel()
                for path in _leaf_paths(params))
    log(f"phase 16 (d) reshard_state {TRAIN_ARCH} "
        f"({n_params(params) / 1e9:.3f} B params, f32) (data 4) -> (data 2, "
        f"model 2) -> (data 4): {len(bad)} leaves differ after the round "
        f"trip (bit for bit), {split} leaves split on (2, 2); "
        f"{dt:.2f} s, peak {peak / 2**20:.1f} MiB above the params; {card}")
    check(not bad, f"reshard round trip differs at {bad}")
    del params, on_b, back


def lm_sharding(seed: int, card: str):
    """Phase 16: (a) MLA's block-wise attention at prefill_32k's length
    in bf16 (and f32 at 4 blocks), without grad and under autograd, and
    deepseek-v2's one-layer train step past attn_chunk, (b) the sharded
    train step, (c) the combine programs, (d) the reshard round trip.
    Returns the launches of (a) and (b)."""
    import gc
    import torch
    t0 = time.perf_counter()
    total = {k: 0 for k in read_launches()}
    for bf16, shape in ((True, MLA_LEN), (False, MLA_F32)):
        n, *_ = mla_at_length(seed, card, bf16, shape["b"], shape["s"])
        total["flash_attention"] += n
        gc.collect()
        torch.cuda.empty_cache()
    for bf16, shape, cpu in ((True, MLA_LEN, False), (False, MLA_F32, False),
                             (False, MLA_CPU, True)):
        for k, n in mla_grad_at_length(seed, card, bf16, shape["b"],
                                       shape["s"], cpu).items():
            total[k] += n
        gc.collect()
        torch.cuda.empty_cache()
    for k, n in mla_train_step(seed, card).items():
        total[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16 (a) ran {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    for k, n in sharded_step_gate(seed, card).items():
        total[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16 (b) ran {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    combine_gate(card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16 (c) ran {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    reshard_gate(seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16 (d) ran {time.perf_counter() - t1:.1f} s; phase 16 ran "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# ------------------------------------------ phase 17: tensor parallelism ----

# (a) the split train step: tinyllama-1.1b at full width, depth 2, f32,
# 8 x 512 in one microbatch over (pod 1, data 2, model 2) on the first
# card, held at phase 16 (b)'s plain gates against the unsharded step on
# the card and the same split step on the CPU; (a') the same of
# recurrentgemma-9b at full width, depth 38 -> 3 (one rglru, rglru,
# local group), f32, 2 x 4096 (twice the window) in one microbatch,
# against the unsharded step on the card only (the same split step on
# the CPU took 278-298 s, for the tied 256k-vocabulary head's products:
# the whole script ~1050 s of its 1200 s): (label, arch, layers, rows,
# tokens, mesh, whether the CPU twin runs)
# tinyllama's cell also runs (a''), the FSDP cell (``fsdp_cell``) against
# its split step on the card (the last entry)
TP_STEPS = (("a", "tinyllama-1.1b", 2, 8, 512, (1, 2, 2), True, True),
            ("a'", "recurrentgemma-9b", 3, 2, 4096, (1, 2, 2), False,
             False))
# (b)-(d) split serving against the unsharded served path on the card:
# (label, arch, bf16, layers (0: the config's), batch, prompt, steps,
# model ways).  (b) tinyllama-1.1b at full width and depth in f32; (c)
# deepseek-v2-236b at full width, its depth cut 60 -> 2 (1 mla_dense and
# 1 mla_moe: 10.4 GB whole in bf16, past it the two copies would not
# fit beside each other), a prompt past attn_chunk; (d) llama3-405b at
# full width, its depth cut 126 -> 1 (7.4 B parameters, 14.8 GB in bf16)
# over the width of the reference's production model axis (16).  The
# caches hold the prompt and the steps, rounded up to a multiple of 16
# so that the sequence split divides.
# (e)-(g), at full width and depth in bf16 over model 2: (e)
# mamba2-1.3b, 8 x 2048, 16 steps (32 of 64 heads a shard, no flash
# launch); (f) recurrentgemma-9b, 1 x 4096 (twice the window: the ring
# wraps), 16 steps (2048 of 4096 LRU channels and 8 of 16 gate blocks a
# shard, half the MQA head's columns all-gathered, the ring split by
# sequence); (g) whisper-large-v3, 8 x (1500 frames + 64 tokens), 16
# steps (10 of 20 heads a shard, the cross cache by heads).  A last
# True: the cell's gate is held in f32 (``tp_serve_cell``'s
# ``f32_gate``): mamba2's 48 SSM layers in bf16 drift 0.25-0.97 logits
# apart on two paths of the same sums (rounded in other places: the
# split's two K = 2048 ``w_out`` partials against one K = 4096 product),
# 7x phase 14's bf16 gate, where the same cell in f32 agrees at 0.07 of
# LM_TOL (PERF.md §6); its bf16 split is then held no farther from the
# f32 logits than SSM_DRIFT_RATIO times the unsplit bf16 path, and (e')
# holds the bf16 split at the bf16 gate at 1 layer: from 2 layers on the
# whole model in bf16 drifts past that gate, split or not (0.45-1.32 of
# it at 2 layers, 0.22-0.23 at 1, over 8 seeds on an H100,
# scripts/ssm_bf16_drift.py): a layer's rounding differences grow
# through the next.
TP_SERVE = (("b", "tinyllama-1.1b", False, 0, 8, 512, 8, 2),
            ("c", "deepseek-v2-236b", True, 2, 1, 2048, 8, 2),
            ("d", "llama3-405b", True, 1, 1, 2048, 4, 16),
            ("e", "mamba2-1.3b", True, 0, 8, 2048, 16, 2, True),
            ("e'", "mamba2-1.3b", True, 1, 8, 2048, 16, 2),
            ("f", "recurrentgemma-9b", True, 0, 1, 4096, 16, 2),
            ("g", "whisper-large-v3", True, 0, 8, 64, 16, 2))
# (e)'s limit on its bf16 split's distance from the f32 logits, as a
# multiple of the unsplit bf16 path's: the ratio read 0.92-1.12 over 8
# seeds at each of 1, 2, 4, 8 and 48 layers (0.95-1.08 at 48) on an H100
# (scripts/ssm_bf16_drift.py; PERF.md §6); the limit doubles the largest
# excess over 1
SSM_DRIFT_RATIO = 1.25
# (h) ICQ-KV's decode split: phase 14's cell "LM A, ICQ-KV"
# (tinyllama-1.1b f32, 8 x 512, d_fast 16, top_c 128, 32 steps) over
# model 2 (by KV heads: 2 of 4 a shard) and model 8 (by positions: 68 of
# the cache's 544 a shard, so that each shard's local top-c keeps all of
# its positions), and over model 8 at a 2048-token prompt and 8 steps
# (257 of 2056 positions a shard: each shard's local top-c truncates),
# each against the unsplit ICQ-KV step fed the
# same tokens: each layer's global survivors equal as sets wherever the
# crude gap at rank top_c exceeds the crude bound; logits within LM_TOL
# of the largest, greedy tokens equal wherever the top-2 gap exceeds it.
# The crude bound (over the row's largest sum of |q_f k_f|,
# ``kv_cache._crude_gap``): the two paths' appended keys come from other
# GEMMs, rounded otherwise, and their bf16 ``k_fast`` may land one
# rounding step apart (2^-7 of a product at most); a swap needs the gap
# below twice that, plus q's own difference (LM_TOL): 2^-6 + 2 LM_TOL.
# The top-c is discontinuous: a batch row whose survivor set differs at
# such a near tie attends over another candidate, so its logits and
# tokens are reported, not gated (the rows and steps are printed); each
# step starts both paths from the unsplit step's caches, so that no
# difference carries over.  At most FLIPS_PER_POSITION times the cache's
# positions of the survivor sets may differ (2% at 544, 7.6% at 2056):
# near rank 128 the crude scores lie close, the closer the more
# positions a row holds, and the two paths' queries differ in their last
# bits (the split's GEMMs and all-reduces round otherwise), so such near
# ties recur (0.40-0.47% of the sets at 544 positions, 1.97% at 2056, on
# an H100, PERF.md §6), where a wrong merge or offset would change
# nearly every set.  The sets whose crude gap lies within the bound (the
# ones that may differ) are counted and printed.
# Besides, the merge itself is gated: each path records
# its global crude scores (``kv_cache`` ``record=``: the split step's
# every shard's scores of its positions), the split's survivors must be
# the top-c of its own scores in ``_top_c``'s order, bit for bit, and the
# two paths' scores must lie within a score's rounding, half the crude
# bound: SCORE_BOUND of the row's largest sum of |q_f k_f|, in each batch
# row whose survivors agreed in every earlier layer of the step (one
# that differed attends over another candidate from there on).
TP_ICQ = dict(batch=8, runs=((512, 32, (2, 8)), (2048, 8, (8,))))
CRUDE_BOUND = 2.0 ** -6 + 2 * LM_TOL
SCORE_BOUND = CRUDE_BOUND / 2
FLIPS_PER_POSITION = 0.02 / 544


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def position_bytes(placed, pos) -> int:
    """The bytes one mesh position holds of a placed tree."""
    from repro_torch.distributed import sharding as shrules
    return sum(st.shards[pos].numel() * st.shards[pos].element_size()
               for (st,) in shrules.zip_leaves(placed))


def tp_train_gate(seed: int, card: str, label, arch, layers, rows, tokens,
                  mesh_shape, cpu_twin, with_fsdp):
    """Phase 17 (a) and (a'): the split train step on the card against
    the unsharded step on the card and, where ``cpu_twin``, the split
    step on the CPU (the comment above TP_STEPS); with ``with_fsdp``
    (a''), the FSDP cell against the split step on the card.  Returns
    the launches on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shrules
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.launch.steps import build_train_step
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    names = ("pod", "data", "model")
    toks = np.random.default_rng(seed + 1701).integers(
        0, cfg.vocab_size, (1, rows, tokens), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}
    card_params = lm_params(cfg, seed)
    cpu_params = cpu_tree(card_params)
    step0, _, _, init0 = build_train_step(cfg, n_micro=1)
    # the unsharded step's result waits on the host: the split step
    # needs the room (at (a')'s 6.6 GB of f32 params, each step's
    # params and moments are 20 GB)
    plain = cpu_tree(step0(card_params, init0(card_params), batch))
    zero = tuple("/".join(p) for p in _leaf_paths(cpu_params)
                 if not bool(_at_path(cpu_params, p).any()))
    outs, launches, secs, ratios = {}, {}, {}, {}
    for dev in ("cuda", "cpu") if cpu_twin else ("cuda",):
        mesh = make_mesh_auto(mesh_shape, names, devices=dev)
        step, _, _, init = build_train_step(cfg, n_micro=1, multi_pod=True,
                                            mesh=mesh)
        params = card_params if dev == "cuda" else cpu_params
        placed = tp.place(params, mesh)
        state = init(placed)
        if dev == "cuda":
            want = shrules.shard_bytes(params,
                                       shrules.model_shardings(params, mesh))
            held = [position_bytes(placed, (0, 0, j))
                    for j in range(mesh_shape[2])]
            cards = len(set(mesh.devices.flat))
            log(f"phase 17 ({label}) parameter bytes a model shard: {held}, "
                f"shard_bytes of the model-only specs {want} (whole: "
                f"{tree_bytes(params)})")
            check(all(h == want for h in held),
                  f"split params hold {held} bytes a shard, the rule table "
                  f"{want}")
            whole = card_params if with_fsdp else None
            del params, card_params
            out, secs[dev], peak, launches = timed_step(step, placed, state,
                                                        batch)
        else:
            t1 = time.perf_counter()
            out = step(placed, state, batch)
            secs[dev] = time.perf_counter() - t1
        outs[dev] = (tp.gather(out[0]), dict(out[1], m=tp.gather(
            out[1]["m"]), v=tp.gather(out[1]["v"])), out[2])
        del out, placed, state
        if dev == "cuda":        # against the unsharded step, then drop it
            ratios.update(plain_step_ratios(outs["cuda"], plain,
                                            "unsharded", zero))
            m0 = plain[2]
            del plain
    shards = mesh_shape[1] * mesh_shape[2]
    want = {k: 0 for k in launches}
    for k, n in train_flash_launches(cfg, 1).items():
        want[k] = shards * n
    mc = outs["cuda"][2]
    loss_u = abs(float(mc["loss"]) - float(m0["loss"])) / abs(
        float(m0["loss"]))
    loss_c, cpu_line = 0.0, "no CPU twin"
    if cpu_twin:
        mp = outs["cpu"][2]
        loss_c = abs(float(mc["loss"]) - float(mp["loss"])) / abs(
            float(mp["loss"]))
        ratios.update(plain_step_ratios(outs["cuda"], outs["cpu"], "CPU",
                                        zero))
        cpu_line = (f"CPU {float(mp['loss'])!r} (rel {loss_c:.3e}), gnorm "
                    f"{float(mp['gnorm'])!r}; the CPU's step "
                    f"{secs['cpu']:.1f} s")
    log(f"phase 17 ({label}) split train step {arch} f32 {cfg.num_layers} "
        f"layers, mesh {mesh_shape} {names} on {cards} card(s), "
        f"{rows} x "
        f"{tokens} ({rows // mesh_shape[1]} rows a data shard): loss "
        f"{float(mc['loss'])!r}, unsharded {float(m0['loss'])!r} (rel "
        f"{loss_u:.3e}), tolerance 1e-5; gnorm {float(mc['gnorm'])!r}, "
        f"unsharded {float(m0['gnorm'])!r}; {cpu_line}; worst leaf a "
        "gate, its ratio to the bound: "
        + ", ".join(f"{k} {n} {r:.4f}" for k, (r, n) in ratios.items())
        + (f" (params of the leaves that start at zero, {list(zero)}, "
           "held on m and v: plain_step_ratios)" if zero else "")
        + f"; launches {launches} (want {want}); the split step "
        f"{secs['cuda']:.2f} s on the card (its first call); "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    check(loss_u <= 1e-5 and loss_c <= 1e-5,
          f"split train step ({label}) loss {float(mc['loss'])}")
    bad = {k: v for k, v in ratios.items() if not v[0] <= 1.0}
    check(not bad, f"split train step ({label}): {bad}")
    check(launches == want, f"split train step ({label}) launches "
                            f"{launches}")
    if with_fsdp:
        mesh = make_mesh_auto(mesh_shape, names, devices="cuda")
        fsdp_launches, *_ = fsdp_cell(
            f"17 ({label}'')", cfg, mesh, whole, batch,
            (outs["cuda"], secs["cuda"], peak), want, card)
        launches = {k: n + fsdp_launches[k] for k, n in launches.items()}
    return launches


def served_run(prefill, decode, params, batch, max_len, toks):
    """A prefill and a decode step for each of ``toks`` (the feed), each
    timed by CUDA events: (logits of each stage, prefill ms, ms a step,
    peak bytes above the params)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, caches = prefill(params, batch, max_len)
    ev[1].record()
    out = [logits[:, -1].float()]
    for tok in toks:
        logits, caches = decode(params, tok, caches)
        out.append(logits[:, -1].float())
    ev[2].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del caches
    return (out, ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / max(len(toks), 1), peak)


def split_logit_gate(what, got, want, tol) -> float:
    """Each stage's split logits within ``tol`` of the largest |logit| of
    the unsplit ones, greedy tokens equal wherever the unsplit top-2 gap
    exceeds that bound.  Returns the worst error over its bound."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        bound = tol * max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        worst = max(worst, err / bound)
        top2 = w.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = g.argmax(-1) == w.argmax(-1)
        check(err <= bound, f"phase 17 {what} stage {i}: split logits "
                            f"{err} from the unsharded (bound {bound})")
        bad = ~same & (gap > bound)
        check(not bool(bad.any()),
              f"phase 17 {what}: greedy token differs at stage {i} where "
              f"the top-2 gap {gap[bad].tolist()} exceeds {bound}")
    return worst


def greedy_feed(prefill, decode, params, batch, max_len, steps):
    """The greedy tokens of ``steps`` decode steps after a prefill: the
    feed both paths of a cell take."""
    import torch
    logits, caches = prefill(params, batch, max_len)
    feed = []
    for _ in range(steps):
        feed.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
        logits, caches = decode(params, feed[-1], caches)
    return feed


def f32_twin(arch, layers, params, mesh, batch, max_len, feed):
    """The same weights in f32, served split over ``mesh`` and unsplit
    on ``feed``: (split logits, unsplit logits) of each stage."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.steps import build_serve_fns
    cfg32 = lm_config(arch, False, layers)
    p32 = tree_apply(lambda t: t.float(), params)
    pre_u, dec_u, _ = build_serve_fns(cfg32)
    pre_s, dec_s, _ = build_serve_fns(cfg32, mesh=mesh)
    ref = served_run(pre_u, dec_u, p32, batch, max_len, feed)[0]
    got = served_run(pre_s, dec_s, tp.place(p32, mesh), batch, max_len,
                     feed)[0]
    return got, ref


def max_dist(xs, ys) -> float:
    """The largest |x - y| over the stages' logits."""
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


def logit_ratio(got, want, tol) -> float:
    """The worst stage's largest |got - want| over ``tol`` of its
    largest |want| (``split_logit_gate``'s bound), not gated."""
    return max(float((g - w).abs().max()) / (tol * max(
        1.0, float(w.abs().max()))) for g, w in zip(got, want))


def bf16_drift(seed, arch, layers, b, s, steps, M):
    """One cell in bf16 split over (model M) against its unsplit path,
    and both against the same weights in f32 unsplit (``f32_twin``), on
    the unsplit path's greedy feed: (bf16 split against unsplit over
    TOL_BF16's bound, the bf16 split's largest logit distance from f32,
    the unsplit's, the f32 split against unsplit over LM_TOL's bound).
    ``scripts/ssm_bf16_drift.py`` reads it over seeds and depths."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.launch.serve import lm_batch
    from repro_torch.launch.steps import build_serve_fns
    cfg = lm_config(arch, True, layers)
    mesh = make_mesh_auto((M,), ("model",))
    params = lm_params(cfg, seed)
    batch = lm_batch(cfg, b, s, seed)
    max_len = -(-(s + steps) // 16) * 16
    prefill0, decode0, _ = build_serve_fns(cfg)
    prefill1, decode1, _ = build_serve_fns(cfg, mesh=mesh)
    feed = greedy_feed(prefill0, decode0, params, batch, max_len, steps)
    want = served_run(prefill0, decode0, params, batch, max_len, feed)[0]
    got = served_run(prefill1, decode1, tp.place(params, mesh), batch,
                     max_len, feed)[0]
    got32, ref = f32_twin(arch, layers, params, mesh, batch, max_len, feed)
    return (logit_ratio(got, want, TOL_BF16), max_dist(got, ref),
            max_dist(want, ref), logit_ratio(got32, ref, LM_TOL))


def tp_serve_cell(seed, card, label, arch, bf16, layers, b, s, steps, M,
                  f32_gate=False, profile_dir=None):
    """Phase 17 (b)-(g): one cell split over (model M) against the
    unsharded served path from the same params, both fed the unsharded
    path's greedy tokens: logits within phase 14's gate (LM_TOL in f32,
    TOL_BF16 in bf16) of the largest, greedy tokens equal wherever the
    unsharded top-2 gap exceeds it (``split_logit_gate``); the split
    prefill's flash launches (each shard's heads: M an attention call,
    an MLA layer past attn_chunk M a block pair).  With ``f32_gate`` (a
    bf16 cell too deep for phase 14's bf16 gate: its bf16 rounding
    grows over the layers, on either path) the same weights also serve
    in f32, split and unsplit on the same feed, at LM_TOL, and the bf16
    split may be no farther from the f32 logits than SSM_DRIFT_RATIO
    times the unsplit bf16 path.  With ``profile_dir``, both paths'
    prefill and steps under ``profile_lm`` after the gates.  Returns the
    split run's launches."""
    from repro_torch.distributed import sharding as shrules
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.launch.serve import lm_batch
    from repro_torch.launch.steps import build_serve_fns
    t0 = time.perf_counter()
    cfg = lm_config(arch, bf16, layers)
    mesh = make_mesh_auto((M,), ("model",))
    params = lm_params(cfg, seed)
    placed = tp.place(params, mesh)
    rule = shrules.shard_bytes(params, shrules.model_shardings(params, mesh))
    held = [position_bytes(placed, (j,)) for j in range(M)]
    check(all(h == rule for h in held),
          f"phase 17 ({label}) {arch}: split params hold {held} bytes a "
          f"shard, the rule table {rule}")
    batch = lm_batch(cfg, b, s, seed)
    max_len = -(-(s + steps) // 16) * 16
    tol = TOL_BF16 if bf16 else LM_TOL
    prefill0, decode0, _ = build_serve_fns(cfg)
    prefill1, decode1, model1 = build_serve_fns(cfg, mesh=mesh)
    feed = greedy_feed(prefill0, decode0, params, batch, max_len, steps)
    want, pre0, step0, peak0 = served_run(prefill0, decode0, params, batch,
                                          max_len, feed)
    served_run(prefill1, decode1, placed, batch, max_len, feed[:1])  # warm
    reset_launches()
    got, pre1, step1, peak1 = served_run(prefill1, decode1, placed, batch,
                                         max_len, feed)
    launches = read_launches()
    n_pre = prefill_flash_launches(cfg, s) * M
    if f32_gate:
        got32, ref = f32_twin(arch, layers, params, mesh, batch, max_len,
                              feed)
        worst32 = split_logit_gate(f"({label}) {arch} f32", got32, ref,
                                   LM_TOL)
        del got32
        d_u, d_s = max_dist(want, ref), max_dist(got, ref)
        lim = SSM_DRIFT_RATIO * d_u
        worst = logit_ratio(got, want, tol)
        log(f"phase 17 ({label}) {arch}: the same weights in f32, split "
            f"against unsplit on the bf16 feed: worst logit error / bound "
            f"{worst32:.4f} (bound {LM_TOL:g} of the largest |logit|); "
            f"bf16 against the f32 logits: split {d_s:.4f}, unsplit "
            f"{d_u:.4f}, ratio {d_s / d_u:.4f} (gate: split <= {lim:.4f}, "
            f"SSM_DRIFT_RATIO {SSM_DRIFT_RATIO:g} times the unsplit's); "
            f"bf16 split against bf16 unsplit {worst:.4f} of the bf16 "
            f"gate (reported; (e') gates it at 1 layer)")
        check(d_s <= lim, f"phase 17 ({label}) {arch}: bf16 split logits "
                          f"{d_s} from the f32 ones, unsplit {d_u}")
    else:
        worst = split_logit_gate(f"({label}) {arch}", got, want, tol)
    log(f"phase 17 ({label}) split serving {arch} "
        f"{'bf16' if bf16 else 'f32'} {cfg.num_layers} layers over (model "
        f"{M}) on {len(set(mesh.devices.flat))} card(s), batch {b}, prompt "
        f"{s}, {steps} greedy steps "
        f"(cache {max_len}): worst logit error / bound {worst:.4f} (bound "
        f"{tol:g} of the largest |logit|); prefill {pre1:.2f} ms split, "
        f"{pre0:.2f} ms unsharded; {step1:.2f} ms a step split, {step0:.2f} "
        f"ms unsharded; peak above the params {peak1 / 2**20:.1f} MiB split, "
        f"{peak0 / 2**20:.1f} MiB unsharded; split params "
        f"{held[0] / 2**30:.2f} GiB a shard ({held[0]} B each, = "
        f"shard_bytes) of {tree_bytes(params) / 2**30:.2f} GiB; flash launches "
        f"{launches['flash_attention']} (want {n_pre} "
        f"= {M} an attention call{' a block pair' if cfg.mla else ''}); "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    check(launches["flash_attention"] == n_pre,
          f"phase 17 ({label}) flash launches {launches['flash_attention']}"
          f" (want {n_pre})")
    check(model1.split, f"phase 17 ({label}) {arch} did not split")
    if profile_dir:
        for tag, m, p in (("split", mesh, placed), ("unsplit", None, params)):
            profile_lm(f"17{label}_{tag}", cfg, p, batch, max_len,
                       profile_dir, mesh=m)
    return launches


def tp_icq_cell(seed, card):
    """Phase 17 (h): ICQ-KV's decode split by KV heads and by positions
    against the unsplit ICQ-KV step (the comment above TP_ICQ).  Returns
    no launch (ICQ-KV runs no hand-written kernel)."""
    cfg = lm_config("tinyllama-1.1b", False)
    params = lm_params(cfg, seed)
    b = TP_ICQ["batch"]
    for s, steps, models in TP_ICQ["runs"]:
        tp_icq_run(seed, card, cfg, params, b, s, steps, models)
    return {k: 0 for k in read_launches()}


def tp_icq_run(seed, card, cfg, params, b, s, steps, models):
    """Phase 17 (h) at one prompt length ``s``: ``steps`` decode steps
    split over (model M) for each M of ``models``, each against the
    unsplit ICQ-KV step (``tp_icq_cell``)."""
    import numpy as np
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.launch.serve import (icq_caches_from_prefill,
                                          icq_kv_geometry, lm_batch)
    from repro_torch.models import build_model
    from repro_torch.quant.kv_cache import _top_c
    from repro_torch.quant.serve_icq import build_icq_decode
    t0 = time.perf_counter()
    max_len = s + steps
    kv_cfg, top_c = icq_kv_geometry(cfg, max_len)
    logits, dense = build_model(cfg).prefill(params, lm_batch(cfg, b, s,
                                                               seed),
                                             max_len)
    tok0 = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    del logits
    step0, _ = build_icq_decode(cfg, kv_cfg)
    for M in models:
        mesh = make_mesh_auto((M,), ("model",))
        step1, _ = build_icq_decode(cfg, kv_cfg, mesh=mesh)
        placed = tp.place(params, mesh)
        step1(placed, tok0, icq_caches_from_prefill(kv_cfg, dense, s,
                                                    max_len),
              top_c=top_c)                                    # warm
        # each step from the same caches: the split step takes the
        # unsplit step's (laid out anew, a copy), so that a difference
        # is the step's own and none carries over
        cache = icq_caches_from_prefill(kv_cfg, dense, s, max_len)
        worst, sets, flips, near, feed, flipped = 0.0, 0, 0, 0, [tok0], {}
        top_gap, worst_drift = 0.0, 0.0
        for i in range(steps):
            rec1, rec0 = [], []
            g, _ = step1(placed, feed[-1], cache, top_c=top_c, record=rec1)
            w, cache = step0(params, feed[-1], cache, top_c=top_c,
                             record=rec0)
            g, w = g[:, -1].float(), w[:, -1].float()
            rows = torch.zeros(b, dtype=torch.bool, device=tok0.device)
            for li, ((cand, _, scores, _), (pcand, gap, pscores, mag)) in \
                    enumerate(zip(rec1, rec0)):
                own = torch.equal(cand, _top_c(scores, top_c))
                # a row whose survivors differed in an earlier layer of
                # this step attends otherwise from there on: held from
                # the next step
                drift = ((scores - pscores).abs().amax(-1)
                         / torch.clamp(mag, 1e-30)).flatten(1).amax(1)
                drift = float(drift[~rows].max()) if bool(
                    (~rows).any()) else 0.0
                worst_drift = max(worst_drift, drift)
                check(own, f"phase 17 (h) model {M} step {i} layer {li}: "
                           "the split survivors are not the top-c of the "
                           "split step's own crude scores")
                check(drift <= SCORE_BOUND,
                      f"phase 17 (h) model {M} step {i} layer {li}: crude "
                      f"scores {drift:.3e} of the row's scale apart (bound "
                      f"{SCORE_BOUND:g})")
                eq = (torch.sort(cand, -1).values
                      == torch.sort(pcand, -1).values).all(-1)
                if not bool(eq.all()):
                    top_gap = max(top_gap, float(gap[~eq].max()))
                check(bool((eq | (gap <= CRUDE_BOUND)).all()),
                      f"phase 17 (h) model {M} step {i} layer {li}: global "
                      f"survivors differ where the crude gap exceeds the "
                      f"crude bound {CRUDE_BOUND:g}: gaps "
                      f"{gap[~eq].tolist()[:8]}")
                sets += eq.numel()
                flips += int((~eq).sum())
                near += int((gap <= CRUDE_BOUND).sum())
                rows |= (~eq).flatten(1).any(1)
            if bool(rows.any()):
                flipped[i] = rows.nonzero().flatten().tolist()
            keep = ~rows
            bound = LM_TOL * max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max(-1).values[keep].max()) \
                if bool(keep.any()) else 0.0
            worst = max(worst, err / bound)
            top2 = w.topk(2, dim=-1).values
            same = g.argmax(-1) == w.argmax(-1)
            check(err <= bound, f"phase 17 (h) model {M} step {i}: split "
                                f"ICQ-KV logits {err} from the unsplit "
                                f"(bound {bound})")
            check(bool((same | (top2[:, 0] - top2[:, 1] <= bound)
                        | rows).all()),
                  f"phase 17 (h) model {M} step {i}: greedy token differs")
            feed.append(w.argmax(-1).to(torch.int32)[:, None])
        cap = FLIPS_PER_POSITION * max_len
        check(flips <= cap * sets,
              f"phase 17 (h) model {M}: {flips} of {sets} survivor sets "
              f"differ (at most {cap:.2%})")
        del cache, rec0, rec1
        med, peak = {}, {}
        for k, (step, p) in enumerate(((step0, params),
                                       (step1, placed))):  # timed
            c = icq_caches_from_prefill(kv_cfg, dense, s, max_len)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
            ev[0].record()
            for i in range(steps):
                _, c = step(p, feed[i], c, top_c=top_c)
                ev[i + 1].record()
            torch.cuda.synchronize()
            med[k] = float(np.median([ev[i].elapsed_time(ev[i + 1])
                                      for i in range(steps)]))
            peak[k] = (torch.cuda.max_memory_allocated() - base) / 2**20
            del c
        split_by = ("heads" if cfg.num_kv_heads % M == 0 else "positions")
        log(f"phase 17 (h) ICQ-KV decode split over (model {M}) by "
            f"{split_by}, tinyllama-1.1b f32, batch {b}, cache {max_len}, "
            f"d_fast {kv_cfg.d_fast}, top_c {top_c}, {steps} steps: worst "
            f"logit error / bound {worst:.4f} (bound {LM_TOL:g} of the "
            f"largest |logit|; each step from the unsplit step's caches, "
            f"the rows whose survivors all agreed in it); {flips} of "
            f"{sets} survivor sets differ (gate: at most {cap:.2%} of them, "
            f"each at a crude gap within the crude bound {CRUDE_BOUND:g}, "
            f"which {near} sets' gaps lie within; "
            f"the largest such gap {top_gap:.3e}; (step: rows) "
            f"{flipped or 'none'}); every split set the top-c of its own "
            f"crude scores bit for bit, the two paths' scores at most "
            f"{worst_drift:.3e} of their row's scale apart (bound "
            f"{SCORE_BOUND:g}; a row from the layer after its survivors "
            f"differ to the step's end not held); "
            f"{med[1]:.2f} ms a step split, {med[0]:.2f} ms unsplit "
            f"(median, CUDA events); peak above the params and caches "
            f"{peak[1]:.1f} MiB split, {peak[0]:.1f} MiB unsplit; "
            f"{time.perf_counter() - t0:.1f} s; {card}")
        del placed


def tensor_parallelism(seed: int, card: str, profile_dir=None):
    """Phase 17: (a) and (a') the split train steps, (b)-(g) split
    serving (with ``profile_dir``, each cell's split and unsplit path
    profiled), (h) ICQ-KV's split decode.  Returns the launches."""
    import gc
    import torch
    t0 = time.perf_counter()
    total = {k: 0 for k in read_launches()}
    for cell in TP_STEPS:
        t1 = time.perf_counter()
        for k, n in tp_train_gate(seed, card, *cell).items():
            total[k] += n
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 17 ({cell[0]}) ran {time.perf_counter() - t1:.1f} s")
    for cell in TP_SERVE:
        t1 = time.perf_counter()
        for k, n in tp_serve_cell(seed, card, *cell,
                                  profile_dir=profile_dir).items():
            total[k] += n
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 17 ({cell[0]}) ran {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    tp_icq_cell(seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 17 (h) ran {time.perf_counter() - t1:.1f} s")
    log(f"phase 17 ran {time.perf_counter() - t0:.1f} s")
    return total


# ----------------------------------- phase 18: filter= and refine_cap ----

# the filters of phase 18 over the n rows, drawn from --seed: half the
# rows, one in a hundred, the first 50,000 rows, and 60 rows (fewer than
# topk: the bootstrap's +inf slots)
FILTERS = ("bernoulli-0.5", "bernoulli-0.01", "block-50000", "rows-60")
CAPS = (400, 1000)
# (name, artifact, overrides) of the engines phase 18 serves at
# serve.backend = "jnp"
JNP_CELLS = (("two-step-f32", "two-step-f32", {}),
             ("two-step-int8", "two-step-int8", {}),
             ("two-step-int8-4bit", "two-step-int8-4bit", {}),
             ("flat-f32", "flat-f32", {}),
             ("ivf-f32", "ivf-f32", {}),
             ("ivf-int8", "ivf-f32", {"serve.lut_dtype": "int8"}))
JNP = {"serve.backend": "jnp"}


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def make_filters(seed: int, n: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed + 41)
    rows = np.zeros(n, bool)
    rows[rng.choice(n, 60, replace=False)] = True
    return {"bernoulli-0.5": rng.random(n) < 0.5,
            "bernoulli-0.01": rng.random(n) < 0.01,
            "block-50000": np.arange(n) < 50_000,
            "rows-60": rows}


def plain_jnp(index, q, pred=None, *, refine_cap=None, crude_only=False):
    """The jnp engine's search composed by hand from the plain versions on
    the same CUDA tensors: the filtered crude (``pred``), the bootstrap
    over its top-k (the jnp rule under ``pred`` or ``refine_cap``, the
    fused engine's otherwise, as the engine composes it), then the
    refine, or the survivor selection and re-rank (``refine_cap``), or
    nothing (``crude_only``).
    Returns (ids, distances, pass_rate as the engine folds the pass
    counts, or None for a single-phase search)."""
    import torch
    from repro_torch.index.base import build_lut, mask_filtered_ids
    from repro_torch.index.flat import FlatADC
    from repro_torch.index.ivf import (IVFTwoStep, coarse_probe,
                                       gather_candidates)
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands,
                                            full_lut_operand,
                                            slow_lut_operand)
    quant = index.lut_dtype == "int8"
    bits, topk = index.code_bits, index.topk
    luts = build_lut(q, index.C)
    flat_adc = isinstance(index, FlatADC)
    fast = None if flat_adc else index.structure.fast_mask
    lf, sc, of = crude_lut_operands(luts, fast, quantized=quant,
                                    code_bits=bits)
    mask = (lambda i, d: i) if pred is None else mask_filtered_ids

    def capped(codes_rows, crude, thr):
        # the slab or row positions of the cap best-crude survivors,
        # re-ranked by one full-table sum
        cap = min(max(refine_cap, topk), crude.shape[1])
        sv, surv = bs.select_topk_torch(crude, thr, cap)
        surv = surv.long()
        rows = (codes_rows[surv] if codes_rows.ndim == 2 else torch.gather(
            codes_rows, 1, surv[:, :, None].expand(-1, -1,
                                                   codes_rows.shape[2])))
        full = full_lut_operand(luts, code_bits=bits)
        dist, pos = bs.rerank_topk_torch(rows, full, torch.isfinite(sv),
                                         topk, code_bits=bits)
        return surv.gather(1, pos.long()), dist

    tstage = ThresholdStage(topk=topk, quantized=quant, code_bits=bits)
    jnp_rule = pred is not None or refine_cap is not None
    if isinstance(index, IVFTwoStep):
        probes = coarse_probe(q, index.ivf.centroids, index.n_probe)
        cand_ids, cand_codes = gather_candidates(probes, index.ivf.lists,
                                                 index.list_codes, topk)
        valid = cand_ids >= 0
        safe = torch.where(valid, cand_ids, torch.zeros_like(cand_ids))
        if pred is not None:
            valid = valid & pred[safe.long()]
            cand_ids = torch.where(valid, cand_ids,
                                   torch.full_like(cand_ids, -1))
        crude, cv, cp = bs.ivf_crude_topk_torch(cand_codes, cand_ids, lf,
                                                topk, sc, of, code_bits=bits)
        if crude_only:
            return mask(safe.gather(1, cp.long()), cv), cv, None
        bootstrap = (tstage.from_dense_slab_candidates if jnp_rule
                     else tstage.from_slab_candidates)
        thr = bootstrap(luts, cand_codes, cv, cp, fast,
                        index.structure.sigma)
        if refine_cap is None:
            slow = slow_lut_operand(luts, fast, code_bits=bits)
            dist, pos = bs.ivf_refine_topk_torch(cand_codes, slow, crude,
                                                 thr, topk, code_bits=bits)
            pos = torch.clamp(pos.long(), max=cand_ids.shape[1] - 1)
        else:
            pos, dist = capped(cand_codes, crude, thr)
        n_pass = (crude < thr[:, None]).sum(dim=1).to(torch.float32)
        n_cand = valid.sum(dim=1).to(torch.float32)
        rate = torch.mean(n_pass) / torch.clamp_min(torch.mean(n_cand), 1.0)
        return mask(safe.gather(1, pos), dist), dist, rate
    crude, cv, ci = bs.crude_topk_torch(index.codes, lf, topk, sc, of,
                                        code_bits=bits, pred=pred)
    if flat_adc or crude_only:
        return mask(ci, cv), cv, None
    bootstrap = (tstage.from_dense_candidates if jnp_rule
                 else tstage.from_candidates)
    thr = bootstrap(luts, index.codes, cv, ci, fast, index.structure.sigma)
    if refine_cap is None:
        slow = slow_lut_operand(luts, fast, code_bits=bits)
        dist, idx = bs.refine_topk_torch(index.codes, slow, crude, thr, topk,
                                         code_bits=bits)
    else:
        idx, dist = capped(index.codes, crude, thr)
    pf = (crude < thr[:, None]).sum(dim=1).to(torch.float32) / crude.shape[1]
    return mask(idx, dist), dist, torch.mean(pf)


def filtered_kernels(seed: int, n: int, filters: dict, card: str):
    """Phase 18 (a): the row-predicate crude instance, the survivor
    selection and the re-rank at the main path's shapes against their
    plain versions bit for bit, timed beside the unfiltered crude and
    refine, with bounds that count the predicate's bytes and only the
    work this run's data needs.  Returns their kernel records."""
    import torch
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands)
    K, d = SIFT["K"], SIFT["d"]
    codes, luts, fast = problem(seed + 100, n, TILE, K, SIFT["m"], d,
                                SIFT["num_fast"], dup=False)
    lf, _, _ = crude_lut_operands(luts, fast, quantized=False)
    lq, sc, of = crude_lut_operands(luts, fast, quantized=True)
    codes4, luts4, fast4 = problem(seed + 200, n, TILE, 16, 16, d, 4,
                                   dup=False)
    packed = stored_codes(codes4, 16, 4)
    lq4, sc4, of4 = crude_lut_operands(luts4, fast4, quantized=True,
                                       code_bits=4)
    records = {}
    base_ms = time_ms(lambda: bs.crude_topk_cuda(codes, lf, TOPK), 10)
    for fname, mask in filters.items():
        pred = torch.from_numpy(mask).cuda()
        for label, args, kw in (
                ("f32 8-bit", (codes, lf, TOPK), {}),
                ("int8 8-bit", (codes, lq, TOPK, sc, of), {}),
                ("int8 4-bit K=16 m=16", (packed, lq4, TOPK, sc4, of4),
                 {"code_bits": 4})):
            got = bs.crude_topk_cuda(*args, pred=pred, **kw)
            want = bs.crude_topk_torch(*args, pred=pred, **kw)
            check(equal_outputs(got, want), f"crude_topk_pred {label} "
                  f"{fname} != its plain version")
        kept = int(mask.sum())
        ms = time_ms(lambda: bs.crude_topk_cuda(codes, lf, TOPK, pred=pred),
                     10)
        got = bs.crude_topk_cuda(codes, lf, TOPK, pred=pred)
        inf_slots = int(torch.isinf(got[1]).sum())
        log(f"kernel crude_topk_pred f32 8-bit nq={TILE} n={n} filter "
            f"{fname} ({kept} rows kept): {ms:.4f} ms, unfiltered "
            f"{base_ms:.4f} ms; +inf slots {inf_slots}; equal to the plain "
            f"version bit for bit (f32, int8, int8 4-bit); {card}")
        if fname == "bernoulli-0.5":
            plain_ms = time_ms(lambda: bs.crude_topk_torch(
                codes, lf, TOPK, pred=pred), 3)
            # codes, LUTs, the predicate's byte a row, the dense crude
            # matrix written, the lists; K adds for each kept pair
            nbytes = codes.numel() + lf.numel() * 4 + n + TILE * n * 4 \
                + TILE * TOPK * 8
            b_ms, b_by = bound_ms(nbytes, TILE * kept * K)
            records["crude_topk_pred"] = dict(
                name="crude_topk_pred", route="cuda",
                source="src/repro_torch/kernels/csrc/search_common.cuh",
                replaces="src/repro/kernels/batched_search.py:168",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
    crude, cv, ci = bs.crude_topk_cuda(codes, lf, TOPK)
    thr = ThresholdStage(topk=TOPK).from_dense_candidates(
        luts, codes, cv, ci, fast, torch.tensor(SIGMA, device="cuda"))
    survivors = int((crude < thr[:, None]).sum())
    full = luts.reshape(TILE, -1)
    for cap in CAPS + (TOPK,):
        got = bs.select_topk_cuda(crude, thr, cap)
        want = bs.select_topk_torch(crude, thr, cap)
        check(equal_outputs(got, want), f"select_topk cap {cap} != its "
              "plain version")
        surv = got[1].long()
        rows = codes[surv].contiguous()
        valid = torch.isfinite(got[0])
        rr = bs.rerank_topk_cuda(rows, full, valid, TOPK)
        check(equal_outputs(rr, bs.rerank_topk_torch(rows, full, valid,
                                                     TOPK)),
              f"rerank_topk cap {cap} != its plain version")
        s_ms = time_ms(lambda: bs.select_topk_cuda(crude, thr, cap), 10)
        r_ms = time_ms(lambda: bs.rerank_topk_cuda(rows, full, valid, TOPK),
                       10)
        log(f"kernel select_topk nq={TILE} n={n} cap={cap} sigma={SIGMA} "
            f"survivors={survivors} ({survivors / TILE:.1f} per query): "
            f"{s_ms:.4f} ms; rerank_topk over the {cap} survivors' rows: "
            f"{r_ms:.4f} ms; both equal to their plain versions bit for "
            f"bit; {card}")
        if cap == CAPS[0]:
            s_plain = time_ms(lambda: bs.select_topk_torch(crude, thr, cap),
                              3)
            r_plain = time_ms(lambda: bs.rerank_topk_torch(rows, full, valid,
                                                           TOPK), 3)
            # the crude matrix and thresholds read, the lists written;
            # one compare a pair
            b_ms, b_by = bound_ms(TILE * n * 4 + TILE * 4 + TILE * cap * 8,
                                  TILE * n)
            records["select_topk"] = dict(
                name="select_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/search_common.cuh",
                replaces="src/repro/kernels/batched_search.py:441",
                max_abs_err=0.0, ms=s_ms, plain_ms=s_plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
            # the survivors' rows, LUTs and mask read, the top-k written;
            # K + 1 adds a valid survivor
            n_valid = int(valid.sum())
            b_ms, b_by = bound_ms(rows.numel() + full.numel() * 4
                                  + TILE * cap + TILE * TOPK * 8,
                                  n_valid * (K + 1))
            records["rerank_topk"] = dict(
                name="rerank_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/ivf_search.cu",
                replaces="src/repro/kernels/batched_search.py:390",
                max_abs_err=0.0, ms=r_ms, plain_ms=r_plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
    return records


def same_jnp(r, want) -> bool:
    """The served result against the hand composition (ids, distances,
    pass_rate): ids and distances bit for bit, so the +inf slots too,
    and the pass counts through the pass_rate they fold into."""
    import torch
    ids, dist, rate = want
    return (torch.equal(r.indices.long(), ids.long())
            and torch.equal(r.distances, dist)
            and (rate is None or torch.equal(r.pass_rate, rate)))


def jnp_cell(name, path, overrides, filters, *, seed, n, card):
    """Phase 18 (b) on one artifact at serve.backend = "jnp": unfiltered
    and under each filter, one 64-query tile (launch counts reset before,
    read after), ids / distances / +inf slots / pass counts equal to the
    plain composition on the same operands, recall@100 against
    ``ground_truth(filter=)``, ms of the tile filtered beside unfiltered.
    Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import eval as ev
    from repro_torch.index.flat import FlatADC
    from repro_torch.index.ivf import IVFTwoStep

    engine = engine_load(f"jnp-{name}", path, {**JNP, **overrides},
                         query_tile=TILE)
    index = engine.index
    db = decoded_db(index)
    check(engine.backend == "cuda-jnp", f"jnp {name}: backend "
                                        f"{engine.backend}")
    rng = np.random.default_rng(seed + 43)
    qn = rng.standard_normal((TILE, int(index.C.shape[-1])),
                             dtype=np.float32)
    q = torch.from_numpy(qn).cuda()
    ivf = isinstance(index, IVFTwoStep)
    crude_key = ("ivf_crude_topk" if ivf else "crude_topk")
    refine_key = (None if isinstance(index, FlatADC) else
                  "ivf_refine_topk" if ivf else "refine_topk")
    total = {k: 0 for k in read_launches()}
    unf_ms = time_ms(lambda: engine.search(q), 5)
    for fname in ("none",) + tuple(filters):
        mask = None if fname == "none" else filters[fname]
        pred = None if mask is None else torch.from_numpy(mask).cuda()
        engine.search(q, filter=pred)
        torch.cuda.synchronize()
        reset_launches()
        r = engine.search(q, filter=pred)
        torch.cuda.synchronize()
        launches = read_launches()
        want = {k: 0 for k in launches}
        want[crude_key + ("_pred" if pred is not None and not ivf
                          else "")] = 1
        if refine_key:
            want[refine_key] = 1
        check(launches == want, f"jnp {name} {fname}: launches "
                                f"{nonzero(launches)} != {nonzero(want)}")
        for k in total:
            total[k] += launches[k]
        same = same_jnp(r, plain_jnp(index, q, pred))
        check(same, f"jnp {name} {fname}: served != the plain composition")
        if mask is not None:
            got_ids = r.indices.cpu().numpy()
            check(bool(mask[got_ids[got_ids >= 0]].all()),
                  f"jnp {name} {fname}: a filtered row was returned")
        ms = unf_ms if pred is None else time_ms(
            lambda: engine.search(q, filter=pred), 5)
        gt, _ = ev.ground_truth(db, qn, TOPK, filter=mask)
        recall = ev.recall_at_k(r.indices.cpu().numpy(), gt, TOPK)
        log(f"jnp {name} filter {fname} "
            f"({n if mask is None else int(mask.sum())} rows): {ms:.4f} "
            f"ms a 64-query tile (events; unfiltered {unf_ms:.4f} ms), "
            f"recall@{TOPK} {recall:.4f} against ground_truth(filter=), "
            f"pass_rate {float(r.pass_rate):.6f}, +inf slots "
            f"{int(torch.isinf(r.distances).sum())}, id -1 slots "
            f"{int((r.indices < 0).sum())}; launches {nonzero(launches)}; "
            f"equal to the plain composition: {same}; {card}")
    return total


def decoded_db(index):
    """The (n, d) points the index's codes decode to, on the card."""
    from repro_torch.core.codebooks import decode
    from repro_torch.core.encode import unpack_nibbles
    K = int(index.C.shape[0])
    codes = (unpack_nibbles(index.codes, K) if index.code_bits == 4
             else index.codes)
    return decode(index.C, codes)


# the reference's refusals, word for word: its engine's (AnnEngine.search
# under the pallas backend) and its fused index's
ENGINE_FILTER_WORDS = ("filtered search requires backend='jnp' (the fused "
                       "kernels cannot mask rows by predicate)")
INDEX_FILTER_WORDS = ("filtered search requires backend='jnp' (the fused "
                      "kernels cannot mask rows by predicate; like "
                      "refine_cap, filter is a jnp-engine option)")
CAP_WORDS = ("refine_cap compaction requires backend='jnp' (the fused "
             "kernels bound phase-2 work with the in-kernel top-k merge "
             "instead)")


def raised(call) -> str:
    try:
        call()
    except ValueError as e:
        return str(e)
    return ""


def jnp_rungs(name, path, filters, *, seed, card):
    """Phase 18 (c) on one artifact at serve.backend = "jnp": the rungs
    (the capped rung offered), the crude rung filtered, the capped rung
    at each cap of ``CAPS`` through ``SearchBudget(refine_cap=)`` and
    through ``index.refine_cap`` (also filtered), each equal to the plain
    composition; the pipelined executor filtered and capped against the
    tiled engine; then the same artifact at auto refusing ``filter`` and
    ``refine_cap`` with the reference's words and offering no capped
    rung.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.index.ivf import IVFTwoStep
    from repro_torch.resilience import SearchBudget

    engine = engine_load(f"jnp-rungs-{name}", path, JNP, query_tile=TILE)
    index = engine.index
    ivf = isinstance(index, IVFTwoStep)
    want_levels = (("full", "capped", "probes", "crude") if ivf
                   else ("full", "capped", "crude"))
    check(engine._levels() == want_levels,
          f"jnp {name}: rungs {engine._levels()}")
    rng = np.random.default_rng(seed + 47)
    q = torch.from_numpy(rng.standard_normal(
        (TILE, int(index.C.shape[-1])), dtype=np.float32)).cuda()
    crude_key = "ivf_crude_topk" if ivf else "crude_topk"
    total = {k: 0 for k in read_launches()}

    def served(what, call, want_launches, want):
        call()
        torch.cuda.synchronize()
        reset_launches()
        r = call()
        torch.cuda.synchronize()
        launches = read_launches()
        expect = {k: 0 for k in launches}
        expect.update(want_launches)
        check(launches == expect, f"jnp {name} {what}: launches "
                                  f"{nonzero(launches)} != {nonzero(expect)}")
        for k in total:
            total[k] += launches[k]
        same = same_jnp(r, want)
        check(same, f"jnp {name} {what}: served != the plain composition")
        ms = time_ms(call, 5)
        log(f"jnp {name} {what}: {ms:.4f} ms a 64-query tile (events), "
            f"rung {r.meta.level_name}, pass_rate {float(r.pass_rate):.6f},"
            f" +inf slots {int(torch.isinf(r.distances).sum())}; launches "
            f"{nonzero(launches)}; equal to the plain composition: {same}; "
            f"{card}")
        return r

    for fname in ("bernoulli-0.01", "rows-60"):
        pred = torch.from_numpy(filters[fname]).cuda()
        served(f"crude rung, filter {fname}", lambda: engine.search(
            q, budget=SearchBudget(force_level="crude"), filter=pred),
            {crude_key if ivf else "crude_topk_pred": 1},
            plain_jnp(index, q, pred, crude_only=True))
    crude = ("ivf_crude_topk" if ivf else "crude_topk")
    capped = {crude: 1, "select_topk": 1, "rerank_topk": 1}
    half = torch.from_numpy(filters["bernoulli-0.5"]).cuda()
    for cap in CAPS:
        want = plain_jnp(index, q, refine_cap=cap)
        r = served(f"capped rung, SearchBudget(refine_cap={cap})",
                   lambda: engine.search(
                       q, budget=SearchBudget(refine_cap=cap)),
                   capped, want)
        check(r.meta.level_name == "capped", f"jnp {name}: refine_cap "
                                             f"served {r.meta.level_name}")
        at_cap = engine_load(f"jnp-{name}-refine_cap{cap}", path,
                             {**JNP, "index.refine_cap": cap},
                             query_tile=TILE)
        served(f"index.refine_cap={cap}", lambda: at_cap.search(q), capped,
               want)
        served(f"index.refine_cap={cap}, filter bernoulli-0.5",
               lambda: at_cap.search(q, filter=half),
               {**capped, crude: 1} if ivf else
               {"crude_topk_pred": 1, "select_topk": 1, "rerank_topk": 1},
               plain_jnp(index, q, half, refine_cap=cap))
    # the pipelined executor (two streams on the card) at tile 64 over
    # three tiles, filtered and capped, equal to the tiled engine
    piped = engine_load(f"jnp-{name}-pipelined", path,
                        {**JNP, "serve.pipeline": "tiles"})
    qb = torch.from_numpy(rng.standard_normal(
        (3 * TILE, int(index.C.shape[-1])), dtype=np.float32)).cuda()
    for what, kw in (("filter bernoulli-0.5", dict(filter=half)),
                     (f"refine_cap {CAPS[0]}",
                      dict(budget=SearchBudget(refine_cap=CAPS[0])))):
        want = engine.search(qb, **kw)
        reset_launches()
        got = piped.search(qb, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
        for k in total:
            total[k] += launches[k]
        same = (torch.equal(got.indices, want.indices)
                and torch.equal(got.distances, want.distances))
        check(same, f"jnp {name} pipelined {what}: != the tiled engine")
        log(f"jnp {name} pipelined (tiles of {TILE}, 3 tiles) {what}: ids "
            f"and distances == the tiled engine's: {same}; launches "
            f"{nonzero(launches)}; {card}")
    auto = engine_load(f"auto-{name}", path, query_tile=TILE)
    words = {
        "engine filter": (raised(lambda: auto.search(q, filter=half)),
                          ENGINE_FILTER_WORDS),
        "index filter": (raised(lambda: auto.index.search(q, filter=half)),
                         INDEX_FILTER_WORDS),
        "refine_cap": (raised(lambda: engine_load(
            f"auto-{name}-refine_cap", path,
            {"index.refine_cap": CAPS[0]}).search(q)), CAP_WORDS),
        "capped rung": (raised(lambda: auto.search(
            q, budget=SearchBudget(force_level="capped"))), "not servable")}
    for what, (got, want) in words.items():
        check(got == want if what != "capped rung" else want in got,
              f"auto {name}: {what} raised {got!r}")
    check("capped" not in auto._levels(), f"auto {name}: capped rung")
    log(f"auto {name}: engine and index filter, refine_cap and the capped "
        f"rung refused with the reference's words; rungs {auto._levels()}")
    return total


def sharded_filtered(name, path, filters, *, seed, card):
    """Phase 18 (d): the artifact over a 4-way mesh on the first card at
    its own backend (auto: the sharded engine serves filter under every
    backend), filtered, equal bit for bit (ids, distances, pass_rate,
    avg_ops) to the unsharded jnp engine's filtered search.  Returns the
    launches."""
    import numpy as np
    import torch
    from repro_torch.index.ivf import IVFTwoStep

    plain = engine_load(f"jnp-{name}-unsharded", path, JNP, query_tile=TILE)
    eng = engine_load(f"{name}-D4-filtered", path,
                      mesh=data_mesh(4, ["cuda"]), query_tile=TILE)
    ivf = isinstance(plain.index, IVFTwoStep)
    rng = np.random.default_rng(seed + 53)
    q = torch.from_numpy(rng.standard_normal(
        (TILE, int(plain.index.C.shape[-1])), dtype=np.float32)).cuda()
    total = {k: 0 for k in read_launches()}
    pair = (("ivf_crude_topk", "ivf_refine_topk") if ivf
            else ("crude_topk_pred", "refine_topk"))
    for fname in ("bernoulli-0.5", "rows-60"):
        pred = torch.from_numpy(filters[fname]).cuda()
        want = plain.search(q, filter=pred)
        eng.search(q, filter=pred)
        torch.cuda.synchronize()
        reset_launches()
        got = eng.search(q, filter=pred)
        torch.cuda.synchronize()
        launches = read_launches()
        expect = {k: 0 for k in launches}
        expect.update({k: 4 for k in pair})
        check(launches == expect, f"sharded {name} {fname}: launches "
                                  f"{nonzero(launches)} != {nonzero(expect)}")
        for k in total:
            total[k] += launches[k]
        same = same_result(got, want)
        check(same, f"sharded {name} D=4 {fname}: != the unsharded jnp "
                    "engine")
        log(f"sharded {name} D=4 (backend {eng.backend}) filter {fname}: "
            f"ids, distances, pass_rate, avg_ops == the unsharded jnp "
            f"engine's: {same}; launches {nonzero(launches)}; {card}")
    return total


def filtered_search(paths, *, seed, n, card):
    """Phase 18: filter= and refine_cap on the card.  Returns (launches,
    kernel records)."""
    t0 = time.perf_counter()
    filters = make_filters(seed, n)
    records = filtered_kernels(seed, n, filters, card)
    total = {k: 0 for k in read_launches()}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    for name, art, over in JNP_CELLS:
        add(jnp_cell(name, paths[art], over, filters, seed=seed, n=n,
                     card=card))
    for name in ("two-step-f32", "ivf-f32"):
        add(jnp_rungs(name, paths[name], filters, seed=seed, card=card))
        add(sharded_filtered(name, paths[name], filters, seed=seed,
                             card=card))
    log(f"phase 18 ran {time.perf_counter() - t0:.1f} s (host clock)")
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
                         "and phase 14's and 17's prefill and decode "
                         "steps, with torch.profiler (Chrome traces to "
                         "DIR)")
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
        filt_total, filt_records = filtered_search(paths, seed=args.seed,
                                                   n=args.n, card=card)
        add(filt_total)
    check_kernel_ops(args.seed)
    ops_total, ops_records = kernel_ops(args.seed, args.n)
    om_total, om_records = offset_mask_calls(args.seed, card)
    bwd_records = flash_backward_timing(args.seed, card)
    train_total, fig1_model = train_cell(args.seed, card,
                                         profile_dir=args.profile)
    front_total = front_door(args.seed, args.n, card, fig1_model)
    dp_total = fit_data_parallel(args.seed, card, fig1_model)
    lm_total, lm_records = lm_serving(args.seed, card,
                                      profile_dir=args.profile)
    lm_train_total = lm_training(args.seed, card)
    lm_shard_total = lm_sharding(args.seed, card)
    lm_tp_total = tensor_parallelism(args.seed, card,
                                     profile_dir=args.profile)
    ops_records["flash_attention"] = lm_records["flash_attention"]
    for k in total:
        total[k] += (ivf_total[k] + enc_total[k] + ops_total[k] + om_total[k]
                     + train_total[k] + front_total[k]
                     + shard_total.get(k, 0) + dp_total[k] + lm_total[k]
                     + lm_train_total[k] + lm_shard_total[k]
                     + lm_tp_total[k])
    # the f32 forward at the train cell's shape: phase 15's launches (the
    # train command's steps, the forward with its log-sum-exp)
    train_fwd = bwd_records.pop("flash_attention (train A f32)")
    train_fwd["launches"] = lm_train_total["flash_attention"]
    check(train_fwd["launches"] > 0, "the f32 forward was never launched "
                                     "in phase 15's train steps")
    records.update(ivf_records)
    records.update(ops_records)
    records.update(bwd_records)
    records.update(filt_records)
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
        "crude_topk_pred", "select_topk", "rerank_topk",
        "kmeans_assign", "icm_encode", "adc", "two_step",
        "flash_attention")] + [lm_records[k] for k in (
            "flash_attention_mla", "flash_attention_mla_noncausal",
            "flash_attention_window",
            "flash_attention_encoder", "flash_attention_cross")]
        + [om_records[f"flash_attention ({k})"] for k in ("q_offset",
                                                           "mask")]
        + [train_fwd]
        + [records[k] for k in ("flash_attention_bwd_dq",
                                "flash_attention_bwd_dkdv")]
        + [om_records[f"flash_attention_bwd ({k})"] for k in ("q_offset",
                                                               "mask")]}))
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
