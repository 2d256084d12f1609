"""Multi-pod dry run of the port (twin of ``repro.launch.dryrun``): plan
every (arch x input shape) cell on the production meshes laid over
``"meta"`` devices, trace one shard's step on the meta device, and
write its roofline terms.

For each cell:
    plan    = plan_cell(cfg, shape, make_production_mesh(devices="meta"))
    lowered = lower_cell(plan)     # hlo_cost's count of the traced step
    the per-device bytes of params, optimizer state, cache and batch
    from the rule tables' shard shapes; the three roofline terms

Nothing is allocated and nothing runs on a card: meta tensors hold
shapes only.  The reference lowers and compiles XLA programs for
256 / 512 TPU chips; the port traces its own step, so its per-device
flops and bytes assume what the rules ask of GSPMD: one (pod, data)
shard's traced unsplit work divided evenly over the "model" axis and
the optimizer update over the devices that shard the params.

Roofline terms, per device:
    compute    = counted flops / PEAK_FLOPS
    memory     = counted bytes / HBM_BW
    collective = collective bytes / LINK_BW, where the collective bytes
                 are the parameter all-gathers and gradient reductions
                 each param leaf's spec implies: with f the FSDP ways of
                 the leaf (its spec's "pod" / "data" sizes), r the
                 data-parallel ways it is replicated over and s its
                 shard (bytes / all its ways), a train step moves per
                 microbatch 2 (f - 1) s (the forward's and backward's
                 all-gathers) and (f - 1) s_f32 (the gradients'
                 reduce-scatter), and once a step 2 (r - 1) / r s_f32
                 (the all-reduce over the replicas; over "pod" under
                 --icq-grad an int8 all-gather, (P - 1) s_f32 / 4); a
                 prefill or decode step one all-gather, (f - 1) s.
                 Beside them, under their own keys, the tensor-parallel
                 collectives the executed split step runs
                 (``hlo_cost.tp_collectives``: one model group's step
                 traced on the meta device under
                 ``tensor_parallel.counting``): "all-reduce (tp)" (the
                 attention, MLP and embedding partials forward, the
                 gradients of each split region's input backward, 2 (M -
                 1) / M of the bytes a device), "all-gather (tp)" (the
                 logit and projection slices, wk / wv split inside a
                 head, the decode's queries and softmax partials,
                 (M - 1) / M), "all-reduce (experts)" (the MoE's expert
                 partials).  A train step counts each microbatch's.

Hardware constants: the NVIDIA H100 SXM data sheet (NVIDIA H100 80GB
HBM3, at its 700 W limit); a 16-wide axis spans more than one 8-GPU
NVLink node, where the links between nodes (InfiniBand, 50 GB/s a GPU
at 400 Gb/s) are slower than the NVLink rate used here, so the
collective term is a lower bound there.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.distributed import sharding as shrules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import lower_cell, plan_cell, plan_icq_kv_cell

# ----------------------------------------------------- hardware constants --
# NVIDIA H100 SXM data sheet, NVIDIA H100 80GB HBM3 at 700 W:
PEAK_FLOPS = 989e12          # bf16 dense tensor-core operations/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4: 900 GB/s a GPU, 450 GB/s each way
CARD = "NVIDIA H100 80GB HBM3, 700 W (data sheet)"
DEVICE_BYTES = 80e9


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell (6ND train / 2ND per decode token,
    N = active *matmul* params for MoE) + attention score/value flops.

    The input-embedding table is a gather (0 flops), so it is excluded;
    for tied embeddings the table still does the head matmul and counts
    once (param_count already holds it once in that case).
    """
    n_active = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_size * cfg.d_model   # gather-only input embed
    B, S = shape.global_batch, shape.seq_len

    # attention layer count + per-token context length: hybrids attend on
    # a fraction of layers with a bounded window (recurrentgemma: 1/3 of
    # layers, 2048-window), so full-S^2 accounting badly over-counts.
    n_att = 0 if cfg.attn_free else cfg.num_layers
    ctx_full = S
    if cfg.hybrid and cfg.block_pattern:
        frac = cfg.block_pattern.count("local") / len(cfg.block_pattern)
        n_att = cfg.num_layers * frac
        ctx_full = min(S, cfg.local_window or S)

    def att_flops(tokens_per_row, causal_half):
        ctx = ctx_full if not causal_half else ctx_full / 2 \
            if ctx_full == S else ctx_full  # windowed causal ~= window
        return n_att * B * 2 * 2 * tokens_per_row * ctx * cfg.q_dim

    if shape.kind == "train":
        flops = 6.0 * n_active * B * S
        if n_att and cfg.num_heads:
            flops += 3.0 * att_flops(S, causal_half=True)   # fwd + 2x bwd
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * n_active * B * S
        if n_att and cfg.num_heads:
            flops += att_flops(S, causal_half=True)
        return flops
    # decode: one token against an S-long (or window-bounded) cache
    flops = 2.0 * n_active * B
    if n_att and cfg.num_heads:
        flops += att_flops(1, causal_half=False)
    return flops


def exec_flops(cfg, shape) -> float:
    """FLOPs the step actually executes (analytic): MODEL_FLOPS plus the
    remat recompute (one extra forward per layer for train)."""
    mf = model_flops(cfg, shape)
    if shape.kind == "train" and cfg.remat:
        return mf * 8.0 / 6.0       # fwd + recomputed fwd + 2x bwd
    return mf


def collective_bytes(plan, *, compress: bool, tp_bytes=None):
    """Per-device collective bytes of one step (module docstring):
    (total, by op); ``tp_bytes`` the tensor-parallel collectives by tag
    (``hlo_cost.tp_collectives``), added under their own keys."""
    mesh = plan.mesh
    dp_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    by_op = dict(tp_bytes or {})

    def add(op, n):
        if n:
            by_op[op] = by_op.get(op, 0.0) + n
    params, p_shard = plan.args[0], plan.in_shardings[0]
    for leaf, sh in shrules.zip_leaves(params, p_shard):
        named = [a for e in sh.spec for a in shrules.entry_axes(e)]
        f = 1
        for a in dp_axes:
            if a in named:
                f *= shrules.axis_size(mesh, a)
        ways = 1
        for a in named:
            ways *= shrules.axis_size(mesh, a)
        s = leaf.numel() * leaf.element_size() / ways
        if plan.kind != "train":
            add("all-gather", (f - 1) * s)
            continue
        s32 = leaf.numel() * 4 / ways
        add("all-gather", plan.n_micro * 2 * (f - 1) * s)
        add("reduce-scatter", plan.n_micro * (f - 1) * s32)
        for a in dp_axes:
            if a in named:
                continue
            r = shrules.axis_size(mesh, a)
            if compress and a == "pod":
                add("all-gather (int8)", (r - 1) * s32 / 4)
            else:
                add("all-reduce", 2 * (r - 1) / r * s32)
    return sum(by_op.values()), by_op


def memory_bytes(plan) -> dict:
    """Per-device bytes of the step's arguments under the rule tables."""
    out = {"params": shrules.shard_bytes(plan.args[0],
                                         plan.in_shardings[0])}
    if plan.kind == "train":
        opt, o_shard = dict(plan.args[1]), dict(plan.in_shardings[1])
        if "ef_residual" in opt:        # a device holds its pod's tree
            opt["ef_residual"] = opt["ef_residual"][0]
            o_shard["ef_residual"] = o_shard["ef_residual"][0]
        out["opt"] = shrules.shard_bytes(opt, o_shard)
        out["batch"] = shrules.shard_bytes(plan.args[2],
                                           plan.in_shardings[2])
    elif plan.kind == "prefill":
        out["batch"] = shrules.shard_bytes(plan.args[1],
                                           plan.in_shardings[1])
    else:
        out["batch"] = shrules.shard_bytes(plan.args[1],
                                           plan.in_shardings[1])
        out["cache"] = shrules.shard_bytes(plan.args[2],
                                           plan.in_shardings[2])
    out["total"] = sum(out.values())
    return out


def analyze(lowered, cfg, shape, mesh, *, compress: bool) -> dict:
    plan = lowered.plan
    n_dev = mesh.size
    cost = lowered.cost.per_device
    coll, by_op = collective_bytes(plan, compress=compress,
                                   tp_bytes=lowered.cost.tp_bytes)
    mf = model_flops(cfg, shape)
    ef = exec_flops(cfg, shape)
    compute_term = cost.flops / PEAK_FLOPS
    memory_term = cost.bytes / HBM_BW
    collective_term = coll / LINK_BW
    dominant = max(
        (("compute", compute_term), ("memory", memory_term),
         ("collective", collective_term)), key=lambda kv: kv[1])[0]
    return {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "devices": int(n_dev),
        "counted_flops_per_dev": cost.flops,
        "counted_bytes_per_dev": cost.bytes,
        "counted_flash_calls_per_shard": lowered.cost.shard.flash_calls,
        "counted_flops_by_op_per_dev": cost.flops_by_op,
        "counted_bytes_by_op_per_dev": dict(sorted(
            cost.bytes_by_op.items(), key=lambda kv: -kv[1])[:12]),
        "collective_bytes_per_dev": float(coll),
        "collectives_by_op": by_op,
        "compute_term_s": compute_term,
        "memory_term_s": memory_term,
        "collective_term_s": collective_term,
        "dominant": dominant,
        "model_flops_global": mf,
        "model_flops_per_dev": mf / n_dev,
        "exec_flops_analytic_per_dev": ef / n_dev,
        "useful_flops_ratio": (mf / n_dev) / cost.flops if cost.flops
        else 0.0,
        "memory": memory_bytes(plan),
        "card": CARD,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             icq_grad: bool = False, attn_impl: str = "chunked",
             out_dir: str = "experiments/dryrun", verbose: bool = True,
             variant: str = "") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
    t0 = time.time()
    if variant == "icq_kv":
        plan = plan_icq_kv_cell(cfg, shape, mesh)
    else:
        plan = plan_cell(cfg, shape, mesh, icq_grad=icq_grad,
                         attn_impl=attn_impl)
    t_plan = time.time() - t0
    lowered = lower_cell(plan)
    rec = analyze(lowered, plan.cfg, shape, mesh,
                  compress=icq_grad and multi_pod)
    rec.update(n_micro=plan.n_micro, plan_s=round(t_plan, 2),
               trace_s=round(lowered.trace_s, 2), icq_grad=icq_grad,
               attn_impl=attn_impl, variant=variant)
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    suffix = f"_{variant}" if variant else ""
    path = os.path.join(out_dir,
                        f"{arch}_{shape_name}_{mesh_tag}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        mem = rec["memory"]["total"]
        print(f"[ok] {arch:22s} {shape_name:12s} {mesh_tag:6s} "
              f"flops/dev={rec['counted_flops_per_dev']:.3e} "
              f"bytes/dev={rec['counted_bytes_per_dev']:.3e} "
              f"coll/dev={rec['collective_bytes_per_dev']:.3e} "
              f"mem/dev={mem / 1e9:.2f} GB"
              f"{' (> 80 GB)' if mem > DEVICE_BYTES else ''} "
              f"dom={rec['dominant']} (trace {lowered.trace_s:.1f}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--icq-grad", action="store_true",
                    help="compressed cross-pod grad combine (multi mesh)")
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    t0 = time.time()
    for arch in archs:
        cfg = get_config(arch)
        cells = ([args.shape] if args.shape
                 else list(shapes_for(cfg).keys()))
        for shape_name in cells:
            for mp in meshes:
                try:
                    run_cell(arch, shape_name, mp, icq_grad=args.icq_grad,
                             attn_impl=args.attn_impl, out_dir=args.out,
                             variant=args.variant)
                except Exception as e:
                    failures.append((arch, shape_name, mp, repr(e)))
                    print(f"[FAIL] {arch} {shape_name} "
                          f"{'multi' if mp else 'single'}: {e}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + "; ".join(f"{a}/{s}/{m}" for a, s, m, _ in
                                     failures))
    print(f"all requested cells traced OK in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
