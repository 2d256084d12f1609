"""The port's dry run against the reference's, on the CPU: the analytic
flop counts of every arch x shape equal, the cost count of a traced
train cell within 35% of the analytic count (the reference's own audit,
``tests/test_hlo_cost.py``: attention, the CE head, norms and the
optimizer make the slack), the flash call counted as one op with its
analytic count, and the command writing its record."""
import dataclasses
import json
import os

import pytest
import torch

from repro import configs as ref_configs
from repro.launch import dryrun as ref_dryrun
from repro_torch import configs
from repro_torch.distributed.sharding import make_mesh_auto
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch.steps import lower_cell, plan_cell, plan_icq_kv_cell


@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_and_exec_flops_equal_reference(arch):
    rcfg, pcfg = ref_configs.get_config(arch), configs.get_config(arch)
    for name, shape in configs.shapes_for(pcfg).items():
        rshape = ref_configs.SHAPES[name]
        assert dryrun.model_flops(pcfg, shape) == \
            ref_dryrun.model_flops(rcfg, rshape), name
        assert dryrun.exec_flops(pcfg, shape) == \
            ref_dryrun.exec_flops(rcfg, rshape), name


def test_counted_flops_within_35_percent_of_exec_flops():
    """tinyllama at 2 layers, a 2 x 512 train cell on the 1 x 1 mesh:
    the traced step's products and flash calls (2 layers x (forward +
    recompute + backward)) within 35% of ``exec_flops``."""
    mesh = make_mesh_auto((1, 1), ("data", "model"), devices="meta")
    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b"),
                              num_layers=2, microbatch_size=2)
    shape = configs.ShapeSpec(name="t", seq_len=512, global_batch=2,
                              kind="train")
    lowered = lower_cell(plan_cell(cfg, shape, mesh))
    ratio = lowered.cost.per_device.flops / dryrun.exec_flops(
        lowered.plan.cfg, shape)
    assert 0.65 < ratio < 1.35, ratio
    assert lowered.cost.shard.flash_calls == 2 * 3


def test_flash_on_meta_counts_its_analytic_work():
    """One causal GQA call and its backward on meta tensors: empty
    outputs of the kernel's shapes, counted once each with the analytic
    operations (2 (dqk + dv) a visible pair forward, 2 (3 dqk + 2 dv)
    backward) and no product of the plain version."""
    b, s, H, KVH, dh = 2, 64, 4, 2, 32
    q, k, v = (torch.empty(b, s, h, dh, device="meta", requires_grad=True)
               for h in (H, KVH, KVH))
    with hlo_cost.CostCounter() as counter:
        out = ops.flash_attention(q, k, v, causal=True)
        torch.autograd.grad(out.sum(), (q, k, v))
    pairs = s * (s + 1) // 2
    assert out.shape == (b, s, H, dh) and out.is_meta
    assert counter.cost.flash_calls == 2
    assert counter.cost.flops_by_op == {
        "flash_attention": 2.0 * b * H * pairs * (2 * dh + 5 * dh)}
    assert hlo_cost.visible_pairs(8, 8, True, window=3) == 3 * 8 - 3


def test_cli_writes_a_record(tmp_path):
    """``--arch tinyllama-1.1b --shape decode_32k --mesh both`` on meta
    devices: one JSON a mesh with the reference's keys where they mean
    the same, the counted keys, per-device bytes and the H100's terms."""
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path)])
    for tag, devices in (("single", 256), ("multi", 512)):
        path = os.path.join(tmp_path, f"tinyllama-1.1b_decode_32k_{tag}.json")
        rec = json.load(open(path))
        assert rec["devices"] == devices and rec["kind"] == "decode"
        for key in ("model_flops_global", "model_flops_per_dev",
                    "exec_flops_analytic_per_dev", "compute_term_s",
                    "memory_term_s", "collective_term_s", "dominant",
                    "n_micro", "mesh", "counted_flops_per_dev",
                    "counted_bytes_per_dev", "collective_bytes_per_dev"):
            assert key in rec, key
        assert rec["counted_flops_per_dev"] > 0
        assert rec["memory"]["cache"] > 0 and rec["memory"]["params"] > 0
        assert rec["compute_term_s"] == pytest.approx(
            rec["counted_flops_per_dev"] / dryrun.PEAK_FLOPS)


def _tp_cell(kind, seq_len, batch):
    """tinyllama at 2 layers (full width, bf16 as the dry run scales it)
    on the meta (data 1, model 2) mesh: the lowered cell."""
    mesh = make_mesh_auto((1, 2), ("data", "model"), devices="meta")
    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b"),
                              num_layers=2, microbatch_size=batch)
    shape = configs.ShapeSpec(name="t", seq_len=seq_len, global_batch=batch,
                              kind=kind)
    return lower_cell(plan_cell(cfg, shape, mesh))


def test_tensor_parallel_bytes_of_a_train_cell_equal_a_hand_count():
    """A 2 x 512 train cell split over model 2: the collectives the split
    step's code runs, counted on the meta device, under their own keys
    beside the param collectives.  By hand, with a = 2 x 512 x 2048 x 2
    bytes (a bf16 activation), each all-reduce moving 2 (M - 1) / M a = a
    a device: forward the embedding's and each layer's two (attention,
    MLP) all-reduces; the remat recompute of each layer up to the last
    tensor its backward reads (the attention's all-reduce; the MLP's is
    past it); backward the gradient all-reduce of each layer's two
    broadcast inputs and of the head's input: 1 + 4 + 2 + 5 = 12; the
    head's logit slices (2 x 512 x 32000 bf16) all-gathered, (M - 1) / M
    of them a device, in the forward and in the CE chunk's recompute."""
    lowered = _tp_cell("train", 512, 2)
    act, logits = 2 * 512 * 2048 * 2, 2 * 512 * 32000 * 2
    want = {"all-reduce (tp)": 12.0 * act, "all-gather (tp)": logits}
    assert lowered.cost.tp_bytes == want
    total, by_op = dryrun.collective_bytes(lowered.plan, compress=False,
                                           tp_bytes=lowered.cost.tp_bytes)
    plain, plain_by_op = dryrun.collective_bytes(lowered.plan,
                                                 compress=False)
    assert total == plain + sum(want.values())
    assert by_op == dict(plain_by_op, **want)


def test_tensor_parallel_bytes_of_a_decode_cell_equal_a_hand_count():
    """One decode token of 4 rows over a 1024-position cache, split over
    model 2 (4 KV heads: the cache split by heads): the embedding's and
    each layer's two all-reduces of a 4 x 2048 bf16 activation (2 (M -
    1) / M of it a device each: 5 in all) and the logits' all-gather
    (4 x 32000 bf16, half of it a device); a prefill of 2 x 512: the
    same all-reduces of its activations and the last position's logits
    all-gathered; a model axis of 1 counts none."""
    dec = _tp_cell("decode", 1024, 4)
    assert dec.cost.tp_bytes == {"all-reduce (tp)": 5.0 * 4 * 2048 * 2,
                                 "all-gather (tp)": 0.5 * 4 * 32000 * 2}
    pre = _tp_cell("prefill", 512, 2)
    assert pre.cost.tp_bytes == {
        "all-reduce (tp)": 5.0 * 2 * 512 * 2048 * 2,
        "all-gather (tp)": 0.5 * 2 * 32000 * 2}
    mesh = make_mesh_auto((1, 1), ("data", "model"), devices="meta")
    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b"),
                              num_layers=2)
    shape = configs.ShapeSpec(name="t", seq_len=1024, global_batch=4,
                              kind="decode")
    assert lower_cell(plan_cell(cfg, shape, mesh)).cost.tp_bytes == {}


def _tp_bytes(arch, kind, seq_len, batch, **repl):
    """The tensor-parallel bytes of ``arch`` (full width, bf16 as the dry
    run scales it, ``repl`` cutting its depth) on the meta (data 1, model
    2) mesh."""
    mesh = make_mesh_auto((1, 2), ("data", "model"), devices="meta")
    cfg = dataclasses.replace(configs.get_config(arch), **repl)
    shape = configs.ShapeSpec(name="t", seq_len=seq_len, global_batch=batch,
                              kind=kind)
    return lower_cell(plan_cell(cfg, shape, mesh)).cost.tp_bytes


def test_tensor_parallel_bytes_of_an_ssm_decode_cell_equal_a_hand_count():
    """mamba2-1.3b at 2 layers, one decode token of 4 rows, over model 2:
    the embedding's all-reduce (4 x 2048 bf16, 2 (M - 1) / M of it a
    device), and a layer's two: the gated norm's f32 sums of squares (4
    x 1) and ``w_out``'s partials (4 x 2048 bf16); B's and C's
    all-gathers after the conv (4 x 128 bf16 each, (M - 1) / M of it a
    device) in each layer, and the logits' (4 x 50432 bf16)."""
    got = _tp_bytes("mamba2-1.3b", "decode", 1024, 4, num_layers=2)
    act = 4 * 2048 * 2
    assert got == {"all-reduce (tp)": act + 2 * (4 * 4 + act),
                   "all-gather (tp)": 2 * 2 * 0.5 * 4 * 128 * 2
                   + 0.5 * 4 * 50432 * 2}


def test_tensor_parallel_bytes_of_a_hybrid_decode_cell_equal_a_hand_count():
    """recurrentgemma-9b at 3 layers (rglru, rglru, local), one decode
    token of 4 rows over a 1024-slot ring, over model 2: the tied
    embedding's all-reduce and each layer's two (the mixer's or the
    attention's ``wo`` partials, the MLP's), 4 x 4096 bf16 each.  The
    local layer's one KV head (dh 256) splits inside the head: ``wk`` and
    ``wv`` (4096 x 256 bf16) all-gathered, the new K and V (4 x 256)
    all-gathered, the queries (4 x 16 x 256); the ring split by sequence,
    each shard's softmax partials gathered (m and l 4 x 16 f32, o 4 x 16
    x 256 f32: (M - 1) of a shard's); the tied head's logits (4 x
    256000 bf16)."""
    got = _tp_bytes("recurrentgemma-9b", "decode", 1024, 4, num_layers=3)
    act = 4 * 4096 * 2
    half = 0.5
    assert got == {
        "all-reduce (tp)": act + 3 * 2 * act,
        "all-gather (tp)": half * 2 * 4096 * 256 * 2
        + half * 2 * 4 * 256 * 2 + half * 4 * 16 * 256 * 2
        + (2 * 4 * 16 * 4 + 4 * 16 * 256 * 4) + half * 4 * 256000 * 2}


def test_tensor_parallel_bytes_of_a_whisper_prefill_cell_equal_a_hand_count():
    """whisper-large-v3 at 2 encoder and 2 decoder layers, a prefill of
    2 x 64 tokens over 1500 frames, over model 2 (20 heads: 10 a shard,
    the cross cache by heads): each encoder layer's two all-reduces of a
    2 x 1500 x 1280 bf16 activation, the embedding's and each decoder
    layer's three (self attention, cross attention, MLP) of 2 x 64 x
    1280, and the last position's logits (2 x 51968 bf16)
    all-gathered."""
    got = _tp_bytes("whisper-large-v3", "prefill", 64, 2, num_layers=2,
                    encoder_layers=2)
    enc, dec = 2 * 1500 * 1280 * 2, 2 * 64 * 1280 * 2
    assert got == {"all-reduce (tp)": 2 * 2 * enc + dec + 2 * 3 * dec,
                   "all-gather (tp)": 0.5 * 2 * 51968 * 2}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b",
                                  "internvl2-76b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "whisper-large-v3"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_model_shards_trace_counts_the_groups_collectives(arch, kind):
    """The dry run traces one model shard's split step
    (``tensor_parallel.one_shard``); its count equals the whole group's
    step traced shard by shard, at smoke size on a meta (data 1, model
    2) mesh: tinyllama's wk / wv split inside its one KV head and its
    cache by sequence, deepseek's MLA and experts, internvl's
    ``vis_proj``, mamba2's segment layout, recurrentgemma's ring split
    by sequence, whisper's encoder and cross attention."""
    from repro_torch.distributed import tensor_parallel as tp
    mesh = make_mesh_auto((1, 2), ("data", "model"), devices="meta")
    cfg = configs.smoke_config(arch)
    shape = configs.ShapeSpec(name="t", seq_len=16, global_batch=2,
                              kind=kind)
    plan = plan_cell(cfg, shape, mesh)
    with torch.no_grad() if kind != "train" else torch.enable_grad(), \
            tp.counting() as whole:
        plan.tp_fn(*plan.tp_args)
    assert hlo_cost.tp_collectives(plan) == whole and whole


@pytest.mark.parametrize("kvh,heads", [(4, 8), (1, 4)])
def test_tensor_parallel_bytes_of_an_icq_kv_cell_equal_a_hand_count(kvh,
                                                                   heads):
    """The ICQ-KV decode cell (smoke tinyllama: d 64, 2 layers, dh 16,
    vocabulary padded to 256; 4 rows, a 256-position cache, top_c 128)
    over model 2.  4 KV heads: the cache by heads, no collective but the
    all-reduces (the embedding's and each layer's ``wo`` and MLP
    partials, 4 x 64 bf16 each) and the logits' all-gather (4 x 256
    bf16).  1 KV head: by positions, besides those ``wk`` / ``wv`` (64 x
    16 bf16) all-gathered, the new K / V (4 x 16), the queries (4 x 4 x
    16), the crude candidates' union (4 x 4 x 256 f32 scores and int32
    positions: 128 a shard) and the refined partials (m and l 4 x 4 f32,
    o 4 x 4 x 16 f32: (M - 1) of a shard's); one shard's trace counts
    the group's."""
    from repro_torch.distributed import tensor_parallel as tp
    mesh = make_mesh_auto((1, 2), ("data", "model"), devices="meta")
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"),
                              num_heads=heads, num_kv_heads=kvh)
    shape = configs.ShapeSpec(name="t", seq_len=256, global_batch=4,
                              kind="decode")
    plan = plan_icq_kv_cell(cfg, shape, mesh)
    with torch.no_grad(), tp.counting() as whole:
        plan.tp_fn(*plan.tp_args)
    got = hlo_cost.tp_collectives(plan)
    act, half = 4 * 64 * 2, 0.5
    gather = half * 4 * 256 * 2
    if kvh == 1:
        gather += 2 * (half * 2 * 64 * 16 * 2 + half * 2 * 4 * 16 * 2
                       + half * 4 * 4 * 16 * 2 + half * 2 * 4 * 4 * 256 * 4
                       + (2 * 4 * 4 * 4 + 4 * 4 * 16 * 4))
    assert got == whole == {"all-reduce (tp)": act + 2 * 2 * act,
                            "all-gather (tp)": gather}


def test_executed_fsdp_bytes_equal_the_priced_ones():
    """tinyllama's smoke config with remat on, an 8 x 32 train cell over
    (pod 2, data 2, model 1), in bf16 as ``plan_cell`` scales it: the
    bytes a device of the executed FSDP step (``distributed.fsdp``, on
    CPU devices) against the dry run's (``collective_bytes``: per
    microbatch 2 (f - 1) s all-gathered, (f - 1) s_f32
    reduce-scattered).  The reduce-scatters are equal.  The all-gathers
    are equal but for the two leaves read outside a checkpointed layer,
    ``embed`` and ``head``: the forward gathers each once a microbatch
    and autograd keeps the gathered copy for the backward, where the dry
    run prices a second gather."""
    import numpy as np
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.steps import build_train_step, scale_config
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"),
                              remat=True, microbatch_size=1)
    shape = configs.ShapeSpec(name="t", seq_len=32, global_batch=8,
                              kind="train")
    names = ("pod", "data", "model")
    plan = plan_cell(cfg, shape, make_mesh_auto((2, 2, 1), names,
                                                devices="meta"))
    _, priced = dryrun.collective_bytes(plan, compress=False)
    once = ("embed", "head")
    sub = dataclasses.replace(
        plan, args=({k: plan.args[0][k] for k in once},) + plan.args[1:],
        in_shardings=({k: plan.in_shardings[0][k] for k in once},)
        + plan.in_shardings[1:])
    _, second = dryrun.collective_bytes(sub, compress=False)
    mesh = make_mesh_auto((2, 2, 1), names, devices="cpu")
    step, model, _, init = build_train_step(
        scale_config(cfg), n_micro=plan.n_micro, multi_pod=True, mesh=mesh)
    params = fsdp.place(model.init(0, device="cpu"), mesh)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, tuple(plan.args[2]["tokens"].shape),
        dtype=np.int32)
    with tp.counting() as got:
        step(params, init(params), {"tokens": toks, "labels": toks})
    assert plan.n_micro == 2
    assert got["reduce-scatter (fsdp)"] == priced["reduce-scatter"]
    assert got["all-gather (fsdp)"] == \
        priced["all-gather"] - second["all-gather"] / 2
