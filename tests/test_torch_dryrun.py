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
from repro_torch.launch.steps import lower_cell, plan_cell


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
