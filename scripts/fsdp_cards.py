"""The FSDP cells of ``chip_smoke.py`` (phase 16 (b') plain and
icq_grad over (pod 2, data 2, model 1), phase 17 (a'') over (pod 1, data
2, model 2)) with every mesh position on a card of its own: the mesh laid
over the visible cards (2-4; with fewer than 4 each repeats over a block
of positions).  Each cell's yardstick is the same step from whole (or
model-placed) params over the same mesh; the gates are ``fsdp_cell``'s,
and each step's peak is the largest over the cards of its MiB above what
the card held before it.

Run on a machine with 2-4 cards (not part of ``chip_smoke.py``'s default
run, which takes one card):

    python3 scripts/fsdp_cards.py
"""
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

CELLS = (("16 (b') plain", (2, 2, 1), False),
         ("16 (b') icq_grad", (2, 2, 1), True),
         ("17 (a'')", (1, 2, 2), False))


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import make_mesh_auto
    from repro_torch.kernels import build
    from repro_torch.launch.steps import build_train_step
    if not torch.cuda.is_available():
        print("fsdp_cards: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    cards = [torch.device("cuda", i)
             for i in range(min(torch.cuda.device_count(), 4))]
    cs.log(f"{len(cards)} card(s): {card[:len(cards)]}")
    build.build_all()
    cfg = dataclasses.replace(get_config(cs.TRAIN_ARCH),
                              num_layers=cs.SHARD_STEP["layers"])
    rows, tokens = cs.SHARD_STEP["rows"], cs.SHARD_STEP["tokens"]
    toks = np.random.default_rng(1601).integers(
        0, cfg.vocab_size, (1, rows, tokens), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}
    params = cs.lm_params(cfg, 0)
    step0, _, opt, init0 = build_train_step(cfg, n_micro=1)
    per = rows // 2
    pod_grads = [cs._step_grads(opt, step0(
        params, init0(params),
        {k: v[:, p * per:(p + 1) * per] for k, v in batch.items()}))[0]
        for p in range(2)]
    want = {k: 0 for k in cs.read_launches()}
    for k, n in cs.train_flash_launches(cfg, 1).items():
        want[k] = 4 * n
    failed = []
    cs.check = lambda ok, what: ok or failed.append(what) or cs.log(
        f"FAILED: {what}")
    for label, shape, icq in CELLS:
        t0 = time.perf_counter()
        mesh = make_mesh_auto(shape, ("pod", "data", "model"), devices=cards)
        step, _, _, init = build_train_step(cfg, n_micro=1, multi_pod=True,
                                            icq_grad=icq, mesh=mesh)
        src = tp.place(params, mesh) if shape[2] > 1 else params
        out, secs, peak, launches = cs.timed_step(step, src, init(src),
                                                  batch, mesh)
        if shape[2] > 1:
            out = (tp.gather(out[0]), dict(out[1], m=tp.gather(out[1]["m"]),
                                           v=tp.gather(out[1]["v"])), out[2])
        cs.check(launches == want, f"{label} launches {launches}")
        _, fpeak, fsecs = cs.fsdp_cell(label, cfg, mesh, params, batch,
                                       (out, secs, peak), want,
                                       f"{len(cards)} x {card[0]}", icq=icq,
                                       pod_grads=pod_grads)
        cs.log(f"fsdp_cards {label} over {len(set(mesh.devices.flat))} "
               f"card(s): peak a card above the state {fpeak:.1f} MiB FSDP, "
               f"{peak:.1f} MiB without; {fsecs:.2f} s against {secs:.2f} s; "
               f"{time.perf_counter() - t0:.1f} s")
        del out, src
    cs.log(f"fsdp_cards: {len(failed)} gate(s) failed {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
