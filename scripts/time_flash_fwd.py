#!/usr/bin/env python3
"""Time the f32 flash forward of one tree on the card, at the shapes the
main path gives it: build that tree's kernels, then for each shape of
``SHAPES`` run ``chip_smoke.py``'s checks and timing of one call
(``chip_smoke.flash_at_shape``; with the log-sum-exp,
``chip_smoke.forward_record``): the kernel against the plain version
(2e-5), its time (CUDA events) beside its bounds at 3xTF32's rate and at
the f32 FMA rate, the plain version's and SDPA's.

    python3 scripts/time_flash_fwd.py [--src DIR] [--seed 0]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), e.g. an earlier commit unpacked with
``git archive`` into a git-ignored directory, so that one card times
both versions: run it for the earlier tree, this one, this one, the
earlier one.  The shapes, timing and bounds are always this checkout's
``chip_smoke.py``.  Prints the card's name and power limit first, and
one JSON line of {shape: ms} last; needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# label: (b, sq, sk, H, KVH, dqk, dv, causal, window, with_lse): the LM
# train cell's attention (tinyllama-1.1b, phase 15) with and without its
# log-sum-exp, LM cell A's prefill (8 x 512), phase 7's tinyllama cell
# at s = 4096, DeepSeek-V2's MLA blocks of phase 16 (a) in f32 (1024 x
# 1024, 128 heads of (192, 128), the causal diagonal block and a
# non-causal one), and recurrentgemma-9b's local layer (cell F's shape:
# 16 heads of 256, one KV head, window 2048) in f32
SHAPES = {
    "train A, lse": (8, 2048, 2048, 32, 4, 64, 64, True, 0, True),
    "train A": (8, 2048, 2048, 32, 4, 64, 64, True, 0, False),
    "cell A": (8, 512, 512, 32, 4, 64, 64, True, 0, False),
    "tinyllama s 4096": (1, 4096, 4096, 32, 4, 64, 64, True, 0, False),
    "MLA block causal": (1, 1024, 1024, 128, 128, 192, 128, True, 0, False),
    "MLA block non-causal": (1, 1024, 1024, 128, 128, 192, 128, False, 0,
                             False),
    "window 2048, dh 256": (1, 4096, 4096, 16, 1, 256, 256, True, 2048,
                            False),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    seconds, _ = build.build_all()
    print(f"built {build.__file__}'s kernels in {seconds:.1f} s", flush=True)
    times = {}
    for i, (label, shape) in enumerate(SHAPES.items()):
        b, sq, sk, H, KVH, dqk, dv, causal, window, with_lse = shape
        q, k, v = chip_smoke.attention_operands(
            args.seed + i, b, sq, sk, H, KVH, dqk, torch.float32, dv)
        if with_lse:
            o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
            ms = chip_smoke.time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, with_lse=True), 5)
            chip_smoke.forward_record(label, q, k, v, o, lse, ms, card)
            del o, lse
        else:
            ms = chip_smoke.flash_at_shape(label, "f32", q, k, v, causal,
                                           window)["ms"]
        times[label] = ms
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
