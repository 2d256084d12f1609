#!/usr/bin/env python3
"""Time the flat scan kernels of this checkout on the card: the crude
pass (f32, int8 and 4-bit nibble LUTs) and the refine pass at the main
path's shape (64 queries x 1M points, K = 8, m = 256 uint8 rows; the
nibble pass at K = 16, m = 16), and prints one JSON line of ms per call
(CUDA events, mean of ``--reps`` calls after two warm-up calls).

    python3 scripts/time_scan_kernels.py [--reps 20] [--seed 0]

It imports the port from the ``src/`` beside it, so a copy placed in an
older checkout times that checkout's kernels: run two checkouts in
turns (parent, change, change, parent, ...) to compare them on one card.
Needs a CUDA card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_scan_kernels: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.encode import pack_nibbles
    from repro_torch.index.base import build_lut
    from repro_torch.kernels import batched_search as bs
    from repro_torch.kernels.stages import (ThresholdStage,
                                            crude_lut_operands,
                                            slow_lut_operand)

    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def problem(seed, K, m, num_fast):
        g = torch.Generator(device="cuda").manual_seed(seed)
        C = torch.randn((K, m, 128), generator=g, device="cuda") / K ** 0.5
        codes = torch.randint(0, m, (args.n, K), generator=g, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
        q = torch.randn((64, 128), generator=g, device="cuda")
        fast = torch.arange(K, device="cuda") < num_fast
        return codes, build_lut(q, C), fast

    out = {}
    codes, luts, fast = problem(args.seed, 8, 256, 2)
    lf, _, _ = crude_lut_operands(luts, fast, quantized=False)
    lq, sc, of = crude_lut_operands(luts, fast, quantized=True)
    out["crude_f32"] = timed(lambda: bs.crude_topk_cuda(codes, lf, 100))
    out["crude_int8"] = timed(lambda: bs.crude_topk_cuda(codes, lq, 100,
                                                         sc, of))
    crude, cv, ci = bs.crude_topk_cuda(codes, lf, 100)
    slow = slow_lut_operand(luts, fast)
    for sigma in (10.0, 0.5):
        thr = ThresholdStage(topk=100).from_candidates(
            luts, codes, cv, ci, fast, torch.tensor(sigma, device="cuda"))
        out[f"refine_sigma{sigma:g}"] = timed(
            lambda: bs.refine_topk_cuda(codes, slow, crude, thr, 100))
    codes4, luts4, fast4 = problem(args.seed + 1, 16, 16, 4)
    packed = pack_nibbles(codes4, 16).contiguous()
    l4, s4, o4 = crude_lut_operands(luts4, fast4, quantized=True,
                                    code_bits=4)
    out["crude_int8_4bit"] = timed(lambda: bs.crude_topk_cuda(
        packed, l4, 100, s4, o4, code_bits=4))
    print(json.dumps({"root": ROOT, "device": torch.cuda.get_device_name(0),
                      "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
