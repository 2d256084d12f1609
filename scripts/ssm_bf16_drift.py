#!/usr/bin/env python3
"""Read how far mamba2-1.3b's bf16 logits drift, split over the model
axis and unsplit, on the card: for each seed and depth,
``chip_smoke.bf16_drift`` serves 8 x 2048 and 16 greedy steps in bf16
split over (model 2) and unsplit, and the same weights in f32 unsplit
and split, and prints one line: the bf16 split against the bf16
unsplit path over phase 14's bf16 gate, each bf16 path's largest logit
distance from f32 and their ratio (split over unsplit), the f32 split
against the f32 unsplit path over LM_TOL's bound.  The ratios set
``chip_smoke.SSM_DRIFT_RATIO`` (phase 17 (e)); the depths at which the
first column stays below 1 on every seed set phase 17 (e')'s.

    python3 scripts/ssm_bf16_drift.py [--seeds 8] [--depths 1 2 4 8 48]

Prints the card's name and power limit first; needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[1, 2, 4, 8, 48])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssm_bf16_drift: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ratios = {}
    for layers in args.depths:
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            bf16, d_s, d_u, f32 = chip_smoke.bf16_drift(
                seed, "mamba2-1.3b", layers, 8, 2048, 16, 2)
            ratios.setdefault(layers, []).append(d_s / d_u)
            print(f"mamba2-1.3b {layers} layers seed {seed}: bf16 split "
                  f"against unsplit {bf16:.4f} of the bf16 gate; from f32: "
                  f"split {d_s:.4f}, unsplit {d_u:.4f}, ratio "
                  f"{d_s / d_u:.4f}; f32 split against unsplit {f32:.4f} "
                  f"of LM_TOL's bound; {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
    for layers, r in ratios.items():
        print(f"{layers} layers: ratio min {min(r):.4f} max {max(r):.4f} "
              f"over {len(r)} seeds; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
