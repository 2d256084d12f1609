#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 alone on the card: build the kernels
of this checkout, then serve the four LM cells (dense f32 and bf16, MoE,
MLA + MoE) through ``serve_lm`` with the phase's gates
(``chip_smoke.lm_serving``).

    python3 scripts/lm_serving.py [--seed 0] [--profile DIR]

Prints the card's name and power limit, then the phase's lines; exits
non-zero if a gate fails.  Needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace one prefill and 4 decode steps of "
                         "each cell with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lm_serving: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"kernels built in {build.build_all()[0]:.2f} s", flush=True)
    try:
        chip_smoke.lm_serving(args.seed, card, profile_dir=args.profile)
    except chip_smoke.SmokeFailure as e:
        print(f"lm_serving: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"ran {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
