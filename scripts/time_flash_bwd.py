#!/usr/bin/env python3
"""Time the flash backward kernels of one tree on the card: build that
tree's kernels, then run ``chip_smoke.py``'s phase 7 (d)
(``chip_smoke.flash_backward_timing``: ``FLASH_BWD_SHAPES``, each
kernel's time with its registers and local-memory bytes, the pair's,
the plain backward's and SDPA's backward beside their bounds).

    python3 scripts/time_flash_bwd.py [--src DIR] [--seed 0]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), e.g. an earlier commit unpacked with
``git archive`` into a git-ignored directory, so that one card times
both versions: run it for the earlier tree, this one, this one, the
earlier one.  The shapes, timing and bounds are always this checkout's
``chip_smoke.py``.  Prints the card's name and power limit first; needs
a CUDA card.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import chip_smoke
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    seconds, _ = build.build_all()
    print(f"built {build.__file__}'s kernels in {seconds:.1f} s", flush=True)
    chip_smoke.flash_backward_timing(args.seed, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
