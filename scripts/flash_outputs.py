#!/usr/bin/env python3
"""Save, or compare, the flash kernels' outputs of one tree on the card.

    python3 scripts/flash_outputs.py save --src DIR --out FILE [--seed 0]
    python3 scripts/flash_outputs.py compare FILE_A FILE_B

``save`` builds the tree's kernels (``--src``: the ``src`` directory of
the tree, e.g. an earlier commit unpacked with ``git archive`` into a
git-ignored directory) and runs every mode of this checkout's
``chip_smoke.py`` phase 7 (``FLASH_MODES``, ``FLASH_WINDOW_MODES``,
``FLASH_KV_VALID_MODES``; f32 and bf16) through that tree's
``flash_attention_cuda`` (with its log-sum-exp) and
``flash_attention_bwd_cuda`` with the arguments every tree takes (no
query offset, no mask), from operands drawn on the card from ``--seed``;
it writes the outputs to FILE with ``torch.save``.  ``compare`` says,
mode by mode, whether two such files hold the same bits (and, of each
output that differs, the largest difference), counts them by type, and
exits 1 if any differs.  Run ``save`` once per tree (each in its own process:
the trees' modules share names), then ``compare``.  Prints the card's
name and power limit first; ``save`` needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def save(src: str, out: str, seed: int) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_outputs: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.abspath(src), ROOT]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    seconds, _ = build.build_all()
    print(f"built {build.__file__}'s kernels in {seconds:.1f} s", flush=True)
    modes = (tuple(m + (0, 0) for m in chip_smoke.FLASH_MODES)
             + tuple(m + (0,) for m in chip_smoke.FLASH_WINDOW_MODES)
             + tuple(m[:7] + (False, 0, m[7])
                     for m in chip_smoke.FLASH_KV_VALID_MODES))
    saved = {}
    for mode in modes:
        b, sq, sk, H, KVH, dh, dv, causal, window, kv_valid = mode
        masks = dict(causal=causal, window=window, kv_valid=kv_valid)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = chip_smoke.attention_operands(
                seed + sq + dh + window + kv_valid, b, sq, sk, H, KVH, dh,
                dtype, dv)
            g = torch.Generator(device="cuda").manual_seed(seed + 7 * sq + dh)
            do = torch.randn((b, sq, H, dv), generator=g,
                             device="cuda").to(dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **masks)
            grads = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **masks)
            saved[f"{mode} {dtype}"] = [t.cpu() for t in (o, lse, *grads)]
    torch.save(saved, out)
    print(f"saved {len(saved)} mode x type outputs to {out}")
    return 0


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    names = ("out", "lse", "dq", "dk", "dv")
    differ = 0
    by_type = {}
    for key in x:
        same = [torch.equal(p, q) for p, q in zip(x[key], y[key])]
        differ += not all(same)
        kind = key.rsplit(" ", 1)[-1]
        by_type.setdefault(kind, [0, 0])[all(same)] += 1
        print(f"{key}: " + ("equal bit for bit" if all(same) else
                            "DIFFERENT in " + ", ".join(
                                f"{n} (max |a - b| "
                                f"{float((p.float() - q.float()).abs().max())}"
                                ")" for n, s, p, q in zip(
                                    names, same, x[key], y[key]) if not s)))
    print(f"{len(x) - differ} of {len(x)} mode x type outputs equal bit for "
          f"bit ({a} against {b}); by type (different, equal): {by_type}")
    return 1 if differ or set(x) != set(y) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("save")
    sv.add_argument("--src", default=os.path.join(ROOT, "src"))
    sv.add_argument("--out", required=True)
    sv.add_argument("--seed", type=int, default=0)
    cp = sub.add_parser("compare")
    cp.add_argument("a")
    cp.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        return save(args.src, args.out, args.seed)
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
