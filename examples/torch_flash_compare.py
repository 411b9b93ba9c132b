#!/usr/bin/env python3
"""Time the port's flash attention of two checkouts on one card, in turns.

    python3 examples/torch_flash_compare.py OTHER_ROOT [--iters 20]

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each checkout builds its own ``csrc/flashattn.cu`` and is run in
its own process, in the order other, this, this, other, so that a drift of
the card's clocks shows as a difference between the two runs of one tree.
Each run times ``repro_torch.kernels.ops.flash_attention`` at the shapes
of ``chip_smoke.py``'s phase 12 (CUDA events, mean of ``--iters`` calls
after one warm-up, inputs from a fixed seed) and prints one JSON line (a
shape that a checkout refuses, such as a head dim past its kernels, has
``ms`` null); the last lines are the card's name and power limit and a
JSON summary.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(root: str, shapes: list, iters: int) -> None:
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    out = []
    for name, b, s, h, d, dtype, causal in shapes:
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=gen)
                   .to(getattr(torch, dtype)) for _ in range(3))
        try:
            ops.flash_attention(q, k, v, causal=causal)
        except ValueError as err:       # a head dim this checkout lacks
            out.append({"config": name, "dtype": dtype, "causal": causal,
                        "ms": None, "refused": str(err)})
            continue
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            ops.flash_attention(q, k, v, causal=causal)
        end.record()
        end.synchronize()
        out.append({"config": name, "dtype": dtype, "causal": causal,
                    "ms": start.elapsed_time(end) / iters})
    print(json.dumps({"root": root, "runs": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, json.loads(args.shapes), args.iters)
        return 0
    if args.other is None:
        ap.error("give the other checkout's root")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_compare: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import FLASH_SHAPES, nvidia_smi
    shapes = json.dumps([[n, b, s, h, d, str(dt).removeprefix("torch."), c]
                         for n, b, s, h, d, dt, c in FLASH_SHAPES])
    other = str(Path(args.other).resolve())
    times: dict[str, list] = {other: [], str(ROOT): []}
    for root in (other, str(ROOT), str(ROOT), other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root, "--shapes", shapes,
             "--iters", str(args.iters)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        times[root].append([r["ms"] for r in rec["runs"]])
    print(nvidia_smi(), flush=True)
    print(json.dumps({"shapes": json.loads(shapes), "other": other,
                      "other_ms": times[other], "this_ms": times[str(ROOT)]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
