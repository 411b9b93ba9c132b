#!/usr/bin/env python3
"""Time the CELF selection of two checkouts on one card, in turns.

    python3 examples/torch_celf_compare.py OTHER_ROOT [--reps 5]

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each run is a process of its own, in the order other, this,
this, other, so that a drift of the card's clocks shows as a difference
between the two runs of one tree.  A run solves the epinions-like
stand-in with ``selection="celf"`` (``barabasi_albert(75879, 4,
seed=0)``, WC weights, queue engine, 512 lanes, seed 0, k = 50, eps =
0.5) at ``sketch_k`` 1,024 and 16,384, which gives the same pool in every
run and checkout (8,704 RR sets, 35,538 elements), and then times
``store.select(50, method="celf")`` on that pool ``--reps`` times after
one warm-up: host clock from a ``torch.cuda.synchronize()`` to one after
the call, the whole selection as its caller waits for it.

Each run prints one JSON line: its root, the times of each sketch size
(``select_s``, every repetition, and their median), the selection's
``stats_out`` and a digest of its seeds, gains and float32 ``frac``
(both checkouts must agree).  The last lines are the card's name and
power limit and a JSON summary of the medians by run.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SKETCH_K = (1024, 16384)
N_NODES, BA_R, K, EPS, BATCH = 75879, 4, 50, 0.5, 512


def worker(root: str, reps: int) -> None:
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch
    from repro_torch.core import coverage as cov
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem
    from repro_torch.graph import csr, generators, weights

    dev = torch.device("cuda")
    src, dst = generators.barabasi_albert(N_NODES, BA_R, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, N_NODES, device=dev))
    out = {"root": root}
    for sketch_k in SKETCH_K:
        solver = IMMSolver(g, engine="queue", batch=BATCH, selection="celf",
                           sketch_k=sketch_k, seed=0, device=dev)
        solver.solve(IMProblem(k=K, eps=EPS))
        store = solver.store
        stats = {}
        res = cov.select_seeds_celf(store, K, stats_out=stats)  # warm-up
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store.select(K, method="celf")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(x.cpu().numpy()).tobytes()
            for x in (res.seeds, res.gains, res.frac))).hexdigest()[:16]
        out[str(sketch_k)] = {
            "select_s": times, "median_s": statistics.median(times),
            "stats_out": stats, "digest": digest,
            "pool": [store.n_rr, store.n_elems]}
        del solver, store
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root", nargs="?")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.reps)
        return 0
    if not args.other_root:
        ap.error("OTHER_ROOT is required")
    other = str(Path(args.other_root).resolve())
    runs = []
    for root in (other, str(ROOT), str(ROOT), other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root, "--reps",
             str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    digests = {(k, r[k]["digest"]) for r in runs for k in map(str, SKETCH_K)}
    if len(digests) != len(SKETCH_K):
        print(f"the checkouts' selections differ: {sorted(digests)}",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps({"order": ["other", "this", "this", "other"],
                      "median_s": {k: [r[k]["median_s"] for r in runs]
                                   for k in map(str, SKETCH_K)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
