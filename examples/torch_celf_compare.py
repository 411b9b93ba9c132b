#!/usr/bin/env python3
"""Time the CELF and the approximate selection of two checkouts on one card,
in turns.

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
the call, the whole selection as its caller waits for it; and the
``celf_select`` kernel alone (c = 32) by CUDA events over 20 launches,
``--reps`` times.  Then the approximate cell (the same stand-in,
``mode="approximate"``, ``max_theta`` 8,192: a 75,880 x 4 sketch): the
store's selection likewise, and the ``greedy_sketch`` kernel alone at
that sketch and at the first pool folded at sketch_k 1,024, 4,096 and
16,384 (W = 32, 128 and 512, chip_smoke's phase 8).

Each run prints one JSON line: its root, the times of each shape
(``select_s`` and ``kernel_ms``, every repetition, and their medians),
the CELF selection's ``stats_out`` and a digest of each selection's
seeds, gains and float32 ``frac`` and of each kernel's outputs (both
checkouts must agree).  The last lines are the card's name and power
limit and a JSON summary of the medians by run.
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
PROBE_SKETCH_K = (1024, 4096, 16384)
N_NODES, BA_R, K, EPS, BATCH = 75879, 4, 50, 0.5, 512
APPROX_MAX_THETA = 8192


def _digest(arrays) -> str:
    """A digest of tensors' or arrays' bytes."""
    import numpy as np
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(x.cpu().numpy() if hasattr(x, "cpu")
                             else np.asarray(x)).tobytes()
        for x in arrays)).hexdigest()[:16]


def _kernel_ms(fn, reps: int, iters: int = 20) -> list:
    """CUDA-event milliseconds a call of ``fn`` over ``iters`` back-to-back
    calls, ``reps`` times, after one warm-up call."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def _select_s(fn, reps: int) -> list:
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _entry(select_s, kernel_ms, **extra) -> dict:
    return dict(select_s=select_s, kernel_ms=kernel_ms,
                median_s=statistics.median(select_s) if select_s else None,
                kernel_median_ms=statistics.median(kernel_ms), **extra)


def worker(root: str, reps: int) -> None:
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.core import coverage as cov
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem
    from repro_torch.graph import csr, generators, weights
    from repro_torch.kernels import celf, greedy

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
        times = _select_s(lambda: store.select(K, method="celf"), reps)
        t = store.n_elems
        pool = (store.flat[:t], store.ids[:t], store.valid[:t])
        kw = dict(n=store.n_nodes, num_rows=store.row_capacity(), k=K, c=32)
        sk = store.sketch_words()
        kernel = _kernel_ms(lambda: celf.celf_select(*pool, sketch=sk, **kw),
                            reps)
        got = celf.celf_select(*pool, sketch=sk, **kw)
        out[str(sketch_k)] = _entry(
            times, kernel, stats_out=stats,
            digest=_digest((res.seeds, res.gains, res.frac)),
            kernel_digest=_digest(got[:3]), pool=[store.n_rr, store.n_elems])
        if sketch_k == SKETCH_K[0]:
            for probe in PROBE_SKETCH_K:
                words = sketch_mod.sketch_packed_from_flat(
                    *pool, n_rows=store.n_nodes + 1, k=probe, mode="mod")
                n = store.n_nodes
                ms = _kernel_ms(lambda: greedy.greedy_sketch(words, n=n,
                                                             k=K), reps)
                out[f"greedy_sketch_W{words.shape[1]}"] = _entry(
                    [], ms, kernel_digest=_digest(
                        greedy.greedy_sketch(words, n=n, k=K)))
                del words
        del solver, store, pool, sk
        torch.cuda.empty_cache()
    solver = IMMSolver(g, engine="queue", batch=BATCH, seed=0, device=dev)
    res = solver.solve(IMProblem(k=K, eps=EPS, mode="approximate",
                                 max_theta=APPROX_MAX_THETA))
    store = solver.store
    sel = store.select(K)                                     # warm-up
    times = _select_s(lambda: store.select(K), reps)
    words, n = store.words, store.n_nodes
    ms = _kernel_ms(lambda: greedy.greedy_sketch(words, n=n, k=K), reps)
    out["approximate"] = _entry(
        times, ms, digest=_digest((sel.seeds, sel.gains, sel.frac)),
        kernel_digest=_digest(greedy.greedy_sketch(words, n=n, k=K)),
        shape=list(words.shape), solve_seeds_digest=_digest((res.seeds,)))
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
    shapes = [key for key in runs[0] if key != "root"]
    digests = {(key, r[key].get("digest"), r[key]["kernel_digest"])
               for r in runs for key in shapes}
    if len(digests) != len(shapes):
        print(f"the checkouts' selections differ: {sorted(digests)}",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps({"order": ["other", "this", "this", "other"],
                      "median_s": {key: [r[key]["median_s"] for r in runs]
                                   for key in shapes},
                      "kernel_median_ms": {
                          key: [r[key]["kernel_median_ms"] for r in runs]
                          for key in shapes}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
