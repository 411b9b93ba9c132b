#!/usr/bin/env python3
"""Solve the epinions-like stand-in with two checkouts on one card and
compare their results byte for byte.

    python3 examples/torch_solve_compare.py OTHER_ROOT

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each checkout runs in its own process, on the graph and settings
of ``chip_smoke.py`` (``barabasi_albert(75879, 4, seed=0)``, WC weights,
k = 50, eps = 0.5, batch 512, seed 0):

* the approximate solve of phase 4 (auto sketch, ``max_theta=8192``);
* the dense exact solve of phase 9 (``selection="bitset"``), then the
  ``flat`` selection on its final pool (the greedy that ``selection=
  "auto"`` takes on this graph);
* the packed sampler of phase 10 (512 lanes, round 0).

Each prints one JSON line: theta, RR sets, seeds, gains, the float32
bytes of frac (hex), the approximate solve's spread bounds, and a SHA-256
of the packed sampler's words, sizes and Occur.  The last lines are the
card's name and power limit and ``{"same": {...}}``, one flag a field;
the exit code is 1 when a field differs.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(root: str) -> None:
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch
    from repro_torch.core import dense
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem
    from repro_torch.core.rrset import round_seed
    from repro_torch.graph import csr, generators, weights
    dev = torch.device("cuda")
    src, dst = generators.barabasi_albert(75879, 4, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 75879, device=dev))

    def fields(res, **extra):
        return {"theta": res.stats.theta, "seeds": np.asarray(
                    res.seeds).tolist(), "gains": np.asarray(
                    res.gains).tolist(),
                "frac_f32": np.float32(res.frac).tobytes().hex(), **extra}

    out = {}
    approx = IMMSolver(g, engine="queue", batch=512, seed=0,
                       device=dev).solve(IMProblem(k=50, eps=0.5,
                                                   mode="approximate",
                                                   max_theta=8192))
    out["approximate"] = fields(approx,
                                spread_bounds=list(approx.spread_bounds))
    solver = IMMSolver(g, engine="dense", batch=512, selection="bitset",
                       seed=0, device=dev)
    exact = solver.solve(IMProblem(k=50, eps=0.5))
    out["dense_bitset"] = fields(exact, n_rr=solver.store.n_rr)
    flat = solver.store.select(50, method="flat")
    out["flat"] = {"seeds": flat.seeds.tolist(),
                   "gains": flat.gains.tolist(),
                   "frac_f32": flat.frac.cpu().numpy().astype(
                       np.float32).tobytes().hex()}
    ps = dense.sample_rrsets_dense_packed(csr.reverse(g), 512,
                                          round_seed(0, 0), base_seed=0)
    digest = hashlib.sha256()
    for t in (ps.words, ps.sizes, ps.occur):
        digest.update(t.cpu().numpy().tobytes())
    out["packed"] = {"levels": ps.levels, "sha256": digest.hexdigest()}
    print(json.dumps({"root": root, **out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    if args.other is None:
        ap.error("give the other checkout's root")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("torch_solve_compare: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi
    recs = []
    for root in (str(Path(args.other).resolve()), str(ROOT)):
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        recs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(recs[-1]), flush=True)
    print(nvidia_smi(), flush=True)
    same = {f"{part}.{key}": recs[0][part][key] == recs[1][part][key]
            for part in ("approximate", "dense_bitset", "flat", "packed")
            for key in recs[0][part]}
    print(json.dumps({"same": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
