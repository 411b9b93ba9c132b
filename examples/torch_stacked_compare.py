#!/usr/bin/env python3
"""Time ``greedy_stacked`` of two checkouts on one card, in turns.

    python3 examples/torch_stacked_compare.py OTHER_ROOT [--iters 30]

OTHER_ROOT is another checkout of this repository (say one with another
design of ``csrc/greedy.cu``'s ``greedy_stacked``, unpacked into a
directory that ``.gitignore`` lists).  Each checkout builds its own
``csrc/greedy.cu`` and runs in its own process, in the order other, this,
this, other, so that a drift of the card's clocks shows as a difference
between the two runs of one tree.  Each run samples the stand-in's default
exact pool (``chip_smoke.py`` phase 5's solve) and times, with CUDA events
over ``--iters`` calls after one warm-up, ``ops.greedy_stacked`` at each of
``chip_smoke.py``'s ``STACKED_BATCHES`` on that pool and at phase 18's
batch of eight requests at θ = 7,101 (``record-8``).  Both checkouts must
give the same bytes (the ``digest`` of each call's seeds, gains and
spent).  The last lines are the card's ``nvidia-smi`` name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ONE_RUN = r'''
import hashlib, importlib.util, json, sys
from pathlib import Path
root, iters = Path(sys.argv[1]), int(sys.argv[2])
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              root / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
from repro_torch.core import coverage as cov
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ops
dev = torch.device("cuda")
src, dst = generators.barabasi_albert(smoke.N_NODES, smoke.BA_R, seed=0)
g = weights.wc_weights(csr.from_edges(src, dst, smoke.N_NODES, device=dev))


def run(store, reqs, geometry):
    args, _ = smoke.pool_args(store)
    kw = cov.stacked_operands(store, reqs, **geometry)
    got = ops.greedy_stacked(*args, **kw)
    digest = [hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
              for x in got]
    return smoke.cuda_ms(lambda: ops.greedy_stacked(*args, **kw),
                         iters), digest


solver = IMMSolver(g, engine="queue", batch=smoke.BATCH, seed=0, device=dev)
solver.solve(IMProblem(k=smoke.K, eps=smoke.EPS))
n = solver.store.n_nodes
ms, digests = {}, []
for rows, mix in smoke.STACKED_BATCHES:
    t, d = run(solver.store, smoke.stacked_requests(n, rows, mix),
               smoke.stacked_geometry(n))
    ms[f"{rows}-{mix}"] = t
    digests.append(d)
theta = smoke.EXACT_POOL["theta"]
stk = IMMSolver(g, engine="queue", batch=smoke.BATCH, seed=0, device=dev)
probs = smoke.stacked_problems(n, theta)[:-1]
reqs, geometry = stk.stacked_requests([stk.prepare(p) for p in probs])
stk.sample_until(theta)
ms["record-8"], d = run(stk.store, reqs, geometry)
digests.append(d)
print(json.dumps({"ms": ms, "digest": digests}))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--iters", type=int, default=30)
    a = ap.parse_args()
    runs = []
    for name, root in (("other", a.other), ("this", ROOT), ("this", ROOT),
                       ("other", a.other)):
        proc = subprocess.run([sys.executable, "-c", ONE_RUN,
                               str(root.resolve()), str(a.iters)],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(line)
        print(name, json.dumps(line["ms"]), flush=True)
    same = all(r["digest"] == runs[0]["digest"] for r in runs)
    print(json.dumps({"same_bytes": same}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
