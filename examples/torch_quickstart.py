"""Quickstart of the torch port: solve influence maximization on a small
social graph, on the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py               # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.graph import csr, generators, weights
from repro_torch.core.imm import imm
from repro_torch.core import forward
from repro_torch.core.engine import list_engines, make_engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    # 1. a scale-free social graph with weighted-cascade probabilities
    src, dst = generators.barabasi_albert(2000, 4, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 2000, device=dev))
    print(f"graph: n={g.n_nodes} m={g.n_edges} on {g.device}")

    # 2. IMM with the queue engine
    print(f"registered engines: {list_engines()}")
    seeds, spread_est, stats = imm(g, k=10, eps=0.35, engine="queue",
                                   batch=512, seed=0, device=dev)
    print(f"seeds: {sorted(seeds.tolist())}")
    print(f"RIS spread estimate:  {spread_est:8.1f} "
          f"(theta={stats.theta}, rounds={stats.rounds})")

    # 2b. the engine protocol directly: one canonical RRBatch
    eng = make_engine("queue", csr.reverse(g), batch=8)
    batch = eng.sample(0)
    print(f"one RRBatch: {batch.n_sets} sets, "
          f"max size {int(batch.lengths.max())}, {batch.steps} micro-steps")

    # 3. validate with forward Monte-Carlo (Kempe-style simulation)
    mc = forward.ic_spread(g, seeds, n_sims=512, seed=7)
    print(f"forward MC spread:    {mc:8.1f}")
    # 4. compare against random seeds
    rnd = np.random.default_rng(0).choice(2000, size=10, replace=False)
    mc_rnd = forward.ic_spread(g, rnd, n_sims=512, seed=8)
    print(f"random-seed spread:   {mc_rnd:8.1f}  "
          f"(gIM advantage {mc / mc_rnd:.2f}x)")


if __name__ == "__main__":
    main()
