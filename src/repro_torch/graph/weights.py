"""Edge influence-probability schemes (paper §4.2), on the input's device.

Weighted Cascade (WC) is the paper's scheme: p_uv = 1 / indeg(v).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, to_edges, from_edges


def wc_weights(g: CSRGraph) -> CSRGraph:
    """Weighted-cascade: p_uv = 1/indeg(v)."""
    src, dst, _ = to_edges(g)
    n = g.n_nodes
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    w = 1.0 / indeg[dst]
    return from_edges(src, dst, n, weights=w.astype(np.float32), sort=False,
                      device=g.device)


def uniform_weights(g: CSRGraph, p: float | None = None,
                    seed: int = 0) -> CSRGraph:
    """Constant p, or U(0,1) per edge when p is None (cuRipples' scheme)."""
    src, dst, _ = to_edges(g)
    m = src.shape[0]
    if p is None:
        rng = np.random.default_rng(seed)
        w = rng.uniform(size=m).astype(np.float32)
    else:
        w = np.full(m, p, dtype=np.float32)
    return from_edges(src, dst, g.n_nodes, weights=w, sort=False,
                      device=g.device)


def trivalency_weights(g: CSRGraph, seed: int = 0) -> CSRGraph:
    """Random choice of {0.1, 0.01, 0.001} per edge (TRIVALENCY scheme)."""
    src, dst, _ = to_edges(g)
    rng = np.random.default_rng(seed)
    w = rng.choice(np.asarray([0.1, 0.01, 0.001], dtype=np.float32),
                   size=src.shape[0])
    return from_edges(src, dst, g.n_nodes, weights=w, sort=False,
                      device=g.device)
