"""Forward Monte-Carlo influence spread under IC and LT (Kempe et al.'s
method): the check on RIS estimates, E[I(S)] = n · Pr[S ∩ RR ≠ ∅]
(Eq. 3).

One row per simulation; the random numbers come from a
``torch.Generator`` seeded by the caller, so no global RNG state is read
or changed: under IC one uniform per (simulation, edge) a step, under LT
one threshold per (simulation, node).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph


def ic_sizes(g: CSRGraph, seeds, n_sims: int = 256, seed: int = 0,
             node_weights=None) -> torch.Tensor:
    """(n_sims,) int64 activated-set sizes of forward IC runs from
    ``seeds`` on the forward CSR ``g`` (on ``g``'s device); with
    ``node_weights`` (n,) the float32 weight of each run's active set,
    ``active.float() @ w``, the objective of weighted IM."""
    dev = g.device
    n, m = g.n_nodes, g.n_edges
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    deg = (g.offsets[1:] - g.offsets[:-1]).to(torch.int64)
    edge_src = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    edge_dst = g.indices.to(torch.int64)
    active = torch.zeros(n_sims, n, dtype=torch.bool, device=dev)
    active[:, torch.as_tensor(seeds, device=dev).to(torch.int64)] = True
    frontier = active.clone()
    while bool(frontier.any()):
        u = torch.rand((n_sims, m), generator=gen, device=dev)
        live = (frontier[:, edge_src] & (u < g.weights)).to(torch.int32)
        hit = torch.zeros(n_sims, n, dtype=torch.int32,
                          device=dev).index_add_(1, edge_dst, live)
        frontier = (hit > 0) & ~active
        active |= frontier
    if node_weights is None:
        return active.sum(dim=1)
    w = torch.as_tensor(np.asarray(node_weights, np.float32), device=dev)
    return active.to(torch.float32) @ w


def ic_spread(g: CSRGraph, seeds, n_sims: int = 256, seed: int = 0,
              node_weights=None) -> float:
    """Forward IC E[I(S)] estimate on the forward CSR (E[Σ_{v ∈ I(S)} w_v]
    with ``node_weights``)."""
    return float(ic_sizes(g, seeds, n_sims, seed, node_weights).to(
        torch.float64).mean())


def lt_sizes(g: CSRGraph, seeds, n_sims: int = 256,
             seed: int = 0) -> torch.Tensor:
    """(n_sims,) int64 activated-set sizes of forward LT runs from ``seeds``
    on the forward CSR ``g`` (on ``g``'s device), the reference's threshold
    dynamics (Eq. 1): each (simulation, node) draws a threshold τ uniform in
    [0, 1), and a node turns active once the float32 sum of the weights of
    its active in-neighbours' edges reaches τ; the runs go on until no node
    turns."""
    dev = g.device
    n = g.n_nodes
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    deg = (g.offsets[1:] - g.offsets[:-1]).to(torch.int64)
    edge_src = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    edge_dst = g.indices.to(torch.int64)
    tau = torch.rand((n_sims, n), generator=gen, device=dev)
    active = torch.zeros(n_sims, n, dtype=torch.bool, device=dev)
    active[:, torch.as_tensor(seeds, device=dev).to(torch.int64)] = True
    while True:
        contrib = torch.where(active[:, edge_src], g.weights, 0.0)
        mass = torch.zeros(n_sims, n, dtype=torch.float32,
                           device=dev).index_add_(1, edge_dst, contrib)
        new = active | (mass >= tau)
        if torch.equal(new, active):
            return active.sum(dim=1)
        active = new


def lt_spread(g: CSRGraph, seeds, n_sims: int = 256, seed: int = 0) -> float:
    """Forward LT E[I(S)] estimate on the forward CSR."""
    return float(lt_sizes(g, seeds, n_sims, seed).to(torch.float64).mean())
