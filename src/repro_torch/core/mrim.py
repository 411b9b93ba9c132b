"""Multi-round influence maximization (paper §4.8; CR-NAIMM of Sun et
al.'18): the reference's ``repro.core.mrim``.

Influence propagates over T independent rounds; k seeds are picked *per
round* to maximize the number of nodes influenced at least once.  An RR
sample is T BFS from one random root, one a round, and each element is a
(node, round) pair, encoded ``round * n + node``, so the coverage
machinery runs unchanged on an item space of n·T
(:class:`~repro_torch.core.engine.MRIMEngine`: the T BFS are T adjacent
lanes of one queue round that share a root).  The cross-round greedy, which
masks a round once it has its k seeds, is the group quota of the variant
selections (``SelectionSpec(n_group=n, n_groups=T, group_quota=k)``), so
MRIM is ``IMMSolver.solve(IMProblem(k=k, t_rounds=T, ...))`` on any
selection.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.graph.csr import CSRGraph
from repro_torch.core import rrset as rr_queue
from repro_torch.core.engine import MRIMEngine
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem


def sample_mrim_round(g_rev: CSRGraph, batch: int, t_rounds: int,
                      seed32: int, qcap: int | None = None,
                      ec: int = rr_queue.EC_DEFAULT):
    """Sample ``batch`` MRIM RR sets (each T tagged BFS from a shared root)
    with round seed ``seed32``: a thin wrapper over :class:`MRIMEngine`.
    Returns (nodes (B, W) encoded ids, lengths (B,), overflowed (B,)) as
    numpy arrays."""
    eng = MRIMEngine(g_rev, MRIMEngine.Config(batch=batch, t_rounds=t_rounds,
                                              qcap=qcap, ec=ec))
    b = eng.sample(seed32)
    return (b.nodes.cpu().numpy(), b.lengths.cpu().numpy(),
            b.overflowed.cpu().numpy())


class MRIMResult(NamedTuple):
    seeds_per_round: list    # T lists of k node ids
    spread_estimate: float
    n_rr: int


def solve_mrim(g: CSRGraph, k: int, t_rounds: int, n_rr: int, *,
               qcap: int | None = None, batch: int = 64, seed: int = 0,
               selection: str = "auto", device="cuda") -> MRIMResult:
    """Fixed-θ MRIM solve, a thin wrapper over the problem API:
    ``IMMSolver(g, ...).solve(IMProblem(k=k, t_rounds=T, theta=n_rr))``
    (the paper's Table-3 experiment fixes θ; drop ``theta=`` from the
    problem to run the full Alg. 2 schedule)."""
    solver = IMMSolver(g, batch=batch, qcap=qcap, seed=seed,
                       selection=selection, device=device)
    res = solver.solve(IMProblem(k=k, t_rounds=t_rounds, theta=n_rr))
    return MRIMResult(seeds_per_round=res.seeds_per_round(),
                      spread_estimate=g.n_nodes * res.frac,
                      n_rr=res.stats.n_rr_sampled)
