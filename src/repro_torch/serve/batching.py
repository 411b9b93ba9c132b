"""Micro-batch execution: N compatible requests on one warm solver (the
reference's ``repro.serve.batching``).

A batch is a list of problems that share the solver's pool signature
(model, ``t_rounds``, ``node_weights``, ``mode``) and θ mode; they may
differ in everything on the selection side: ``k``, ``candidates``,
``costs`` + ``budget``, ``eps``/``ell``/``max_theta``.  The batch samples
the pool once and shares it.

* Top-1 requests (``k=1``, fixed θ, no budget, rounds or row weights) need
  no greedy scan: the first pick is the argmax of the Occur histogram,
  masked to the candidates, its gain is ``Occur[u]``, ties go to the
  lowest id.  The batch computes Occur once (one device read) and answers
  every such request from it, with the scan's single float32 division for
  ``F_R``, so the result equals a full solve's.
* Two or more other fixed-θ requests share one stacked selection
  (:meth:`~repro_torch.core.imm.IMMSolver.solve_stacked`, one
  ``greedy_stacked`` launch on the card).
* Everything else goes through ``solve_problem``, which reuses the pool.

Every route gives the solo solve's result, so ``stacked`` is a
throughput knob only.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem, IMResult, ResolvedProblem


def occur_fastpath_eligible(solver: IMMSolver, p: IMProblem) -> bool:
    """True iff the request's selection is exactly the argmax of (masked)
    Occur: one seed, fixed θ, a counting objective (no budget, no rounds'
    groups, no row-weighted estimator; roots drawn by weight are fine) on
    the exact pool."""
    return (p.theta is not None and p.k == 1 and p.t_rounds is None
            and p.budget is None and p.mode != "approximate"
            and not solver._row_weight_mode)


def _store_occur(store) -> np.ndarray:
    """(n,) int32 Occur of the store's pool on the host: the reference's
    plain scatter-add of the valid elements onto their nodes (ids at n or
    past it count nowhere)."""
    t = store.n_elems
    flat = store.flat[:t].to(torch.int64)
    occur = torch.zeros(store.n_nodes + 1, dtype=torch.int32,
                        device=flat.device).index_add_(
        0, flat.clamp(max=store.n_nodes), store.valid[:t].to(torch.int32))
    return occur[:store.n_nodes].cpu().numpy()


def _solve_from_occur(solver: IMMSolver, r: ResolvedProblem,
                      occur: np.ndarray, n_rr: int) -> Optional[IMResult]:
    """Answer a top-1 request from the shared Occur histogram as the scan
    would (ties to the lowest id; gain ``Occur[u]``, as nothing is covered
    before the first pick; ``F_R`` one float32 division).  None when no
    candidate is feasible (the caller falls back to the full solve)."""
    p = r.problem
    mask = r.cand_mask_items
    if mask is None:
        u = int(np.argmax(occur))
    else:
        # select_variant's pick: -1 on infeasible ids, ok iff >= 0
        masked = np.where(mask, occur, np.int32(-1))
        u = int(np.argmax(masked))
        if masked[u] < 0:
            return None
    gain = int(occur[u])
    frac = float(np.float32(np.float32(gain) / np.float32(max(n_rr, 1))))
    st = solver._stats
    st.theta = p.theta
    st.lb = 1.0
    st.frac_covered = frac
    st.variant = p.variant
    st.budget_spent = 0.0
    return IMResult(seeds=np.array([u], np.int32), spread=r.scale * frac,
                    gains=np.array([gain], np.int32), frac=frac,
                    stats=solver.stats, problem=p, n_nodes=solver.n,
                    cost=0.0)


def stacked_eligible(solver: IMMSolver, p: IMProblem) -> bool:
    """True iff the request can ride the batch's stacked selection: fixed
    θ (one pool state, no LB loop) and an objective the stacked scan
    expresses (exact mode, no row-weighted estimator)."""
    return (p.theta is not None and p.mode != "approximate"
            and not solver._row_weight_mode)


def execute_batch(solver: IMMSolver, problems: List[IMProblem],
                  deadlines: Optional[List[Optional[float]]] = None,
                  *, stacked: bool = True,
                  stats_out: Optional[dict] = None) -> List[IMResult]:
    """Run one micro-batch on a warm solver; the results are aligned with
    ``problems`` (see the module docstring for the routes).

    ``deadlines`` (aligned with ``problems``): each request's remaining
    seconds, passed to ``solve_problem(deadline_s=...)``; a request with
    one goes solo (the stacked scan has no point to degrade at), and its
    solve may return the degraded answer or raise ``DeadlineExceeded``;
    the fast path ignores it, as the reference's does.  ``stats_out`` gains the
    ``stacked_batches``/``stacked_requests`` counters when the stacked
    path runs."""
    if not problems:
        return []
    if deadlines is None:
        deadlines = [None] * len(problems)
    occur = None          # the shared histogram, read at most once a batch
    n_rr = 0
    results: List[Optional[IMResult]] = [None] * len(problems)
    stack_idx: List[int] = []
    for i, (p, dl) in enumerate(zip(problems, deadlines)):
        if occur_fastpath_eligible(solver, p):
            r = solver.prepare(p)
            if occur is None:
                solver.sample_until(p.theta)
                occur = _store_occur(solver.store)
                n_rr = solver.store.n_rr
            res = _solve_from_occur(solver, r, occur, n_rr)
            if res is not None:
                results[i] = res
                continue
        if stacked and dl is None and stacked_eligible(solver, p):
            stack_idx.append(i)
            continue
        results[i] = solver.solve_problem(p, deadline_s=dl)
    # by θ, so a hand-built batch of several fixed θs still stacks a θ at
    # a time
    groups: dict = {}
    for i in stack_idx:
        groups.setdefault(problems[i].theta, []).append(i)
    for idx in groups.values():
        if len(idx) < 2:
            i = idx[0]
            results[i] = solver.solve_problem(problems[i])
            continue
        for i, res in zip(idx, solver.solve_stacked(
                [problems[i] for i in idx])):
            results[i] = res
        if stats_out is not None:
            stats_out["stacked_batches"] = \
                stats_out.get("stacked_batches", 0) + 1
            stats_out["stacked_requests"] = \
                stats_out.get("stacked_requests", 0) + len(idx)
    return results
