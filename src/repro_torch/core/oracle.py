"""Pure-numpy serial oracles of the RIS/IMM pipeline, the port's own copy
of ``repro.core.oracle``:

* :func:`rr_set_ic` — one RR set under IC, a randomised reverse BFS;
* :func:`rr_set_lt` — one RR set under LT, a reverse random walk;
* :func:`greedy_max_coverage` and its weighted and budgeted forms — the
  exact greedy, ties to the lowest node id as the port's argmax;
* :func:`log_cnk` / :func:`imm_theta_params` — IMM's θ maths (Tang et al.
  2015), the same floats as the reference;
* :func:`imm_oracle` — serial IMM (Alg. 2, θ sampling, selection);
* :func:`forward_ic_spread` — forward Monte-Carlo spread, weighted or not.
"""
from __future__ import annotations

import math

import numpy as np


def rr_set_ic(offsets, indices, weights, root: int, rng: np.random.Generator):
    """Randomized BFS on the reverse graph CSR (pass the *reverse* CSR)."""
    visited = {int(root)}
    queue = [int(root)]
    head = 0
    while head < len(queue):
        u = queue[head]
        head += 1
        s, e = offsets[u], offsets[u + 1]
        if e > s:
            keep = rng.random(e - s) < weights[s:e]
            for v in indices[s:e][keep]:
                v = int(v)
                if v not in visited:
                    visited.add(v)
                    queue.append(v)
    return queue  # visit order; queue == RR set



def rr_set_lt(offsets, indices, weights, root: int, rng: np.random.Generator):
    """LT RR set: reverse walk picking at most one in-edge per node."""
    visited = {int(root)}
    walk = [int(root)]
    u = int(root)
    while True:
        s, e = offsets[u], offsets[u + 1]
        if e == s:
            return walk
        w = weights[s:e]
        r = rng.random()
        cum = np.cumsum(w)
        if r >= cum[-1]:
            return walk  # stopped: total prob <= 1
        j = int(np.searchsorted(cum, r, side="right"))
        v = int(indices[s + j])
        if v in visited:
            return walk
        visited.add(v)
        walk.append(v)
        u = v


def greedy_max_coverage(rr_sets: list[list[int]], n: int, k: int):
    """Exact greedy (ties -> lowest node id, matching the JAX argmax rule)."""
    occur = np.zeros(n, dtype=np.int64)
    node_to_rr: dict[int, list[int]] = {}
    for i, rr in enumerate(rr_sets):
        for v in rr:
            occur[v] += 1
            node_to_rr.setdefault(v, []).append(i)
    covered = np.zeros(len(rr_sets), dtype=bool)
    seeds = []
    n_covered = 0
    for _ in range(k):
        u = int(np.argmax(occur))
        seeds.append(u)
        for i in node_to_rr.get(u, []):
            if not covered[i]:
                covered[i] = True
                n_covered += 1
                for v in rr_sets[i]:
                    occur[v] -= 1
    frac = n_covered / max(len(rr_sets), 1)
    return seeds, frac



def greedy_max_coverage_weighted(rr_sets: list[list[int]], n: int, k: int,
                                 row_weights):
    """Weighted greedy reference: each RR row carries a weight (its root's
    node weight under the importance-weighted estimator); greedy maximizes
    the covered *weight* (ties -> lowest node id, matching the JAX argmax).
    Returns (seeds, covered_weight / total_weight)."""
    w = np.asarray(row_weights, dtype=np.float64)
    occur = np.zeros(n, dtype=np.float64)
    node_to_rr: dict[int, list[int]] = {}
    for i, rr in enumerate(rr_sets):
        for v in rr:
            occur[v] += w[i]
            node_to_rr.setdefault(v, []).append(i)
    covered = np.zeros(len(rr_sets), dtype=bool)
    seeds = []
    w_covered = 0.0
    for _ in range(k):
        u = int(np.argmax(occur))
        seeds.append(u)
        for i in node_to_rr.get(u, []):
            if not covered[i]:
                covered[i] = True
                w_covered += w[i]
                for v in rr_sets[i]:
                    occur[v] -= w[i]
    total = float(w.sum())
    return seeds, w_covered / max(total, 1e-300)



def budgeted_greedy_cost_ratio(rr_sets: list[list[int]], n: int, costs,
                               budget: float, candidates=None):
    """Budgeted IM reference: lazy-free cost-ratio greedy.  Picks the
    affordable candidate maximizing marginal-coverage / cost (ties ->
    lowest node id) until nothing affordable with positive gain remains.
    Returns (seeds, frac_covered, total_cost)."""
    costs = np.asarray(costs, dtype=np.float64)
    cand = (np.ones(n, bool) if candidates is None
            else np.asarray(candidates, bool))
    occur = np.zeros(n, dtype=np.float64)
    node_to_rr: dict[int, list[int]] = {}
    for i, rr in enumerate(rr_sets):
        for v in rr:
            occur[v] += 1.0
            node_to_rr.setdefault(v, []).append(i)
    covered = np.zeros(len(rr_sets), dtype=bool)
    seeds = []
    spent = 0.0
    n_covered = 0
    while True:
        feas = cand & (costs <= budget - spent) & (occur > 0)
        if not feas.any():
            break
        score = np.where(feas, occur / costs, -np.inf)
        u = int(np.argmax(score))
        seeds.append(u)
        spent += float(costs[u])
        for i in node_to_rr.get(u, []):
            if not covered[i]:
                covered[i] = True
                n_covered += 1
                for v in rr_sets[i]:
                    occur[v] -= 1.0
    frac = n_covered / max(len(rr_sets), 1)
    return seeds, frac, spent




def log_cnk(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def imm_theta_params(n: int, k: int, eps: float, ell: float = 1.0):
    """IMM's λ', λ* (Eqs. 9 & 6) with the ℓ adjustment; returns
    (λ', λ*, ε', ℓ)."""
    ell = ell * (1.0 + math.log(2) / math.log(n))
    eps_p = math.sqrt(2.0) * eps
    lcnk = log_cnk(n, k)
    lam_p = ((2.0 + 2.0 / 3.0 * eps_p)
             * (lcnk + ell * math.log(n) + math.log(math.log2(n)))
             * n / (eps_p ** 2))
    alpha = math.sqrt(ell * math.log(n) + math.log(2))
    beta = math.sqrt((1.0 - 1.0 / math.e) * (lcnk + ell * math.log(n) + math.log(2)))
    lam_star = 2.0 * n * (((1.0 - 1.0 / math.e) * alpha + beta) ** 2) / (eps ** 2)
    return lam_p, lam_star, eps_p, ell


def imm_oracle(offsets_rev, indices_rev, weights_rev, n: int, k: int,
               eps: float, seed: int = 0, model: str = "ic",
               max_theta: int | None = None):
    """Serial IMM under IC (``model="ic"``) or LT (any other model).
    Returns (seeds, rr_sets, theta)."""
    rng = np.random.default_rng(seed)
    lam_p, lam_star, eps_p, _ = imm_theta_params(n, k, eps)
    sample = rr_set_ic if model == "ic" else rr_set_lt

    def draw(count):
        return [sample(offsets_rev, indices_rev, weights_rev,
                       int(rng.integers(n)), rng) for _ in range(count)]

    rr_sets: list[list[int]] = []
    lb = 1.0
    for i in range(1, max(int(math.log2(n)), 2)):
        x = n / (2.0 ** i)
        theta_i = int(math.ceil(lam_p / x))
        if max_theta:
            theta_i = min(theta_i, max_theta)
        if len(rr_sets) < theta_i:
            rr_sets += draw(theta_i - len(rr_sets))
        seeds, frac = greedy_max_coverage(rr_sets, n, k)
        if n * frac >= (1.0 + eps_p) * x:
            lb = n * frac / (1.0 + eps_p)
            break
    theta = int(math.ceil(lam_star / lb))
    if max_theta:
        theta = min(theta, max_theta)
    if len(rr_sets) < theta:
        rr_sets += draw(theta - len(rr_sets))
    seeds, frac = greedy_max_coverage(rr_sets, n, k)
    return seeds, rr_sets, theta


def forward_ic_spread(offsets, indices, weights, seeds, rng,
                      n_sims: int = 200, node_weights=None):
    """Forward Monte-Carlo spread under IC on the *forward* CSR (oracle).

    Unweighted: E[|I(S)|].  With ``node_weights``: the weight-aware spread
    ``E[Σ_{v ∈ I(S)} w_v]`` — the objective of weighted IM, used as the
    conformance reference for the weight-proportional RIS estimator.
    """
    n = len(offsets) - 1
    w = None if node_weights is None else np.asarray(node_weights,
                                                     dtype=np.float64)
    total = 0.0
    for _ in range(n_sims):
        active = set(int(s) for s in seeds)
        queue = list(active)
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            s, e = offsets[u], offsets[u + 1]
            if e > s:
                keep = rng.random(e - s) < weights[s:e]
                for v in indices[s:e][keep]:
                    v = int(v)
                    if v not in active:
                        active.add(v)
                        queue.append(v)
        total += (len(active) if w is None
                  else float(w[np.fromiter(active, int)].sum()))
    return total / n_sims
