"""IM problem spec for the port: plain, weighted, budgeted and
candidate-restricted problems, exact or approximate.

:class:`IMProblem` keeps the reference's fields, validation, digests and
resolution (``repro.core.problem``), so a problem reads, validates and
hashes the same in both packages:

* **plain IM** — ``IMProblem(k=10, eps=0.3)``: uniform roots, top-k greedy;
* **weighted IM** — ``node_weights=w``: the engines draw roots ∝ ``w``
  through a Walker alias table (:mod:`repro_torch.core.roots`), so Eq. 3
  estimates ``Σ_v w_v · P[v influenced]`` on the scale ``Σ w``;
* **budgeted IM** — ``costs=c, budget=B`` in place of ``k``: cost-ratio
  greedy among affordable nodes until the budget is spent;
* **candidate-restricted IM** — ``candidates=mask_or_ids``: the argmax only
  ever picks inside the candidate set.

``mode`` is ``"exact"`` (the RR pool) or ``"approximate"`` (the pool-free
sketch store, which takes candidates but neither weights nor a budget);
``early_exit`` is the θ early exit of the LB loop; ``model`` is ``"ic"``
or ``"lt"`` (the linear-threshold model, paper §3.7), or None to take the
solver's.  ``t_rounds`` T makes it multi-round IM (MRIM, paper §4.8): k
seeds a round over T independent IC rounds, on the tagged item space of
n·T ids (exact mode, cardinality only).  Host-side spec and validation
only.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields
from typing import Any, Optional

import numpy as np

MODES = ("exact", "approximate")


def _as_node_array(x, n: int, name: str, dtype) -> np.ndarray:
    a = np.asarray(x, dtype=dtype)
    if a.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {a.shape}")
    return a


def candidates_mask(candidates, n: int) -> np.ndarray:
    """A candidate spec (a bool mask or node ids) as an (n,) bool mask."""
    a = np.asarray(candidates)
    if a.dtype == bool:
        if a.shape != (n,):
            raise ValueError(f"candidates mask must have shape ({n},), "
                             f"got {a.shape}")
        mask = a.copy()
    else:
        ids = a.astype(np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError("candidates must be non-empty")
        if (ids < 0).any() or (ids >= n).any():
            raise ValueError(f"candidate ids must lie in [0, {n})")
        mask = np.zeros(n, bool)
        mask[ids] = True
    if not mask.any():
        raise ValueError("candidates must select at least one node")
    return mask


def _digest_value(h: "hashlib._Hash", name: str, value) -> None:
    """Fold one field into a content hash: its name, then an array's dtype,
    shape and bytes or a scalar's repr, then a terminator, so that no two
    fields can alias."""
    h.update(name.encode())
    h.update(b"=")
    if value is None:
        h.update(b"None")
    elif isinstance(value, np.ndarray) or hasattr(value, "__array__") or \
            isinstance(value, (list, tuple)):
        a = np.asarray(value)
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    else:
        h.update(repr(value).encode())
    h.update(b";")


# the fields that change what the sampler produces, and so which engine and
# pool a solve needs: the model picks the engine, t_rounds the item space,
# node_weights the root distribution, mode the store.  Every other field
# changes only the selection or the θ schedule and can share a pool.
_POOL_FIELDS = ("model", "t_rounds", "node_weights", "mode")


@dataclass(frozen=True)
class IMProblem:
    """An influence-maximization problem (see the module docstring).

    Exactly one of ``k`` and ``budget`` is set; ``costs`` needs ``budget``
    (unit costs without it).  ``theta=`` pins the RR-pool size (no Alg. 2
    LB loop); ``max_theta`` caps it; ``ell`` is IMM's failure-probability
    exponent.  ``model`` may be ``None`` (inherit), ``"ic"`` or ``"lt"``.
    ``early_exit=True`` lets the LB loop skip the selection of an
    iteration that the coverage sketch proves cannot pass its test
    (``IMMSolver._early_exit_skip``), which changes neither θ nor the
    seeds.  ``candidates``, ``node_weights`` and ``costs`` are over the
    nodes ``[0, n)``.
    """
    k: Optional[int] = None
    eps: float = 0.5
    model: Optional[str] = None
    node_weights: Optional[Any] = None
    costs: Optional[Any] = None
    budget: Optional[float] = None
    candidates: Optional[Any] = None
    t_rounds: Optional[int] = None
    ell: float = 1.0
    max_theta: Optional[int] = None
    theta: Optional[int] = None
    early_exit: bool = False
    mode: str = "exact"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected 'exact' "
                             "or 'approximate'")
        if self.mode == "approximate":
            # the sketch store scores seeds on row counts alone; candidates
            # only mask its sweep
            if self.node_weights is not None:
                raise ValueError("mode='approximate' does not support "
                                 "node_weights (row-weighted pools need the "
                                 "exact store)")
            if self.budget is not None:
                raise ValueError("mode='approximate' does not support "
                                 "budget= (cost-ratio greedy needs exact "
                                 "marginals)")
            if self.t_rounds is not None:
                raise ValueError("mode='approximate' does not support "
                                 "t_rounds= (MRIM needs the tagged pool)")
        if (self.k is None) == (self.budget is None):
            raise ValueError("exactly one of k= (cardinality) or budget= "
                             "(budgeted IM) must be set")
        if self.k is not None and (not isinstance(self.k, (int, np.integer))
                                   or self.k < 1):
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        if self.budget is not None:
            if self.budget <= 0:
                raise ValueError("budget must be positive")
            if self.t_rounds is not None:
                raise ValueError("budgeted MRIM (budget= with t_rounds=) is "
                                 "not supported; give a per-round k instead")
        if self.costs is not None and self.budget is None:
            raise ValueError("costs= requires budget= (budgeted IM)")
        if self.t_rounds is not None and self.t_rounds < 1:
            raise ValueError("t_rounds must be >= 1")
        if self.model not in (None, "ic", "lt"):
            raise ValueError(f"unknown diffusion model {self.model!r}")
        if self.model == "lt" and self.t_rounds is not None:
            raise ValueError("MRIM sampling is IC-only (paper §4.8)")
        if not (0.0 < self.eps < 1.0):
            raise ValueError("eps must lie in (0, 1)")
        if self.theta is not None and self.theta < 1:
            raise ValueError("theta must be >= 1")

    @property
    def is_plain(self) -> bool:
        """True iff the problem is the plain top-k solve."""
        return (self.node_weights is None and self.budget is None
                and self.candidates is None and self.t_rounds is None)

    @property
    def variant(self) -> str:
        knobs = []
        if self.node_weights is not None:
            knobs.append("weighted")
        if self.budget is not None:
            knobs.append("budgeted")
        if self.candidates is not None:
            knobs.append("candidates")
        if self.t_rounds is not None:
            knobs.append("mrim")
        return "+".join(knobs) if knobs else "plain"

    def signature_digest(self) -> str:
        """sha256 of every field (arrays by dtype, shape and bytes): equal
        iff the problems are equal, in any process."""
        h = hashlib.sha256(b"IMProblem:")
        for f in fields(self):
            _digest_value(h, f.name, getattr(self, f.name))
        return h.hexdigest()

    def pool_digest(self, model: Optional[str] = None, *,
                    graph_digest: Optional[str] = None) -> str:
        """sha256 of the fields that decide the engine and pool a solve
        needs (:data:`_POOL_FIELDS`); ``model`` stands in for a problem's
        ``model=None``, and ``graph_digest`` mixes in the graph's identity.
        Problems with equal pool digests can share a solver's pool."""
        h = hashlib.sha256(b"IMPool:")
        vals = {f: getattr(self, f) for f in _POOL_FIELDS}
        if vals["model"] is None:
            vals["model"] = model
        for f in _POOL_FIELDS:
            _digest_value(h, f, vals[f])
        if graph_digest is not None:
            _digest_value(h, "graph", graph_digest)
        return h.hexdigest()

    def resolve(self, n: int) -> "ResolvedProblem":
        """Check the problem against a graph of ``n`` nodes and normalise
        its arrays: weights float32 non-negative, costs float32 positive,
        candidates an (n,) bool mask."""
        w = None
        if self.node_weights is not None:
            w = _as_node_array(self.node_weights, n, "node_weights",
                               np.float32)
            if (w < 0).any() or not np.isfinite(w).all() or w.sum() <= 0:
                raise ValueError("node_weights must be non-negative, finite, "
                                 "and not all zero")
        costs = None
        if self.budget is not None:
            costs = (_as_node_array(self.costs, n, "costs", np.float32)
                     if self.costs is not None
                     else np.ones(n, np.float32))
            if (costs <= 0).any() or not np.isfinite(costs).all():
                raise ValueError("costs must be positive and finite")
        cand = (candidates_mask(self.candidates, n)
                if self.candidates is not None else None)
        t = self.t_rounds if self.t_rounds is not None else 1
        n_items = n * t
        if self.budget is not None:
            feas_costs = costs[cand] if cand is not None else costs
            affordable = feas_costs[feas_costs <= self.budget]
            if affordable.size == 0:
                raise ValueError("no candidate node is affordable under "
                                 "the given budget")
            # no more seeds than the budget buys at the cheapest affordable
            # cost, and no more than the affordable nodes
            k_steps = int(min(len(affordable),
                              self.budget // float(affordable.min())))
            k_steps = max(k_steps, 1)
        else:
            k_steps = self.k * t
        scale = float(w.sum()) if w is not None else float(n)
        return ResolvedProblem(
            problem=self, n_nodes=n, n_items=n_items, t_rounds=t,
            k_steps=k_steps, node_weights=w, costs=costs, cand_mask=cand,
            scale=scale)


@dataclass(frozen=True)
class ResolvedProblem:
    """An :class:`IMProblem` checked against a graph: its normalised arrays
    and the sizes the solver and the selection consume."""
    problem: IMProblem
    n_nodes: int
    n_items: int                       # n * t_rounds (the coverage ids)
    t_rounds: int
    k_steps: int                       # selection scan length / most seeds
    node_weights: Optional[np.ndarray]
    costs: Optional[np.ndarray]
    cand_mask: Optional[np.ndarray]    # (n_nodes,) bool
    scale: float                       # Eq. 3 spread scale: Σw (or n)

    @property
    def cand_mask_items(self) -> Optional[np.ndarray]:
        """The candidate mask over the item space."""
        if self.cand_mask is None:
            return None
        return np.tile(self.cand_mask, self.t_rounds)


@dataclass
class IMResult:
    """Typed result of ``IMMSolver.solve(problem)``: ``seeds`` (int32),
    per-seed marginal coverage ``gains`` (int32 rows), the covered fraction
    ``frac`` of the pool and the Eq. 3 ``spread`` estimate ``scale *
    frac`` (``Σ node_weights`` for weighted problems, else n).  A budgeted
    solve stops when nothing affordable is left: ``len(seeds)`` is the
    seeds it bought and ``cost`` their total price.  An approximate solve
    also returns ``spread_bounds = (lo, hi)``, the certified bracket of
    the spread (``None`` for exact solves).  A solve whose deadline
    expired returns ``degraded=True`` and its certified ``spread_bounds``
    (``IMMSolver.solve_problem(deadline_s=...)``)."""
    seeds: np.ndarray
    spread: float
    gains: np.ndarray
    frac: float
    stats: Any
    problem: IMProblem
    n_nodes: int
    cost: float = 0.0
    degraded: bool = False
    spread_bounds: Optional[tuple] = None

    def seeds_per_round(self) -> list:
        """The seeds of each round, sorted (one list for a problem without
        ``t_rounds``)."""
        t = self.problem.t_rounds or 1
        n = self.n_nodes
        s = np.asarray(self.seeds)
        return [sorted((s[s // n == r] % n).tolist()) for r in range(t)]


def problem_state(p: IMProblem) -> dict:
    """A JSON-serialisable form of ``p`` (arrays as dtype-tagged lists);
    :func:`problem_from_state` rebuilds a problem with the same
    ``signature_digest``."""
    out = {}
    for f in fields(p):
        v = getattr(p, f.name)
        if v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            a = np.asarray(v)
            out[f.name] = {"__array__": True, "dtype": str(a.dtype),
                           "data": a.tolist()}
    return out


def problem_from_state(state: dict) -> IMProblem:
    kw = {}
    for name, v in state.items():
        if isinstance(v, dict) and v.get("__array__"):
            kw[name] = np.asarray(v["data"], dtype=np.dtype(v["dtype"]))
        else:
            kw[name] = v
    return IMProblem(**kw)
