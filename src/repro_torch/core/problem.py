"""IM problem spec for the port: plain problems, exact or approximate.

:class:`IMProblem` keeps the reference's fields (``repro.core.problem``), so
a problem reads the same in both packages.  ``mode`` is ``"exact"`` (the RR
pool) or ``"approximate"`` (the pool-free sketch store); ``early_exit`` is
the θ early exit of the LB loop.  The variant fields
are not ported yet: setting one raises ``NotImplementedError`` naming the
ROADMAP item that brings it, in either mode.  Host-side spec and validation
only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

# field -> (value that keeps the problem plain, ROADMAP item that ports it)
_NOT_PORTED = {
    "node_weights": (None, "Queue 1 item 7 (weighted roots)"),
    "costs": (None, "Queue 1 item 7 (budgeted greedy)"),
    "budget": (None, "Queue 1 item 7 (budgeted greedy)"),
    "candidates": (None, "Queue 1 item 7 (candidates)"),
    "t_rounds": (None, "Queue 1 item 7 (MRIM)"),
}
MODES = ("exact", "approximate")


@dataclass(frozen=True)
class IMProblem:
    """Plain influence maximization: pick ``k`` seeds at accuracy ``eps``.

    ``theta=`` pins the RR-pool size (no Alg. 2 LB loop); ``max_theta``
    caps it; ``ell`` is IMM's failure-probability exponent.  ``model`` may
    be ``None`` (inherit) or ``"ic"``; ``"lt"`` waits for ROADMAP Queue 1
    item 7.  ``mode="approximate"`` samples into per-node coverage sketches
    instead of a pool and returns certified ``spread_bounds``.
    ``early_exit=True`` lets the Alg. 2 LB loop skip the selection of an
    iteration that the coverage sketch proves cannot pass its test
    (``IMMSolver._early_exit_skip``), which changes neither θ nor the seeds.
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
        for name, (plain, item) in _NOT_PORTED.items():
            v = getattr(self, name)
            if (v is not None) if plain is None else (v != plain):
                raise NotImplementedError(
                    f"IMProblem({name}=...) is not ported yet: ROADMAP {item}")
        if self.model == "lt":
            raise NotImplementedError(
                "IMProblem(model='lt') is not ported yet: ROADMAP Queue 1 "
                "item 7 (lt engine)")
        if self.model not in (None, "ic"):
            raise ValueError(f"unknown diffusion model {self.model!r}")
        if self.k is None:
            raise ValueError("k= (the number of seeds) must be set")
        if not isinstance(self.k, (int, np.integer)) or self.k < 1:
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        if not (0.0 < self.eps < 1.0):
            raise ValueError("eps must lie in (0, 1)")
        if self.theta is not None and self.theta < 1:
            raise ValueError("theta must be >= 1")

    def resolve(self, n: int) -> "ResolvedProblem":
        """Sizes for a graph of ``n`` nodes."""
        return ResolvedProblem(problem=self, k_steps=int(self.k),
                               scale=float(n))


@dataclass(frozen=True)
class ResolvedProblem:
    """An :class:`IMProblem` checked against a graph: the sizes the solver
    and the selection consume."""
    problem: IMProblem
    k_steps: int          # selection scan length
    scale: float          # Eq. 3 spread scale (n)


@dataclass
class IMResult:
    """Typed result of ``IMMSolver.solve(problem)``: ``seeds`` (int32),
    per-seed marginal coverage ``gains`` (int32 rows), the covered fraction
    ``frac`` of the pool and the Eq. 3 ``spread`` estimate ``n * frac``.
    An approximate solve also returns ``spread_bounds = (lo, hi)``, the
    certified bracket of the spread (``None`` for exact solves)."""
    seeds: np.ndarray
    spread: float
    gains: np.ndarray
    frac: float
    stats: Any
    problem: IMProblem
    n_nodes: int
    spread_bounds: Optional[tuple] = None
