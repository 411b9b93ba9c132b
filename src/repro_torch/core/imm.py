"""IMM solver (paper Alg. 2 + θ sampling + seed selection) for IC and LT
problems, on one device.

    IMMSolver(g, device="cuda").solve(IMProblem(k=10, eps=0.3))
    IMMSolver(g).solve(IMProblem(k=10, eps=0.3, mode="approximate"))
    IMMSolver(g).solve(IMProblem(k=10, eps=0.3, node_weights=w))  # weighted
    IMMSolver(g).solve(IMProblem(eps=0.3, costs=c, budget=B))     # budgeted
    IMMSolver(g).solve(IMProblem(k=10, eps=0.3, candidates=ids))  # targeted
    IMMSolver(g, model="lt").solve(IMProblem(k=10, eps=0.3))      # LT model
    IMMSolver(g).solve(IMProblem(k=3, t_rounds=4, theta=4096))    # MRIM
    IMMSolver(g, engine="refill").solve(IMProblem(k=10, eps=0.3)) # Alg. 6
    IMMSolver(g).solve_stacked([IMProblem(k=5, theta=4096),       # batched
                                IMProblem(k=3, theta=4096, candidates=ids)])
    IMMSolver(g, engine=make_engine("queue", reverse(g))).solve(
        IMProblem(k=10, eps=0.3, node_weights=w))     # row-weighted estimator

The host runs rounds of RR batches against the engine (gIM's kernel
relaunches, Alg. 6): round t samples with the 32-bit seed
``round_seed(seed, t)``, so a solve is a pure function of (graph, options,
seed) and holds no global RNG state.  Every round is
``engine.sample`` → ``store.append_batch``; the loop condition reads the
store's exact host row count.  θ comes from the reference's maths
(:func:`repro_torch.core.oracle.imm_theta_params`), so both packages walk
the same θ schedule for the same spread estimates.

The store follows the problem's mode (:meth:`IMMSolver.prepare`): an exact
problem samples into a :class:`~repro_torch.core.coverage.DeviceRRStore`, an
approximate one into a :class:`~repro_torch.core.coverage.SketchRRStore`
through a :class:`~repro_torch.core.engine.FusedSketchEngine`, selects with
``select_seeds_sketch`` and returns certified ``spread_bounds``.

The variants follow the reference: a weighted problem draws its roots ∝
``node_weights`` (the engine's alias table) and spreads on the scale ``Σ
w``; candidates and a budget turn the selection into the variant greedy
(:func:`~repro_torch.core.coverage.select_variant`, the CELF variant, or
the sketch greedy's candidate mask), and a budgeted problem walks the θ
schedule of its ``k_steps``.  The engine and store are keyed on the
problem's ``pool_digest``, so problems that differ only in selection
share a pool.

``engine`` may also be a ready engine instance, as the reference allows.
A weighted problem on an instance that does not draw its roots ∝ the
problem's weights runs the importance-weighted estimator instead (row-weight
mode): uniform roots, each row weighted by its root's weight in a
row-weighted store, and the weighted selection (``SelectionSpec(weighted=
True)``), so the spread is ``Σ w`` times the covered share of the rows'
total weight.  ``model="lt"`` (on the solver or the problem) samples the
linear-threshold model's RR walks with the ``lt`` engine.  A problem with
``t_rounds`` T (MRIM) samples with the ``mrim`` engine (T tagged BFS a row)
and selects k seeds a round: the group quotas of the variant greedy
(``SelectionSpec(n_group=n, n_groups=T, group_quota=k)``).  A tagged
engine *instance* waits for its first problem, which must carry the
matching ``t_rounds``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, reverse
from repro_torch.core import coverage as cov
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.engine import (FusedSketchEngine, make_engine,
                                     resolve_engine_name)
from repro_torch.core.oracle import imm_theta_params
from repro_torch.core.problem import IMProblem, IMResult, ResolvedProblem
from repro_torch.core.rrset import round_seed
from repro_torch.device import resolve_device


@dataclass
class IMMStats:
    theta: int = 0
    n_rr_sampled: int = 0
    lb: float = 1.0
    lb_iters: int = 0
    rounds: int = 0
    overflow_fraction: float = 0.0
    frac_covered: float = 0.0
    sampling_steps: int = 0
    selection: str = "auto"
    variant: str = "plain"
    early_exit_skips: int = 0
    budget_spent: float = 0.0
    history: list = field(default_factory=list)


# user-facing selection knob -> DeviceRRStore.select method
_SELECTION_METHODS = {"auto": "auto", "fused": "flat", "flat": "flat",
                      "bitset": "bitset", "celf-sketch": "celf",
                      "celf": "celf"}


class IMMSolver:
    """Stateful solver: owns the RR pool, so Alg. 2 reuses earlier samples
    and repeated solves on one solver keep growing one pool.

    ``engine`` names a registered engine (``batch``/``qcap``/``ec`` go to
    its config) or is a ready engine instance, which owns its graph and
    configuration, so ``batch``/``qcap``/``ec``/``model`` given with one
    raise ``ValueError``.  ``model="lt"`` takes the ``lt`` engine for
    problems that leave ``model`` None.  ``selection`` is ``auto``,
    ``fused`` (= ``flat``), ``bitset`` or ``celf`` (= ``celf-sketch``, the
    lazy greedy with ``eval_batch`` candidates an exact evaluation) for
    exact problems.
    ``sketch_k`` sizes the sketch of approximate problems (default
    ``auto_sketch_k(eps, n)``) and the exact store's incremental sketch,
    which ``celf`` and ``early_exit`` need (default
    ``DeviceRRStore.DEFAULT_SKETCH_K``), as the reference's.  The graph
    moves to ``device`` (default ``"cuda"``, which raises when there is no
    card).
    """

    def __init__(self, g: CSRGraph, *, engine="queue",
                 batch: Optional[int] = None, qcap: Optional[int] = None,
                 ec: Optional[int] = None, model: Optional[str] = None,
                 selection: str = "auto", seed: int = 0,
                 sketch_k: Optional[int] = None,
                 eval_batch: Optional[int] = None, device="cuda"):
        if model not in (None, "ic", "lt"):
            raise ValueError(f"unknown diffusion model {model!r}")
        named = isinstance(engine, str)
        if not named and any(v is not None for v in (batch, qcap, ec, model)):
            raise ValueError(
                "batch/qcap/ec/model have no effect when an engine instance "
                "is passed; configure the engine instead")
        if selection not in _SELECTION_METHODS:
            raise ValueError(f"unknown selection {selection!r}; one of "
                             f"{sorted(_SELECTION_METHODS)}")
        if named and engine == "mrim":
            # the tagged engine's item space is n*t_rounds, not the graph's
            # n nodes: MRIM goes through IMProblem(t_rounds=...), which
            # picks the engine itself
            raise ValueError(
                "engine 'mrim' samples a tagged item space, not the "
                "graph's nodes; set t_rounds= on the IMProblem instead "
                "(the solver resolves the mrim engine per problem)")
        if eval_batch is not None and int(eval_batch) < 1:
            raise ValueError("eval_batch must be >= 1")
        self.eval_batch = None if eval_batch is None else int(eval_batch)
        self.device = resolve_device(device)
        self.g = g.to(self.device)
        self.n = self.g.n_nodes
        self.selection = selection
        self._sel_method = _SELECTION_METHODS[selection]
        self.seed = int(seed)
        self._sketch_k_arg = sketch_k
        self._engine_arg = engine
        self._model_arg = model
        self._engine_opts = dict(batch=batch, qcap=qcap, ec=ec)
        # an instance owns its reverse graph
        self.g_rev = (reverse(self.g) if named
                      else getattr(engine, "g_rev", None))
        self._plain_engines = {}      # unweighted named engines, by name
        self._sketch_info = None
        self._sig = None
        self._row_weight_mode = False
        self._node_w = None
        self.engine = self.store = None
        self.engine_name = None
        if named or (engine.item_space == self.n
                     and getattr(engine, "root_weights", None) is None):
            # a weighted-root instance waits for its first (weighted)
            # problem, as the reference's
            self.prepare(IMProblem(k=1))

    def _default_model(self) -> str:
        return "lt" if self._model_arg == "lt" else "ic"

    # -- engine + store per problem signature ------------------------------
    def _engine_name(self, problem: IMProblem, model: str) -> str:
        """The named engine a problem samples with: ``mrim`` for MRIM, the
        ``lt`` engine for the LT model, else the solver's."""
        if problem.t_rounds is not None:
            return "mrim"
        return resolve_engine_name(self._engine_arg, model)

    def _engine_for(self, r: ResolvedProblem, model: str):
        """(engine, row-weight mode) for a problem: a named engine (the
        ``lt`` one for the LT model) with the alias table of the problem's
        weights, or the instance, in row-weight mode when the problem's
        weights are not the ones its roots are drawn by."""
        w = r.node_weights
        if isinstance(self._engine_arg, str):
            name = self._engine_name(r.problem, model)
            if r.problem.t_rounds is not None:
                return make_engine(name, self.g_rev, root_weights=w,
                                   t_rounds=r.problem.t_rounds,
                                   **self._engine_opts), False
            if w is not None:
                return make_engine(name, self.g_rev, root_weights=w,
                                   **self._engine_opts), False
            if name not in self._plain_engines:
                self._plain_engines[name] = make_engine(
                    name, self.g_rev, **self._engine_opts)
            return self._plain_engines[name], False
        engine = self._engine_arg
        eng_w = getattr(engine, "root_weights", None)
        if w is None and eng_w is not None:
            # a plain solve on roots drawn ∝ the engine's weights would
            # return the weighted objective on the uniform scale
            raise ValueError(
                "engine instance draws weighted roots (root_weights set) but "
                "the problem has no node_weights; set node_weights on the "
                "IMProblem (or use an unweighted engine)")
        row_weight_mode = w is not None and not (
            eng_w is not None
            and np.array_equal(np.asarray(eng_w, np.float32), w))
        return engine, row_weight_mode

    def _build(self, r: ResolvedProblem, sig, model: str) -> None:
        """Fresh engine, store and stats for the signature (pool digest,
        sketch_k): the round-seed stream restarts at round 0.  A weighted
        problem gets an engine with the alias table of its weights, or on
        an instance that does not draw by them a row-weighted store."""
        problem, sketch_k = r.problem, sig[-1]
        engine, row_weight_mode = self._engine_for(r, model)
        if engine.item_space != r.n_items:
            raise ValueError(
                f"engine {getattr(engine, 'name', '?')!r} samples an item "
                f"space of {engine.item_space}, not the problem's "
                f"{r.n_items} items; tagged engines need a matching "
                f"t_rounds= on the IMProblem")
        self.engine_name = getattr(engine, "name", type(engine).__name__)
        if problem.mode == "approximate":
            self.engine = FusedSketchEngine(engine)
            self.store = cov.SketchRRStore(engine.item_space,
                                           sketch_k=sketch_k,
                                           device=self.device)
        else:
            self.engine = engine
            self.store = cov.DeviceRRStore(engine.item_space,
                                           sketch_k=sketch_k,
                                           row_weighted=row_weight_mode,
                                           device=self.device)
        self._row_weight_mode = row_weight_mode
        self._node_w = (torch.from_numpy(r.node_weights).to(self.device)
                        if row_weight_mode else None)
        self._sig = sig
        self._stats = IMMStats(selection=self.selection,
                               variant=problem.variant)
        self._ovf = torch.zeros((), dtype=torch.int64, device=self.device)
        self._ovf_lanes = 0

    def prepare(self, problem: IMProblem) -> ResolvedProblem:
        """Build the engine and store ``problem`` needs, unless the current
        ones already serve its pool signature (``problem.pool_digest``:
        model, weights, mode) and sketch size.  ``solve`` calls it; call it
        first to reach ``self.engine``/``self.store`` before a solve.
        Returns the problem resolved against the graph."""
        r = problem.resolve(self.n)
        # the problem's model, or the solver's for model=None
        model = problem.model or self._default_model()
        if problem.t_rounds is not None and model == "lt":
            raise ValueError("MRIM sampling is IC-only (paper §4.8); the "
                             "solver's default model is 'lt'")
        # celf and the early exit read the exact store's incremental sketch
        sketch_k = self._sketch_k_arg
        if sketch_k is None and (self._sel_method == "celf"
                                 or problem.early_exit):
            sketch_k = cov.DeviceRRStore.DEFAULT_SKETCH_K
        if sketch_k is None and problem.mode == "approximate":
            sketch_k = sketch_mod.auto_sketch_k(problem.eps, self.n)
        if sketch_k is not None:
            sketch_k = sketch_mod.resolve_sketch_k(sketch_k)
        if isinstance(self._engine_arg, str):
            sig = ("name", self._engine_name(problem, model),
                   problem.pool_digest(model=model), sketch_k)
        else:
            sig = ("inst", id(self._engine_arg), problem.pool_digest(),
                   sketch_k)
        if sig != self._sig:
            self._build(r, sig, model)
        return r

    # -- sampling ----------------------------------------------------------
    def _round(self):
        batch = self.engine.sample(round_seed(self.seed, self._stats.rounds))
        if self._row_weight_mode:
            # the importance-weighted estimator: each row weighs its root's
            # node weight
            if batch.roots is None:
                raise ValueError(
                    "weighted problem on an engine that neither draws roots "
                    "by the weights nor reports batch roots: no "
                    "importance-weighted estimator")
            w = self._node_w
            self.store.append_batch(batch, row_w=w[batch.roots.to(
                torch.int64).clamp(0, w.shape[0] - 1)])
        else:
            self.store.append_batch(batch)
        self._ovf += batch.overflowed.sum()
        self._ovf_lanes += int(batch.overflowed.numel())
        self._stats.sampling_steps += batch.steps
        self._stats.rounds += 1

    def sample_until(self, theta: int):
        while self.store.n_rr < theta:
            self._round()

    @property
    def stats(self) -> IMMStats:
        st = self._stats
        st.n_rr_sampled = self.store.n_rr
        st.overflow_fraction = (int(self._ovf) / self._ovf_lanes
                                if self._ovf_lanes else 0.0)
        return st

    # -- variants ----------------------------------------------------------
    def _selection_spec(self, r: ResolvedProblem):
        """None for plain problems and for weights alone when the roots
        carry them (rows stay equal); else the variant greedy's
        :class:`~repro_torch.core.coverage.SelectionSpec`: one group of
        quota ``k_steps`` over the items (MRIM: T groups of n ids, k seeds
        each), the candidate mask, the costs, and in row-weight mode the
        weighted score."""
        p = r.problem
        if p.budget is None and p.candidates is None \
                and p.t_rounds is None and not self._row_weight_mode:
            return None
        if p.t_rounds is not None:
            n_group, n_groups, quota = r.n_nodes, r.t_rounds, p.k
        else:
            n_group, n_groups, quota = r.n_items, 1, r.k_steps
        costs = None if r.costs is None else np.tile(r.costs, r.t_rounds)
        return cov.SelectionSpec(
            k_steps=r.k_steps, n_group=n_group, n_groups=n_groups,
            group_quota=quota, cand=r.cand_mask_items, costs=costs,
            budget=p.budget, weighted=self._row_weight_mode)

    # -- full IMM ----------------------------------------------------------
    def solve(self, problem: IMProblem) -> IMResult:
        """Solve an :class:`IMProblem` -> :class:`IMResult`
        (:meth:`solve_problem`)."""
        if not isinstance(problem, IMProblem):
            raise TypeError("IMMSolver.solve() takes one IMProblem")
        return self.solve_problem(problem)

    def solve_problem(self, problem: IMProblem, *,
                      deadline_s: Optional[float] = None) -> IMResult:
        """Solve ``problem``: the LB loop of Alg. 2 (or a fixed θ), then
        the final selection.  ``deadline_s`` (the reference's degraded
        sketch answer) is not ported yet: ROADMAP Queue 1 item 10."""
        if deadline_s is not None:
            raise NotImplementedError(
                "solve_problem(deadline_s=...) is not ported yet: ROADMAP "
                "Queue 1 item 10 (durability and streaming)")
        r = self.prepare(problem)
        spec = self._selection_spec(r)
        p = problem
        st = self._stats
        approx = p.mode == "approximate"
        k_theta = p.k if p.k is not None else r.k_steps
        self._sketch_info = None

        def select():
            if approx:
                # no pool to verify against: the sketch greedy leaves its
                # error certificate for the final spread_bounds
                self._sketch_info = {}
                return self.store.select(r.k_steps, cand=r.cand_mask_items,
                                         info_out=self._sketch_info)
            return self.store.select(r.k_steps, method=self._sel_method,
                                     spec=spec, eval_batch=self.eval_batch)

        if p.theta is not None:
            # fixed-θ mode: sample to θ, one selection, no LB loop
            st.theta, st.lb = p.theta, 1.0
            self.sample_until(p.theta)
            res = select()
        else:
            lam_p, lam_star, eps_p, _ = imm_theta_params(
                self.n, k_theta, p.eps, p.ell)
            lb = 1.0
            for i in range(1, max(int(math.log2(self.n)), 2)):  # Alg. 2
                x = r.scale / (2.0 ** i)
                theta_i = int(math.ceil(lam_p / x))
                if p.max_theta:
                    theta_i = min(theta_i, p.max_theta)
                self.sample_until(theta_i)
                threshold = (1.0 + eps_p) * x
                if self._early_exit_skip(r, threshold):
                    st.early_exit_skips += 1
                    st.history.append(("lb_skip", i, theta_i))
                    continue
                res = select()
                est = r.scale * float(res.frac)
                st.lb_iters = i
                st.history.append(("lb_iter", i, theta_i, est))
                if est >= threshold:                            # Alg. 2 L7
                    lb = est / (1.0 + eps_p)                    # Alg. 2 L8
                    break
            theta = int(math.ceil(lam_star / lb))
            if p.max_theta:
                theta = min(theta, p.max_theta)
            st.theta, st.lb = theta, lb
            self.sample_until(theta)
            res = select()
        seeds = res.seeds.cpu().numpy()
        gains = res.gains.cpu().numpy()
        live = seeds < r.n_items          # the sentinels of the scans
        seeds, gains = seeds[live], gains[live]
        frac = float(res.frac)
        spent = float(res.spent) if hasattr(res, "spent") else 0.0
        st.frac_covered = frac
        st.variant = p.variant
        st.budget_spent = spent
        bounds = (self._approx_bounds(r, self._sketch_info) if approx
                  else None)
        return IMResult(seeds=seeds, spread=r.scale * frac, gains=gains,
                        frac=frac, stats=self.stats, problem=p,
                        n_nodes=self.n, cost=spent, spread_bounds=bounds)

    def solve_stacked(self, problems: "list[IMProblem]") -> "list[IMResult]":
        """Fixed-θ micro-batch solve: one
        :func:`~repro_torch.core.coverage.select_seeds_stacked` scan over
        the shared pool instead of a selection a request (serving's
        batched selection, ``repro_torch.serve.batching``).

        Every problem must pin the same ``theta`` and share this solver's
        pool signature; each returned :class:`IMResult` equals
        ``solve_problem`` on the same solver in every field.
        ``mode="approximate"`` and the row-weighted estimator are not
        stackable: callers route those a request at a time.  The
        reference's fault-policy boundary around the scan waits for its
        fault-tolerance layer (ROADMAP Queue 1 item 10): this solver has
        no ``fault_policy``."""
        if not problems:
            return []
        theta = problems[0].theta
        for p in problems:
            if p.theta is None or p.theta != theta:
                raise ValueError(
                    "solve_stacked needs one common fixed theta= on every "
                    "problem (LB-loop solves cannot share a scan)")
            if p.mode == "approximate":
                raise ValueError("solve_stacked needs the exact pool; "
                                 "approximate-mode problems go solo")
        rs, sig0 = [], None
        for p in problems:
            rs.append(self.prepare(p))
            if sig0 is None:
                sig0 = self._sig
            elif self._sig != sig0:
                raise ValueError("all stacked problems must share one pool "
                                 "signature (solver_key batches do)")
        if self._row_weight_mode:
            raise ValueError("solve_stacked does not support the "
                             "row-weighted fallback estimator")
        reqs, geometry = self.stacked_requests(rs)
        st = self._stats
        st.theta, st.lb = theta, 1.0
        self.sample_until(theta)
        out = cov.select_seeds_stacked(self.store, reqs, **geometry)
        seeds_all, gains_all = out.seeds.cpu().numpy(), out.gains.cpu().numpy()
        frac_all, spent_all = out.frac.cpu().numpy(), out.spent.cpu().numpy()
        results = []
        for i, (p, r) in enumerate(zip(problems, rs)):
            seeds = seeds_all[i, :r.k_steps]
            gains = gains_all[i, :r.k_steps]
            live = seeds < r.n_items      # the sentinels, as solve_problem
            seeds, gains = seeds[live], gains[live]
            frac, spent = float(frac_all[i]), float(spent_all[i])
            st.frac_covered = frac
            st.variant = p.variant
            st.budget_spent = spent
            results.append(IMResult(
                seeds=seeds, spread=r.scale * frac, gains=gains, frac=frac,
                stats=self.stats, problem=p, n_nodes=self.n, cost=spent))
        return results

    def stacked_requests(self, rs: "list[ResolvedProblem]"):
        """``(requests, geometry)`` of a stacked batch of resolved problems:
        a plain :class:`~repro_torch.core.coverage.StackedRequest` for a
        problem without a selection spec, else one from its spec, and the
        batch's ``n_group``/``n_groups`` keywords (one group of n ids
        without a variant row)."""
        n_group = n_groups = None
        reqs = []
        for r in rs:
            spec = self._selection_spec(r)
            if spec is None:
                reqs.append(cov.StackedRequest(k_steps=r.k_steps))
                continue
            reqs.append(cov.StackedRequest(
                k_steps=spec.k_steps, plain=False, cand=spec.cand,
                costs=spec.costs, budget=spec.budget,
                quota=spec.group_quota))
            if n_group is None:
                n_group, n_groups = spec.n_group, spec.n_groups
            elif (n_group, n_groups) != (spec.n_group, spec.n_groups):
                # unreachable when batched by registry key: the geometry
                # derives from t_rounds, which is part of the pool signature
                raise ValueError("mixed group geometry in a stacked batch")
        return reqs, {"n_group": self.n if n_group is None else n_group,
                      "n_groups": 1 if n_groups is None else n_groups}

    def _early_exit_skip(self, r, threshold: float) -> bool:
        """The θ early exit (Alg. 2's LB gate), as the reference's: skip an
        LB iteration's selection when an upper bound on the coverage of any
        k seeds cannot reach ``threshold``.  Only with ``"mod"`` bucketing
        and ``n_rr <= sketch_k``, where a node's sketch occupancy is its
        exact row count: the sum of the k largest linear counts of the
        occupancies (one ``union_gains`` sweep against an empty cover, read
        once with the fold flag; the counts are host numpy, so both
        packages give the same floats) bounds the coverage from above, and
        a skipped iteration would have failed its test.  Candidates mask
        the counts; weighted and budgeted problems never skip (their
        objective is not a row count)."""
        p = r.problem
        st = self.store
        if (not p.early_exit or st.sketch_k is None
                or st.sketch_mode != "mod" or self._row_weight_mode
                or r.node_weights is not None or p.budget is not None):
            return False
        n_rr = st.n_rr
        if n_rr == 0 or n_rr > st.sketch_k:
            return False
        words = st.sketch_words()
        empty = torch.zeros(words.shape[1], dtype=torch.int32,
                            device=words.device)
        occ = sketch_mod.union_gains(words, empty)
        occ[-1] = st.fold_error[0]       # row n, the sentinel: the flag
        occ = occ.cpu().numpy()
        st.check_folds(int(occ[-1]))
        counts = sketch_mod.linear_count(occ[:r.n_items], st.sketch_k)
        mask = r.cand_mask_items
        if mask is not None:
            counts = counts[mask]
        top = float(np.sort(counts)[::-1][:r.k_steps].sum())
        est_ub = r.scale * min(float(n_rr), top) / max(n_rr, 1)
        return est_ub < threshold

    @staticmethod
    def _approx_bounds(r, info: dict) -> tuple:
        """(lo, hi) spread from a sketch-selection certificate: lower from
        the summed Δocc, upper from the widened linear-counting estimate."""
        n_rr = max(int(info.get("n_rr", 0)), 1)
        return (r.scale * float(info["lo_rows"]) / n_rr,
                r.scale * float(info["hi_rows"]) / n_rr)


_SOLVER_KEYS = frozenset(("engine", "batch", "qcap", "ec", "model", "seed",
                          "selection", "sketch_k", "eval_batch", "device"))
_PROBLEM_KEYS = frozenset(("model", "ell", "max_theta", "node_weights",
                           "costs", "budget", "candidates", "t_rounds",
                           "theta", "early_exit", "mode"))


def imm(g: CSRGraph, k: Optional[int] = None, eps: Optional[float] = None,
        **kw):
    """One-shot wrapper; returns (seeds, spread_estimate, stats).

    Keywords split between the solver (engine/batch/selection/seed/
    sketch_k/device/...) and the problem (node_weights/costs/budget/
    candidates/ell/max_theta/theta/mode/...); anything else raises
    ``TypeError``.
    """
    unknown = set(kw) - _SOLVER_KEYS - _PROBLEM_KEYS
    if unknown:
        raise TypeError("imm() got unexpected keyword argument(s): "
                        + ", ".join(sorted(unknown)))
    solver_kw = {k_: v for k_, v in kw.items() if k_ in _SOLVER_KEYS}
    pkw = {k_: v for k_, v in kw.items()
           if k_ in _PROBLEM_KEYS and v is not None}
    if k is not None:
        pkw["k"] = k
    if eps is not None:
        pkw["eps"] = eps
    res = IMMSolver(g, **solver_kw).solve_problem(IMProblem(**pkw))
    return res.seeds, res.spread, res.stats


def imm_result(g: CSRGraph, problem: IMProblem, **solver_kw) -> IMResult:
    """Typed one-shot: ``IMMSolver(g, **solver_kw).solve_problem(problem)``;
    an unknown solver keyword raises ``TypeError``."""
    unknown = set(solver_kw) - _SOLVER_KEYS
    if unknown:
        raise TypeError("imm_result() got unexpected keyword argument(s): "
                        + ", ".join(sorted(unknown)))
    return IMMSolver(g, **solver_kw).solve_problem(problem)
