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
    IMMSolver(g, fault_policy=FaultPolicy(), checkpoint_dir=d,
              checkpoint_every=5).solve(IMProblem(k=10))    # durable
    IMMSolver(g).solve_problem(IMProblem(k=10), deadline_s=0.5)  # degraded
    solver.resolve_incremental(IMProblem(k=10), deltas)  # streaming graph
    IMMSolver(g, mesh=make_sample_mesh()).solve(IMProblem(k=10))  # sharded

The host runs rounds of RR batches against the engine (gIM's kernel
relaunches, Alg. 6): round t of a pool samples with the 32-bit seed
``round_seed(seed, t)``, so a solve is a pure function of (graph, options,
seed) and holds no global RNG state.  The solver's round cursor t starts
at 0 with each fresh pool and moves on only after a round's batch has
landed in the store; a pool that is adopted, restored or reused across a
graph delta keeps its cursor, so no round seed repeats within a pool's
life.  Every round is
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
schedule of its ``k_steps``.

With ``mesh`` (a ``repro_torch.launch.mesh.SampleMesh``, any size, 1
included) the pool is a
:class:`~repro_torch.core.coverage.ShardedDeviceRRStore` dealt over the
mesh's ranks and every plain selection runs the sharded protocol of
DESIGN.md §5 (each rank runs the same solve; the ranks agree in every
result field, and the results equal a solve without a mesh on the same
rounds).  The mesh is decided once, at construction.  An engine that
samples over the same mesh (``queue_sharded``) hands each rank its own
block of a round; any other engine draws the whole round on every rank and
the store deals it.  On more than one rank the variants, the
approximate mode, ``solve_stacked``, checkpoints, the fault policy, the
deadline and streaming raise ``NotImplementedError`` (ROADMAP [9b]), and
so does a restore onto any mesh.  The engine and store are keyed on the
problem's ``pool_digest``, so problems that differ only in selection
share a pool.

Durability and streaming follow the reference (its ``im-pool``
checkpoints, read and written by both packages; the fault policy at the
``sample``, ``append``, ``grow`` and ``select`` boundaries; the deadline's
degraded answer; ``resolve_incremental``): see :meth:`IMMSolver.save_pool`,
:meth:`IMMSolver.solve_problem` and :meth:`IMMSolver.resolve_incremental`.

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
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.graph.csr import CSRGraph, reverse
from repro_torch.core import coverage as cov
from repro_torch.core import sketch as sketch_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core.engine import (FusedSketchEngine, make_engine,
                                     resolve_engine_name)
from repro_torch.core.oracle import imm_theta_params
from repro_torch.core.problem import (IMProblem, IMResult, ResolvedProblem,
                                      problem_from_state, problem_state)
from repro_torch.core.rrset import round_seed
from repro_torch.device import resolve_device
from repro_torch.ft.failures import DeadlineExceeded, FaultPolicy


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
    # the reference's mesh fields ((1,) and "samples:1" without a mesh):
    # its checkpoints carry them, and a restore builds IMMStats(**saved
    # stats)
    mesh_shape: tuple = (1,)
    pool_sharding: str = "samples:1"
    per_device_pool_bytes: int = 0
    # the LB loop's resume mark: the last LB iteration that finished
    # without breaking (or was skipped); a restored solve goes on after it
    lb_completed: int = 0
    history: list = field(default_factory=list)


@dataclass
class PoolLease:
    """A prepared solver's sampled state, detached (the reference's
    ``PoolLease``): the store, the problem that defines its signature, the
    round seed stream (``seed`` and the next round ``cursor``), the stats
    and overflow counters, and the digest of a solve interrupted in its LB
    loop (``active_solve``, None when no solve is in progress).
    ``IMMSolver.adopt_pool`` installs it in a solver of the same graph and
    options, which then goes on as the exporter would have."""
    problem: IMProblem
    store: object
    seed: int
    cursor: int
    stats: IMMStats
    ovf: torch.Tensor
    ovf_lanes: int
    active_solve: Optional[str] = None

    def pool_bytes(self) -> int:
        return _pool_bytes(self.store)


def _pool_bytes(store) -> int:
    """Device bytes of a store's pool and sketch (0 without a store)."""
    if store is None:
        return 0
    return store.per_device_pool_bytes() + store.sketch_bytes()


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

    ``fault_policy`` (:class:`~repro_torch.ft.failures.FaultPolicy`) wraps
    the hot loop's boundaries: a round's ``sample`` and ``append``, the
    pool's ``grow`` gate and each ``select``, each checked before any
    device mutation, so a retried step replays against unchanged buffers
    and the result stays bit-identical.  ``checkpoint_dir`` with
    ``checkpoint_every`` > 0 saves the pool (:meth:`save_pool`) every that
    many rounds, keeping ``checkpoint_keep`` checkpoints; a restart calls
    :meth:`restore_pool` (``repro_torch.ft.runner.resilient_solve`` does).
    """

    def __init__(self, g: CSRGraph, *, engine="queue",
                 batch: Optional[int] = None, qcap: Optional[int] = None,
                 ec: Optional[int] = None, model: Optional[str] = None,
                 selection: str = "auto", seed: int = 0,
                 sketch_k: Optional[int] = None,
                 eval_batch: Optional[int] = None, device=None,
                 fault_policy: Optional[FaultPolicy] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, checkpoint_keep: int = 3,
                 mesh=None):
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
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = mesh.device
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device}")
            if mesh.size > 1 and (fault_policy is not None
                                  or checkpoint_dir is not None):
                raise cov.not_sharded("the fault policy and checkpoints on "
                                      "more than one rank")
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
        self._sig_problem = None      # the problem the pool was built for
        self._row_weight_mode = False
        self._node_w = None
        self.engine = self.store = None
        self.engine_name = None
        self._cursor = 0              # the pool's next round index
        self.fault_policy = fault_policy
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = int(checkpoint_every)
        self._ckpt_keep = int(checkpoint_keep)
        self._last_ckpt_round = 0
        # signature_digest of an eps-driven solve in progress: a restored
        # pool carrying it resumes that solve's LB loop
        self._active_solve: Optional[str] = None
        self.last_incremental = None
        if named or (engine.item_space == self.n
                     and getattr(engine, "root_weights", None) is None):
            # a weighted-root instance waits for its first (weighted)
            # problem, as the reference's
            self._ensure_prepared()

    def _default_model(self) -> str:
        return "lt" if self._model_arg == "lt" else "ic"

    def _one_rank(self, what: str) -> None:
        """Raise unless the solver runs on one rank (no mesh, or one of
        size 1)."""
        if self.mesh is not None and self.mesh.size > 1:
            raise cov.not_sharded(f"{what} on more than one rank")

    def _ensure_prepared(self) -> None:
        if self._sig is None:
            self.prepare(IMProblem(k=1, eps=0.5, model=self._default_model()))

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
                                   mesh=self.mesh,
                                   **self._engine_opts), False
            if w is not None:
                return make_engine(name, self.g_rev, root_weights=w,
                                   mesh=self.mesh,
                                   **self._engine_opts), False
            if name not in self._plain_engines:
                self._plain_engines[name] = make_engine(
                    name, self.g_rev, mesh=self.mesh, **self._engine_opts)
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

    def _build(self, r: ResolvedProblem, sig, model: str,
               store=None) -> None:
        """Engine, store and fresh stats for the signature (pool digest,
        sketch_k).  A fresh store restarts the round-seed stream at round
        0; an adopted ``store`` (:meth:`adopt_pool`, the reused pool of
        :meth:`resolve_incremental`) must match the signature, and keeps
        the cursor.  A weighted problem gets an engine with the alias table
        of its weights, or on an instance that does not draw by them a
        row-weighted store."""
        problem, sketch_k = r.problem, sig[-1]
        engine, row_weight_mode = self._engine_for(r, model)
        if engine.item_space != r.n_items:
            raise ValueError(
                f"engine {getattr(engine, 'name', '?')!r} samples an item "
                f"space of {engine.item_space}, not the problem's "
                f"{r.n_items} items; tagged engines need a matching "
                f"t_rounds= on the IMProblem")
        approx = problem.mode == "approximate"
        fresh = store is None
        if not fresh:
            if getattr(store, "pool_free", False) != approx:
                raise ValueError(
                    "adopted pool kind does not match the problem mode: a "
                    "pool-free sketch store can only back mode='approximate'"
                    " solves, and an exact pool only exact ones")
            if (store.n_nodes != engine.item_space
                    or store.row_weighted != row_weight_mode
                    or store.sketch_k != sketch_k):
                raise ValueError(
                    "adopted pool does not match the problem signature: "
                    f"store (n={store.n_nodes}, row_weighted="
                    f"{store.row_weighted}, sketch_k={store.sketch_k}) "
                    f"vs engine (n={engine.item_space}, row_weighted="
                    f"{row_weight_mode}, sketch_k={sketch_k})")
            if store.device.type != self.device.type:
                raise ValueError(f"adopted pool lives on {store.device}, the "
                                 f"solver on {self.device}")
            if getattr(store, "mesh", None) is not self.mesh and not approx:
                raise ValueError("adopted pool lives on another mesh than "
                                 "the solver's mesh= argument")
        elif approx:
            store = cov.SketchRRStore(engine.item_space, sketch_k=sketch_k,
                                      device=self.device)
        elif self.mesh is not None:
            store = cov.ShardedDeviceRRStore(
                engine.item_space, sketch_k=sketch_k, mesh=self.mesh,
                row_weighted=row_weight_mode)
        else:
            store = cov.DeviceRRStore(engine.item_space, sketch_k=sketch_k,
                                      row_weighted=row_weight_mode,
                                      device=self.device)
        if fresh:
            self._cursor = 0
        self.engine_name = getattr(engine, "name", type(engine).__name__)
        self.engine = FusedSketchEngine(engine) if approx else engine
        self.store = store
        # an engine that samples over the store's mesh hands each rank its
        # own block of a round, which the store appends as its shard
        self._block_rounds = (isinstance(store, cov.ShardedDeviceRRStore)
                              and getattr(engine, "mesh", None) is store.mesh
                              and hasattr(engine, "sample_sharded"))
        if self.fault_policy is not None:
            # the "grow" site gates the pool's growth before anything is
            # allocated, so the append stays retryable
            pol = self.fault_policy
            store.alloc_check = (lambda st, newcap: pol.check(
                "grow", {"newcap": newcap, "bytes": newcap * 9}))
        self._row_weight_mode = row_weight_mode
        self._node_w = (torch.from_numpy(r.node_weights).to(self.device)
                        if row_weight_mode else None)
        self._sig = sig
        self._sig_problem = problem
        self._stats = IMMStats(selection=self.selection,
                               variant=problem.variant)
        if self.mesh is not None:
            self._stats.mesh_shape = self.mesh.shape
            self._stats.pool_sharding = f"{self.mesh.axis}:{self.mesh.size}"
        self._ovf = torch.zeros((), dtype=torch.int64, device=self.device)
        self._ovf_lanes = 0

    def prepare(self, problem: IMProblem, _store=None) -> ResolvedProblem:
        """Build the engine and store ``problem`` needs, unless the current
        ones already serve its pool signature (``problem.pool_digest``:
        model, weights, mode) and sketch size.  ``solve`` calls it; call it
        first to reach ``self.engine``/``self.store`` before a solve.
        ``_store`` adopts a store instead of building one
        (:meth:`adopt_pool`).  Returns the problem resolved against the
        graph."""
        r = problem.resolve(self.n)
        if problem.variant != "plain":
            self._one_rank(f"the {problem.variant} problem")
        if problem.mode == "approximate":
            self._one_rank("the approximate (pool-free) mode")
        # the problem's model, or the solver's for model=None
        model = problem.model or self._default_model()
        if problem.t_rounds is not None and model == "lt":
            raise ValueError("MRIM sampling is IC-only (paper §4.8); the "
                             "solver's default model is 'lt'")
        sig = self._signature(problem, model)
        if _store is not None or sig != self._sig:
            self._build(r, sig, model, store=_store)
        return r

    def _signature(self, problem: IMProblem, model: str) -> tuple:
        """The engine and pool a problem needs: the engine (name, or the
        instance's id), the pool digest and the sketch size."""
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
            return ("name", self._engine_name(problem, model),
                    problem.pool_digest(model=model), sketch_k)
        return ("inst", id(self._engine_arg), problem.pool_digest(),
                sketch_k)

    # -- sampling ----------------------------------------------------------
    def _round(self):
        """One sampling round, transactional in the round cursor: the
        cursor moves on only after the batch has landed in the store, so a
        round that fails (and the fault policy retries) samples again with
        the same round seed against unchanged buffers."""
        pol = self.fault_policy
        timer = pol.round_timer if pol is not None else None
        if timer is not None:
            timer.start()
        seed32 = round_seed(self.seed, self._cursor)
        sample = (self.engine.sample_sharded if self._block_rounds
                  else self.engine.sample)
        batch = (pol.run(lambda: sample(seed32), "sample")
                 if pol is not None else sample(seed32))

        def append():
            if self._row_weight_mode:
                # the importance-weighted estimator: each row weighs its
                # root's node weight
                if batch.roots is None:
                    raise ValueError(
                        "weighted problem on an engine that neither draws "
                        "roots by the weights nor reports batch roots: no "
                        "importance-weighted estimator")
                w = self._node_w
                self.store.append_batch(batch, row_w=w[batch.roots.to(
                    torch.int64).clamp(0, w.shape[0] - 1)])
            else:
                self.store.append_batch(batch)

        if pol is not None:
            pol.run(append, "append")
        else:
            append()
        self._cursor += 1          # commit: the round is durable
        self._ovf += batch.overflowed.sum()
        self._ovf_lanes += int(batch.overflowed.numel())
        self._stats.sampling_steps += batch.steps
        self._stats.rounds += 1
        if timer is not None and timer.is_straggler(timer.stop()):
            pol.straggler_rounds += 1

    def sample_until(self, theta: int):
        """Sample rounds until the pool holds ``theta`` rows, saving the
        pool every ``checkpoint_every`` rounds when a ``checkpoint_dir`` is
        set.  A restored solver starts at the saved row count."""
        self._ensure_prepared()
        while self.store.n_rr < theta:
            self._round()
            if (self._ckpt_dir and self._ckpt_every > 0
                    and self._stats.rounds - self._last_ckpt_round
                    >= self._ckpt_every):
                self.save_pool(self._ckpt_dir)
                self._last_ckpt_round = self._stats.rounds

    @property
    def stats(self) -> IMMStats:
        self._ensure_prepared()
        st = self._stats
        st.n_rr_sampled = self.store.n_rr
        st.overflow_fraction = (int(self._ovf) / self._ovf_lanes
                                if self._ovf_lanes else 0.0)
        st.per_device_pool_bytes = self.store.per_device_pool_bytes()
        return st

    # -- pool ownership ----------------------------------------------------
    def pool_bytes(self) -> int:
        """Device bytes of the pool and its sketch (0 when unprepared)."""
        return _pool_bytes(self.store)

    def export_pool(self) -> PoolLease:
        """Detach the prepared pool with its round cursor, stats and
        in-progress solve as a :class:`PoolLease`; the solver reverts to
        the unprepared state (its next solve builds a fresh pool)."""
        if self._sig is None:
            raise RuntimeError("export_pool() needs a prepared solver — "
                               "nothing to export")
        lease = PoolLease(
            problem=self._sig_problem, store=self.store, seed=self.seed,
            cursor=self._cursor, stats=self.stats, ovf=self._ovf,
            ovf_lanes=self._ovf_lanes, active_solve=self._active_solve)
        self.drop_pool()
        return lease

    def drop_pool(self) -> int:
        """Discard the prepared pool without exporting it (after a failure
        in the middle of an append, the buffers may be ahead of the host
        mirrors: the pool must neither serve nor be saved); returns the
        bytes dropped."""
        freed = self.pool_bytes()
        self.store = self.engine = None
        self._sig = self._sig_problem = self._active_solve = None
        return freed

    def adopt_pool(self, lease: PoolLease) -> None:
        """Install an exported or restored pool (same graph, matching
        signature and options) and go on from its round cursor and
        stats."""
        self.prepare(lease.problem, _store=lease.store)
        self.seed, self._cursor = int(lease.seed), int(lease.cursor)
        self._stats = lease.stats
        self._ovf = lease.ovf.to(self.device)
        self._ovf_lanes = int(lease.ovf_lanes)
        self._active_solve = lease.active_solve

    # -- durable pool checkpoints -----------------------------------------
    POOL_CKPT_FORMAT = "im-pool"
    POOL_CKPT_VERSION = 1
    # pool-free (mode="approximate") checkpoints: the sketch words and the
    # counters; the store config's "kind" picks the class on restore
    POOL_CKPT_VERSION_SKETCH = 2

    def save_pool(self, ckpt_dir: str, *, keep: Optional[int] = None) -> str:
        """Write the pool as a durable checkpoint in the reference's
        ``im-pool`` format (``repro_torch.ckpt.checkpoint``: atomic, rotated
        to ``keep``, step = the rounds sampled): the store's
        :meth:`~repro_torch.core.coverage.DeviceRRStore.state`, the stats
        and counters, the signature problem and the in-progress solve.
        The reference's ``rng_key`` is a uint32[2] array here too, (cursor,
        seed), so the reference reads the file; the port's seed stream is
        ``meta["rng"] = {"kind": "counter", "seed", "cursor"}``, which the
        reference ignores."""
        self._one_rank("a pool checkpoint")
        self._ensure_prepared()
        stats = self.stats
        state = dict(self.store.state())
        mask = 0xFFFFFFFF
        state["rng_key"] = np.array([self._cursor & mask, self.seed & mask],
                                    np.uint32)
        state["steps_acc"] = np.array(stats.sampling_steps, np.int32)
        state["ovf_acc"] = np.array(int(self._ovf), np.int32)
        st = asdict(stats)
        st["mesh_shape"] = list(st["mesh_shape"])
        st["history"] = [list(h) for h in st["history"]]
        meta = {
            "format": self.POOL_CKPT_FORMAT,
            "version": (self.POOL_CKPT_VERSION_SKETCH
                        if getattr(self.store, "pool_free", False)
                        else self.POOL_CKPT_VERSION),
            "store": self.store.config(),
            "problem": problem_state(self._sig_problem),
            "stats": st,
            "ovf_lanes": int(self._ovf_lanes),
            "active_solve": self._active_solve,
            "rng": {"kind": "counter", "seed": self.seed,
                    "cursor": self._cursor},
        }
        return ckpt_mod.save(ckpt_dir, stats.rounds, state,
                             keep=self._ckpt_keep if keep is None else keep,
                             meta=meta)

    def restore_pool(self, ckpt_dir: str, *, step: Optional[int] = None
                     ) -> int:
        """Rebuild the pool of a :meth:`save_pool` checkpoint (the latest
        step unless ``step=``), the reference's too, on this solver's
        device, and adopt it; returns the step.  Sampling goes on from the
        saved round cursor against the saved buffers, as the process that
        wrote the checkpoint would have.  A checkpoint without the port's
        ``meta["rng"]`` (one the reference wrote) gives the reference's
        pool, stats and selection; any further rounds come from the port's
        own stream, the solver's seed at cursor ``stats.rounds``.  The
        solver must have the options of the one that saved."""
        if self.mesh is not None:
            raise cov.not_sharded("a pool restore onto a mesh")
        if step is None:
            step = ckpt_mod.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no pool checkpoint under {ckpt_dir!r}")
        meta = ckpt_mod.load_manifest(ckpt_dir, step)["meta"]
        if meta.get("format") != self.POOL_CKPT_FORMAT:
            raise ValueError(f"{ckpt_dir!r} step {step} is not an im-pool "
                             f"checkpoint (format={meta.get('format')!r})")
        if meta.get("version") not in (self.POOL_CKPT_VERSION,
                                       self.POOL_CKPT_VERSION_SKETCH):
            raise ValueError(
                f"pool checkpoint version {meta.get('version')} not "
                f"supported (want {self.POOL_CKPT_VERSION} or "
                f"{self.POOL_CKPT_VERSION_SKETCH})")
        items = {k.strip("[]'\""): v
                 for k, v in ckpt_mod.restore_items(ckpt_dir, step).items()}
        kind = meta["store"].get("kind", "sharded")
        store_cls = (cov.SketchRRStore if kind == "sketch"
                     else cov.DeviceRRStore)
        store = store_cls.from_state(items, meta["store"], device=self.device)
        st = dict(meta["stats"])
        st["mesh_shape"] = tuple(st["mesh_shape"])
        st["history"] = [tuple(h) for h in st["history"]]
        stats = IMMStats(**st)
        stats.sampling_steps = int(items["steps_acc"])
        rng = meta.get("rng") or {}
        if rng.get("kind") == "counter":
            seed, cursor = int(rng["seed"]), int(rng["cursor"])
        else:
            seed, cursor = self.seed, stats.rounds
        self.adopt_pool(PoolLease(
            problem=problem_from_state(meta["problem"]), store=store,
            seed=seed, cursor=cursor, stats=stats,
            ovf=torch.tensor(int(items["ovf_acc"]), dtype=torch.int64),
            ovf_lanes=int(meta["ovf_lanes"]),
            active_solve=meta.get("active_solve")))
        self._last_ckpt_round = self._stats.rounds
        return int(step)

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
        the final selection.

        ``deadline_s`` (seconds left) turns on the reference's deadline
        checks: after a fixed θ's sampling, before each LB iteration and
        before the final top-up.  Once it has expired the solve returns a
        ``degraded=True`` answer over the pool sampled so far
        (:meth:`_degraded_result`), or raises
        :class:`~repro_torch.ft.failures.DeadlineExceeded` when the
        objective has no certified sketch estimate.

        A restored pool that carries this very problem's
        ``signature_digest`` (an eps-driven solve interrupted in its LB
        loop) resumes after ``stats.lb_completed`` instead of running the
        finished iterations again over the larger pool."""
        if deadline_s is not None:
            self._one_rank("the deadline's degraded answer")
        r = self.prepare(problem)
        spec = self._selection_spec(r)
        p = problem
        approx = p.mode == "approximate"
        k_theta = p.k if p.k is not None else r.k_steps
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        sig = p.signature_digest()
        resume = self._active_solve == sig
        self._active_solve = sig
        self._sketch_info = None

        def expired() -> bool:
            return deadline is not None and time.monotonic() >= deadline

        def select():
            if approx:
                # no pool to verify against: the sketch greedy leaves its
                # error certificate for the final spread_bounds
                info = self._sketch_info = {}
                fn = (lambda: self.store.select(
                    r.k_steps, cand=r.cand_mask_items, info_out=info))
            else:
                fn = (lambda: self.store.select(
                    r.k_steps, method=self._sel_method, spec=spec,
                    eval_batch=self.eval_batch))
            if self.fault_policy is not None:
                # the ctx names the request, so a matching injector can
                # fail one problem of a batch
                return self.fault_policy.run(fn, "select",
                                             {"problem": p, "k": r.k_steps})
            return fn()

        st = self._stats
        if p.theta is not None:
            # fixed-θ mode: sample to θ, one selection, no LB loop; a
            # restored pool tops up from its row count
            st.theta, st.lb = p.theta, 1.0
            self.sample_until(p.theta)
            if expired():
                return self._degraded_result(r)
            res = select()
        elif resume and st.theta:
            # the LB loop had concluded when the checkpoint was written:
            # only the final top-up remains
            self.sample_until(st.theta)
            res = select()
        else:
            lam_p, lam_star, eps_p, _ = imm_theta_params(
                self.n, k_theta, p.eps, p.ell)
            lb = st.lb if resume else 1.0
            start_i = st.lb_completed + 1 if resume else 1
            for i in range(start_i, max(int(math.log2(self.n)), 2)):  # Alg. 2
                if expired():
                    return self._degraded_result(r)
                x = r.scale / (2.0 ** i)
                theta_i = int(math.ceil(lam_p / x))
                if p.max_theta:
                    theta_i = min(theta_i, p.max_theta)
                self.sample_until(theta_i)
                threshold = (1.0 + eps_p) * x
                if self._early_exit_skip(r, threshold):
                    st.early_exit_skips += 1
                    st.history.append(("lb_skip", i, theta_i))
                    st.lb_completed = i
                    continue
                res = select()
                est = r.scale * float(res.frac)
                st.lb_iters = i
                st.history.append(("lb_iter", i, theta_i, est))
                if est >= threshold:                            # Alg. 2 L7
                    lb = est / (1.0 + eps_p)                    # Alg. 2 L8
                    break
                st.lb_completed = i
                st.lb = lb
            theta = int(math.ceil(lam_star / lb))
            if p.max_theta:
                theta = min(theta, p.max_theta)
            st.theta, st.lb = theta, lb
            if expired():
                return self._degraded_result(r)
            self.sample_until(theta)
            res = select()
        self._active_solve = None
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

    def _degraded_result(self, r: ResolvedProblem) -> IMResult:
        """The deadline's answer from the pool sampled so far, as the
        reference's: ``degraded=True`` with certified ``spread_bounds``.

        * pool-free store: its sketch greedy (``select_seeds_sketch``) and
          certificate;
        * exact store with a sketch: k sweeps of ``union_gains`` (Δocc of
          every node against the union of the picks: one
          ``sketch_union_popcount`` and one ``popcount_words`` launch on
          the card), the first maximum on the host, the pick folded into
          the union with ``union_row``; the lower bound is the summed Δocc
          and the estimate its linear count, clamped into the bounds;
        * exact store without one: the nodes ranked by their exact row
          counts (``np.argsort(...)[::-1]``, the reference's unstable
          order, so ties break alike), the best count the lower bound.

        The upper bound is the seeds' summed exact counts, at most n_rr.
        Budgeted, weighted, row-weighted and MRIM objectives, and a pool
        with no row yet, raise
        :class:`~repro_torch.ft.failures.DeadlineExceeded`."""
        p = r.problem
        st = self.store
        if (p.budget is not None or r.node_weights is not None
                or self._row_weight_mode or p.t_rounds is not None):
            raise DeadlineExceeded(
                f"deadline expired mid-solve and the {p.variant!r} "
                "objective has no certified sketch estimate")
        n_rr = st.n_rr
        if n_rr == 0:
            raise DeadlineExceeded("deadline expired before any sampling "
                                   "round completed")
        if getattr(st, "pool_free", False):
            info = {}
            res = st.select(r.k_steps, cand=r.cand_mask_items, info_out=info)
            seeds, gains = res.seeds.cpu().numpy(), res.gains.cpu().numpy()
            live = seeds < r.n_items
            seeds, gains = seeds[live], gains[live]
            frac = float(res.frac)
            self._stats.frac_covered = frac
            self._stats.variant = p.variant
            return IMResult(
                seeds=seeds.astype(np.int64), spread=r.scale * frac,
                gains=gains.astype(np.int64), frac=frac, stats=self.stats,
                problem=p, n_nodes=self.n, degraded=True,
                spread_bounds=self._approx_bounds(r, info))
        t, n = st.n_elems, st.n_nodes
        occ_exact = torch.zeros(n + 1, dtype=torch.int64,
                                device=self.device).index_add_(
            0, st.flat[:t].to(torch.int64).clamp(max=n),
            st.valid[:t].to(torch.int64))[:r.n_items].cpu().numpy()
        mask = (np.ones(r.n_items, bool) if r.cand_mask_items is None
                else r.cand_mask_items.copy())
        seeds, lb_gains = [], []
        if st.sketch_k is not None:
            sk = st.sketch_words()
            cov_words = torch.zeros(sk.shape[1], dtype=torch.int32,
                                    device=sk.device)
            for _ in range(r.k_steps):
                docc = sketch_mod.union_gains(sk, cov_words)
                docc[-1] = st.fold_error[0]     # row n, the sentinel: the flag
                docc = docc.cpu().numpy()
                st.check_folds(int(docc[-1]))
                docc = np.where(mask, docc[:r.n_items], -1)
                u = int(docc.argmax())
                if docc[u] < 0:
                    break
                seeds.append(u)
                lb_gains.append(int(docc[u]))
                mask[u] = False
                cov_words = sketch_mod.union_row(cov_words, sk, u)
            covered_lb = float(sum(lb_gains))
        else:
            order = np.argsort(np.where(mask, occ_exact, -1))[::-1]
            seeds = [int(u) for u in order[:r.k_steps] if mask[u]]
            lb_gains = [int(occ_exact[u]) for u in seeds]
            covered_lb = float(max(lb_gains, default=0))
        covered_ub = float(min(n_rr, sum(int(occ_exact[u]) for u in seeds)))
        if st.sketch_k is not None and seeds:
            est = float(sketch_mod.linear_count(
                np.asarray([int(sum(lb_gains))]), st.sketch_k)[0])
        else:
            est = covered_lb
        est = min(max(est, covered_lb), covered_ub)
        frac = est / n_rr
        self._stats.frac_covered = frac
        self._stats.variant = p.variant
        lo, hi = (r.scale * covered_lb / n_rr, r.scale * covered_ub / n_rr)
        return IMResult(
            seeds=np.asarray(seeds, np.int64), spread=r.scale * frac,
            gains=np.asarray(lb_gains, np.int64), frac=frac,
            stats=self.stats, problem=p, n_nodes=self.n, degraded=True,
            spread_bounds=(lo, hi))

    def solve_stacked(self, problems: "list[IMProblem]") -> "list[IMResult]":
        """Fixed-θ micro-batch solve: one
        :func:`~repro_torch.core.coverage.select_seeds_stacked` scan over
        the shared pool instead of a selection a request (serving's
        batched selection, ``repro_torch.serve.batching``).

        Every problem must pin the same ``theta`` and share this solver's
        pool signature; each returned :class:`IMResult` equals
        ``solve_problem`` on the same solver in every field.
        ``mode="approximate"`` and the row-weighted estimator are not
        stackable: callers route those a request at a time.  With a
        ``fault_policy``, the ``select`` boundary fires once a request with
        the solo ctx (so a matching injector can fail one request), then
        once around the batch's scan."""
        self._one_rank("solve_stacked")
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
        pol = self.fault_policy
        if pol is not None:
            for p, r in zip(problems, rs):
                pol.run(lambda: None, "select",
                        {"problem": p, "k": r.k_steps, "stacked": True})
            out = pol.run(
                lambda: cov.select_seeds_stacked(self.store, reqs,
                                                 **geometry),
                "select", {"stacked_batch": len(problems)})
        else:
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

    # -- streaming graphs ---------------------------------------------------
    def resolve_incremental(self, problem: IMProblem, deltas, *,
                            min_surviving_fraction: float = 0.0,
                            deadline_s: Optional[float] = None) -> IMResult:
        """Apply the edge ``deltas`` (:mod:`repro_torch.core.stream`) to the
        solver's graph and solve ``problem`` again, keeping every RR set
        the deltas leave untouched.

        A forward edge u→v lives in reverse-adjacency row v, and an RR-BFS
        examines only the rows of the nodes it visits, so a pre-delta row
        that contains no destination of a changed edge
        (:func:`~repro_torch.core.stream.affected_nodes`) is an exact
        post-delta sample conditioned on avoiding the changed rows.  The
        rows hit are evicted (``evict_rows_containing``), the engine is
        built again on the new reverse graph (the cached plain engines of
        the old one go), and θ tops up through ``sample_until``, fault
        policy and checkpoints included.  The reused pool keeps its round
        cursor, so the top-up draws round seeds the pool has not seen.

        The pool is reused only when its signature matches ``problem``'s;
        otherwise, and when fewer than ``min_surviving_fraction`` of the
        rows survive, the solve starts a fresh pool on the new graph.  An
        engine instance, MRIM problems (``t_rounds``) and approximate ones
        are refused, as in the reference.  The bookkeeping lands in
        :attr:`last_incremental` and in the stats history (a ``"delta"``
        entry)."""
        self._one_rank("resolve_incremental")
        if not isinstance(self._engine_arg, str):
            raise ValueError(
                "resolve_incremental needs a string engine= (the solver "
                "rebuilds its engine on the mutated graph); an engine "
                "instance owns its own graph and cannot be re-pointed")
        if problem.t_rounds is not None:
            raise ValueError(
                "resolve_incremental does not support MRIM (t_rounds=): "
                "the round-tagged item space has no per-node invalidation "
                "frontier")
        if problem.mode == "approximate":
            raise ValueError(
                "resolve_incremental needs the exact pool (mode="
                "'approximate' keeps no RR rows to invalidate); re-solve "
                "from a cold sketch instead")
        d = stream_mod.as_deltas(deltas)
        new_g = stream_mod.apply_edge_deltas(self.g, d)
        aff = stream_mod.affected_nodes(d)
        model = problem.model or self._default_model()
        store = (self.store if self._sig == self._signature(problem, model)
                 else None)
        info = {"affected_nodes": int(aff.shape[0]),
                "n_rr_before": store.n_rr if store is not None else 0,
                "rows_dropped": 0, "rows_kept": 0,
                "surviving_fraction": 0.0, "reused": False}
        if store is not None:
            ev = store.evict_rows_containing(aff)
            info["rows_dropped"] = int(ev["rows_dropped"])
            info["rows_kept"] = int(ev["rows_kept"])
            if info["n_rr_before"]:
                info["surviving_fraction"] = (info["rows_kept"]
                                              / info["n_rr_before"])
            if info["surviving_fraction"] < min_surviving_fraction:
                store = None                   # too few left: a fresh pool
        self.g = new_g
        self.n = new_g.n_nodes
        self.g_rev = reverse(new_g)
        self._plain_engines = {}
        self._sig = None
        self.engine = None
        self._active_solve = None
        self._last_ckpt_round = 0
        if store is not None:
            # the adoption path: fresh stats, the surviving pool and its
            # round cursor kept
            self.prepare(problem, _store=store)
            info["reused"] = True
            self._stats.history.append(
                ("delta", info["rows_dropped"], info["rows_kept"]))
        else:
            self.store = None
        self.last_incremental = info
        return self.solve_problem(problem, deadline_s=deadline_s)

    @staticmethod
    def _approx_bounds(r, info: dict) -> tuple:
        """(lo, hi) spread from a sketch-selection certificate: lower from
        the summed Δocc, upper from the widened linear-counting estimate."""
        n_rr = max(int(info.get("n_rr", 0)), 1)
        return (r.scale * float(info["lo_rows"]) / n_rr,
                r.scale * float(info["hi_rows"]) / n_rr)


_SOLVER_KEYS = frozenset(("engine", "batch", "qcap", "ec", "model", "seed",
                          "selection", "sketch_k", "eval_batch", "device",
                          "fault_policy", "checkpoint_dir",
                          "checkpoint_every", "checkpoint_keep", "mesh"))
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
