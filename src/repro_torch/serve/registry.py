"""Warm-solver registry (the reference's ``repro.serve.registry``, on the
port): one prepared ``IMMSolver`` + device pool per (graph,
pool-signature, θ-mode) key, LRU-evicted under a device-memory budget.

The expensive part of answering an IM request is the sampled RR pool, and
a pool is reusable across problems that share a sampling signature
(``IMProblem.pool_digest``: diffusion model, ``t_rounds``,
``node_weights``).  The registry turns that reuse into a *service*
resource: requests borrow a warm entry, solve on its pool, and the
registry accounts the pool bytes (``IMMSolver.pool_bytes``) against a
configurable budget, evicting least-recently-used entries when a new
pool would not fit.

**θ in the key.**  Fixed-θ problems get one warm solver per
``(graph, pool_digest, theta)``: the pool deterministically reaches
exactly θ rows (same round seeds a fresh solver would walk) and stays
there, so every answer the entry ever returns is bit-identical to
solving that request alone on a cold solver — the contract the serving
front's micro-batches rely on.  ε-driven problems (``theta=None``) share
one growing pool per signature instead; their answers carry pool-reuse
semantics (selection over a ≥θ pool — statistically at least as good,
documented in DESIGN.md §7).

**Ownership.**  Eviction is an explicit pool-ownership transfer: the
registry calls :meth:`~repro_torch.core.imm.IMMSolver.export_pool`, takes
the :class:`~repro_torch.core.imm.PoolLease`, counts its bytes as freed,
and drops it — the lease is the only reference to the device buffers, so
the card's memory goes back to PyTorch's allocator deterministically, not
whenever a solver object happens to be garbage-collected.

**Durability (DESIGN.md §8).**  With ``spill_dir`` set, eviction first
writes the pool as a durable checkpoint (``IMMSolver.save_pool``, the
reference's ``im-pool`` format) keyed by the entry's registry key, and a
later miss on that key *rehydrates* the spilled pool instead of
resampling — eviction stops destroying the most expensive state the
service owns.  The spill directory's name is the reference's
(``sha256(repr(key))[:24]``) and the keys are equal in both packages, so
either package's registry rehydrates the other's spills.
:meth:`quarantine` is the opposite path: an entry whose solve died
mid-flight may hold a partially-appended pool (device buffers ahead of
the host mirrors), so it is dropped without spilling and can never serve
again; any *pre-existing* spill snapshot stays valid (snapshots are only
ever written from committed, consistent states).

**Devices.**  Every solver the registry builds runs on
``solver_opts["device"]`` (default ``"cuda"``; ``"cpu"`` runs the plain
versions).  The reference's ``mesh`` option has no counterpart yet: a
``mesh`` in ``solver_opts`` raises ``TypeError`` (meshes come with the
multi-GPU slice).
"""
from __future__ import annotations

import hashlib
import itertools
import os
import shutil
from dataclasses import dataclass
from typing import Hashable, Optional

from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph.csr import graph_digest as _graph_digest

# solver constructor options a registry may carry (forwarded verbatim)
_SOLVER_OPTS = frozenset(("engine", "batch", "qcap", "ec", "model", "seed",
                          "selection", "sketch_k", "eval_batch", "device",
                          "fault_policy"))


@dataclass(frozen=True)
class RegistryStats:
    solvers: int
    created: int
    evictions: int
    bytes_in_use: int
    bytes_freed: int
    memory_budget_bytes: Optional[int]
    spills: int = 0
    rehydrations: int = 0
    rehydrate_failures: int = 0
    quarantined: int = 0
    graph_replacements: int = 0
    pool_refreshes: int = 0
    # consistent-hash ring handoff (repro_torch.serve.cluster, DESIGN.md §11)
    handoffs_out: int = 0         # entries exported as leases to a peer
    handoffs_in: int = 0          # leases adopted warm from a peer
    handoff_drops: int = 0        # adoptions that fell back to a cold pool


@dataclass
class WarmEntry:
    """A registry slot: the prepared solver plus accounting state."""
    key: Hashable
    solver: IMMSolver
    problem: IMProblem            # signature template the entry serves
    bytes: int = 0
    solves: int = 0
    seq: int = 0                  # LRU clock (monotonic use counter)
    in_use: bool = False          # pinned while a batch executes on it
    # ε-driven staleness bookkeeping (DESIGN.md §9): solve epochs served
    # off this shared growing pool since it was last (re)sampled fresh,
    # and how often the resample watermark forced a refresh
    staleness: int = 0
    refreshes: int = 0


class WarmSolverRegistry:
    """Keyed warm solvers over a set of registered graphs.

    ``solver_opts`` configure every solver the registry builds
    (engine/batch/selection/seed/... — the :class:`IMMSolver` constructor
    surface); they are part of the service identity, so fresh-solver
    parity checks construct their reference solvers from the same dict.
    ``memory_budget_bytes`` bounds the summed pool bytes (``None`` =
    unbounded); ``max_solvers`` bounds the entry count.
    """

    def __init__(self, *, memory_budget_bytes: Optional[int] = None,
                 max_solvers: Optional[int] = None,
                 solver_opts: Optional[dict] = None,
                 spill_dir: Optional[str] = None):
        if memory_budget_bytes is not None and memory_budget_bytes <= 0:
            raise ValueError("memory_budget_bytes must be positive")
        if max_solvers is not None and max_solvers < 1:
            raise ValueError("max_solvers must be >= 1")
        unknown = set(solver_opts or ()) - _SOLVER_OPTS
        if unknown:
            raise TypeError("unknown solver_opts: "
                            + ", ".join(sorted(unknown)))
        self.memory_budget_bytes = memory_budget_bytes
        self.max_solvers = max_solvers
        self.solver_opts = dict(solver_opts or {})
        self.spill_dir = spill_dir
        self._graphs: dict = {}
        self._digests: "dict[str, str]" = {}
        self._versions: "dict[str, int]" = {}
        self._entries: "dict[Hashable, WarmEntry]" = {}
        self._clock = itertools.count(1)
        self.created = 0
        self.evictions = 0
        self.bytes_freed = 0
        self.spills = 0
        self.rehydrations = 0
        self.rehydrate_failures = 0
        self.quarantines = 0
        self.graph_replacements = 0
        self.pool_refreshes = 0
        self.handoffs_out = 0
        self.handoffs_in = 0
        self.handoff_drops = 0

    # -- graphs ------------------------------------------------------------
    def add_graph(self, name: str, g) -> None:
        """Register — or *replace* — the graph behind ``name``.

        The name is only an address; the identity every key embeds is the
        content digest (:func:`repro_torch.graph.csr.graph_digest`).
        Replacing a name with different content bumps its monotone version
        and evicts every idle warm entry keyed to the old content: those
        keys are unreachable by new requests (their digest no longer
        matches), so their pools/spills would only leak.  In-flight entries
        finish their batch on the old content and age out via LRU — they
        can never serve a post-replacement request either, for the same key
        reason.
        """
        dig = _graph_digest(g)
        old = self._digests.get(name)
        if old is not None and old != dig:
            stale = [k for k, e in self._entries.items()
                     if k[0] == name and not e.in_use]
            for k in stale:
                entry = self._entries.pop(k)
                if entry.solver._sig is not None:
                    lease = entry.solver.export_pool()
                    self.bytes_freed += lease.pool_bytes()
                    del lease
                self.evictions += 1
                self.clear_spill(k)
            self.graph_replacements += 1
            self._versions[name] = self._versions.get(name, 0) + 1
        else:
            self._versions.setdefault(name, 0)
        self._graphs[name] = g
        self._digests[name] = dig

    def graph(self, name: str):
        return self._graphs[name]

    def has_graph(self, name: str) -> bool:
        return name in self._graphs

    def graph_version(self, name: str) -> int:
        """Monotone replacement counter for ``name`` (0 = first content)."""
        return self._versions[name]

    def graph_digest(self, name: str) -> str:
        """Content digest of the graph currently behind ``name``."""
        return self._digests[name]

    # -- keys --------------------------------------------------------------
    def _resolved_model(self, problem: IMProblem) -> str:
        if problem.model is not None:
            return problem.model
        return "lt" if self.solver_opts.get("model") == "lt" else "ic"

    def solver_key(self, graph: str, problem: IMProblem) -> tuple:
        """(graph, pool signature, θ) — requests mapping to the same key
        may share one warm solver *and* may be micro-batched together.

        The pool signature mixes in the registered graph's *content digest*
        (``pool_digest(graph_digest=...)``): an RR pool samples one
        concrete graph, so a replaced or delta-mutated graph hashes to a
        different key and can never borrow a pre-mutation pool (the
        stale-graph serving bug this fixed).
        """
        return (graph,
                problem.pool_digest(model=self._resolved_model(problem),
                                    graph_digest=self._digests.get(graph)),
                problem.theta)

    def cache_key(self, graph: str, problem: IMProblem) -> tuple:
        """Result-cache key: full problem content + the warm identity the
        result was computed under (graph name *and* content digest +
        resolved model; the registry's solver_opts are service-constant,
        so they need no per-key bits).  The digest keeps a re-registered
        graph from ever returning a pre-replacement cached ``IMResult``."""
        return (graph, self._digests.get(graph),
                self._resolved_model(problem), problem.signature_digest())

    # -- entries -----------------------------------------------------------
    @property
    def entries(self) -> "dict[Hashable, WarmEntry]":
        return self._entries

    def bytes_in_use(self) -> int:
        return sum(e.bytes for e in self._entries.values())

    def _spill_path(self, key: Hashable) -> Optional[str]:
        if self.spill_dir is None:
            return None
        tag = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
        return os.path.join(self.spill_dir, tag)

    def get(self, graph: str, problem: IMProblem) -> WarmEntry:
        """Fetch-or-build the warm entry for (graph, problem); touches LRU
        and enforces the budgets (never evicting the returned entry).  A
        miss whose key has a spill snapshot rehydrates the saved pool
        instead of resampling; a corrupt/unreadable snapshot falls back to
        the cold path (the pool is always recomputable)."""
        if graph not in self._graphs:
            raise KeyError(f"unknown graph {graph!r}")
        key = self.solver_key(graph, problem)
        entry = self._entries.get(key)
        if entry is None:
            solver = IMMSolver(self._graphs[graph], **self.solver_opts)
            spill = self._spill_path(key)
            if spill is not None and os.path.isdir(spill):
                try:
                    solver.restore_pool(spill)
                    self.rehydrations += 1
                except Exception:
                    # cold-start instead: drop whatever half-state restore
                    # left and resample deterministically
                    solver.drop_pool()
                    self.rehydrate_failures += 1
            entry = WarmEntry(key=key, solver=solver, problem=problem)
            entry.bytes = solver.pool_bytes()
            self._entries[key] = entry
            self.created += 1
        entry.seq = next(self._clock)
        self._enforce(keep=key)
        return entry

    def account(self, entry: WarmEntry) -> None:
        """Refresh an entry's pool-byte accounting after a solve (pools
        grow via capacity doubling) and re-enforce the memory budget."""
        entry.bytes = entry.solver.pool_bytes()
        entry.seq = next(self._clock)
        self._enforce(keep=entry.key)

    def refresh_pool(self, entry: WarmEntry) -> int:
        """Resample watermark hit (DESIGN.md §9): drop an ε-driven entry's
        shared growing pool so its next solve resamples from scratch.
        Bounds the pool-reuse staleness ε-driven answers accumulate —
        without this the shared pool only ever grows and every answer's
        effective sampling law drifts further from a cold θ(ε) solve.
        Returns the bytes dropped; resets the entry's staleness clock."""
        freed = entry.solver.drop_pool()
        entry.bytes = entry.solver.pool_bytes()
        entry.staleness = 0
        entry.refreshes += 1
        self.pool_refreshes += 1
        self.bytes_freed += freed
        return freed

    def evict(self, key: Hashable) -> int:
        """Evict one entry; returns the pool bytes freed.  With a
        ``spill_dir``, the pool is first written as a durable checkpoint so
        a later miss rehydrates instead of resampling.  The device-memory
        transfer stays explicit: the solver's pool is exported into a
        lease the registry immediately drops — the last reference to the
        device buffers."""
        entry = self._entries.pop(key)
        freed = 0
        if entry.solver._sig is not None:
            spill = self._spill_path(key)
            if spill is not None:
                entry.solver.save_pool(spill, keep=1)
                self.spills += 1
            lease = entry.solver.export_pool()
            freed = lease.pool_bytes()
            del lease
        self.evictions += 1
        self.bytes_freed += freed
        return freed

    def quarantine(self, key: Hashable) -> int:
        """Drop an entry whose solve died mid-flight (DESIGN.md §8).  The
        pool may be partially appended, so — unlike :meth:`evict` — it is
        neither spilled nor exported: the buffers are dereferenced and the
        entry can never serve again.  A pre-existing spill snapshot is
        left in place (snapshots are only written from committed states,
        so rehydrating one later is sound).  Returns the bytes dropped;
        no-op (0) for unknown keys."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return 0
        freed = entry.solver.drop_pool()
        self.quarantines += 1
        self.bytes_freed += freed
        return freed

    def evict_coldest(self) -> int:
        """Free the least-recently-used idle entry (0 if none is
        evictable).  Registered as a ``FaultPolicy.on_oom`` hook: when pool
        growth hits an allocation failure, the service frees cold pools
        and retries the append."""
        cands = [e for e in self._entries.values() if not e.in_use]
        if not cands:
            return 0
        return self.evict(min(cands, key=lambda e: e.seq).key)

    # -- cluster handoff (repro_torch.serve.cluster, DESIGN.md §11) ---------
    def export_entry(self, key: Hashable):
        """Detach one idle entry for a ring-rebalance handoff: pop it and
        return ``(problem, PoolLease)`` — the lease resumes bit-identically
        on the adopting worker (RNG cursor + stats travel with the pool).
        Returns ``None`` when there is nothing to move (unknown key, entry
        pinned by an executing batch, or no pool prepared yet); pinned
        entries are the *caller's* signal to drain first."""
        entry = self._entries.get(key)
        if entry is None or entry.in_use:
            return None
        del self._entries[key]
        if entry.solver._sig is None:
            return None
        lease = entry.solver.export_pool()
        self.handoffs_out += 1
        return entry.problem, lease

    def adopt_entry(self, graph: str, problem: IMProblem, lease
                    ) -> WarmEntry:
        """Install a handed-off pool as a warm entry on this registry (the
        receiving side of :meth:`export_entry`).  When the lease cannot be
        adopted — it comes from a solver of other options, say — it is
        dropped and the entry starts cold instead: θ-pinned answers are
        pool-deterministic, so the served bits are identical either way and
        only the warm-up cost differs."""
        key = self.solver_key(graph, problem)
        solver = IMMSolver(self._graphs[graph], **self.solver_opts)
        try:
            solver.adopt_pool(lease)
            self.handoffs_in += 1
        except Exception:
            solver.drop_pool()
            self.handoff_drops += 1
        entry = WarmEntry(key=key, solver=solver, problem=problem)
        entry.bytes = solver.pool_bytes()
        self._entries[key] = entry
        self.created += 1
        entry.seq = next(self._clock)
        self._enforce(keep=key)
        return entry

    def spill_all(self) -> int:
        """Drain-time spill (SIGTERM path): evict every idle entry through
        the normal spill-on-evict path, so with a ``spill_dir`` configured
        each warm pool lands as a durable checkpoint a restarted server
        rehydrates from.  Returns the number of entries evicted."""
        keys = [k for k, e in self._entries.items() if not e.in_use]
        for k in keys:
            self.evict(k)
        return len(keys)

    def clear_spill(self, key: Hashable) -> None:
        """Delete a key's spill snapshot (used by tests/ops tooling)."""
        spill = self._spill_path(key)
        if spill is not None and os.path.isdir(spill):
            shutil.rmtree(spill, ignore_errors=True)

    def _enforce(self, keep: Hashable) -> None:
        def lru_victim():
            cands = [e for e in self._entries.values()
                     if e.key != keep and not e.in_use]
            return min(cands, key=lambda e: e.seq) if cands else None

        while (self.max_solvers is not None
               and len(self._entries) > self.max_solvers):
            victim = lru_victim()
            if victim is None:
                break
            self.evict(victim.key)
        while (self.memory_budget_bytes is not None
               and self.bytes_in_use() > self.memory_budget_bytes):
            victim = lru_victim()
            if victim is None:
                break
            self.evict(victim.key)

    def snapshot(self) -> RegistryStats:
        return RegistryStats(
            solvers=len(self._entries), created=self.created,
            evictions=self.evictions, bytes_in_use=self.bytes_in_use(),
            bytes_freed=self.bytes_freed,
            memory_budget_bytes=self.memory_budget_bytes,
            spills=self.spills, rehydrations=self.rehydrations,
            rehydrate_failures=self.rehydrate_failures,
            quarantined=self.quarantines,
            graph_replacements=self.graph_replacements,
            pool_refreshes=self.pool_refreshes,
            handoffs_out=self.handoffs_out, handoffs_in=self.handoffs_in,
            handoff_drops=self.handoff_drops)
