"""Multi-worker scale-out (the reference's ``repro.serve.cluster``, on the
port): one ``IMService`` + event loop per worker, routed by a
consistent-hash ring over registry keys.

**Why a ring over registry keys.**  The expensive serving state is the
warm pool, and a pool's identity is the registry key — ``(graph_digest,
pool_digest, θ, mode)``.  Hashing that route string onto a vnode ring
means every request for one pool lands on exactly one worker (so a pool
is sampled and held once cluster-wide, never duplicated), and worker
join/leave moves only the minimal key range: with V vnodes per worker and
W workers, a join relocates ~1/(W+1) of the keys and a leave exactly the
departed worker's share — everything else keeps its owner bit for bit
(``tests/test_torch_serve_net.py`` asserts both properties, and that
the ring places every key on the reference's owner).

**Handoff.**  When the ring rebalances, the moved keys' pools travel as
:class:`~repro_torch.core.imm.PoolLease` exports: the old owner's registry pops
the idle entry (:meth:`WarmSolverRegistry.export_entry`), the new owner
adopts the lease (:meth:`~WarmSolverRegistry.adopt_entry`) — RNG cursor
and stats travel with the pool, so the adopted entry keeps answering
bit-identically.  If adoption is impossible (a lease from a solver of
other options), the lease is dropped and the pool resamples cold on the
new owner; θ-pinned answers are pool-deterministic, so only warm-up cost
is lost, never answer bits.

**Threading.**  Each worker owns a thread running its own event loop and
``IMService`` (whose executor serializes device work per worker).  On one
card every worker's solvers run on the same device
(``ServeConfig.solver_opts["device"]``) and launch on PyTorch's current
stream of their executor thread, the card's default stream: the workers'
requests are in flight at once, and their kernels queue on that stream in
the order the threads launch them (no stream per worker, so two
cooperative selection grids never share the card).
``IMCluster.submit`` is awaited from any loop and bridges with
``run_coroutine_threadsafe``; ``add_worker``/``remove_worker`` are
blocking control-plane calls — run them from outside the serving loops.
"""
from __future__ import annotations

import asyncio
import bisect
import hashlib
import threading
from typing import Dict, List, Optional

from repro_torch.graph.csr import graph_digest
from repro_torch.serve.front import (IMService, ServeConfig, ServeResponse,
                                     UnknownGraphError, build_service)
from repro_torch.serve.net import service_statsz


class HashRing:
    """Consistent-hash ring: sha256-placed vnodes, bisect owner lookup."""

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._workers: "set" = set()
        self._hashes: List[int] = []
        self._owners: List[object] = []

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(s.encode()).digest()[:8], "big")

    def add(self, worker) -> None:
        if worker in self._workers:
            raise ValueError(f"worker {worker!r} already on the ring")
        self._workers.add(worker)
        for v in range(self.vnodes):
            h = self._hash(f"{worker}#{v}")
            i = bisect.bisect_left(self._hashes, h)
            self._hashes.insert(i, h)
            self._owners.insert(i, worker)

    def remove(self, worker) -> None:
        self._workers.remove(worker)
        keep = [(h, w) for h, w in zip(self._hashes, self._owners)
                if w != worker]
        self._hashes = [h for h, _ in keep]
        self._owners = [w for _, w in keep]

    def owner(self, key: str):
        if not self._hashes:
            raise RuntimeError("empty ring")
        i = bisect.bisect_right(self._hashes, self._hash(key))
        return self._owners[i % len(self._owners)]

    @property
    def workers(self):
        return frozenset(self._workers)


class _Worker:
    """A worker thread: its own event loop + started IMService."""

    def __init__(self, wid: int, graphs: dict, config: ServeConfig):
        self.wid = wid
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=self._run, name=f"im-worker-{wid}", daemon=True)
        self.service: IMService = build_service(graphs, config)

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def start(self) -> None:
        self.thread.start()
        self.call(self.service.start()).result()

    def call(self, coro):
        """Schedule a coroutine on this worker's loop; returns a
        concurrent future (``.result()`` from sync code, wrap with
        ``asyncio.wrap_future`` to await from another loop)."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self) -> None:
        self.call(self.service.stop()).result()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join()
        self.loop.close()


async def _export_moving(service: IMService, owned_by, wid, route_of):
    """Runs ON the worker loop: export every idle entry whose ring owner
    is no longer this worker.  Returns [(graph, route, problem, lease)]."""
    moved = []
    reg = service.registry
    for key in list(reg.entries.keys()):
        entry = reg.entries.get(key)
        if entry is None or entry.in_use:
            continue
        route = route_of(reg, key, entry)
        if owned_by(route) != wid:
            ex = reg.export_entry(key)
            if ex is not None:
                moved.append((key[0], route, ex[0], ex[1]))
    return moved


async def _adopt(service: IMService, graph, problem, lease) -> None:
    service.registry.adopt_entry(graph, problem, lease)


class IMCluster:
    """Consistent-hash routed cluster of :class:`IMService` workers.

    Exposes the same async ``submit/drain/stop`` surface as a single
    service, so :class:`~repro_torch.serve.net.IMNetServer` fronts either
    interchangeably.  Graphs are registered identically on every worker
    (the graph objects are shared read-only; only pools are partitioned).
    """

    def __init__(self, graphs: dict, config: Optional[ServeConfig] = None,
                 *, workers: int = 2, vnodes: int = 64):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.graphs = dict(graphs)
        self.config = config or ServeConfig()
        self.ring = HashRing(vnodes)
        self._workers: Dict[int, _Worker] = {}
        self._next_wid = 0
        self._n_initial = workers
        self.handoffs = 0
        self._digests = {name: graph_digest(g)
                         for name, g in self.graphs.items()}

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> "IMCluster":
        if self._workers:
            raise RuntimeError("cluster already started")
        for _ in range(self._n_initial):
            self._spawn()
        return self

    def _spawn(self) -> int:
        wid = self._next_wid
        self._next_wid += 1
        w = _Worker(wid, self.graphs, self.config)
        w.start()
        self._workers[wid] = w
        self.ring.add(wid)
        return wid

    async def drain(self) -> None:
        for w in list(self._workers.values()):
            await asyncio.wrap_future(w.call(w.service.drain()))

    async def stop(self) -> None:
        for w in list(self._workers.values()):
            w.stop()
        self._workers.clear()

    def spill_pools(self) -> int:
        return sum(w.service.registry.spill_all()
                   for w in self._workers.values())

    # -- routing ------------------------------------------------------------
    def route_key(self, graph: str, problem) -> str:
        """The ring route: the same (graph_digest, pool_digest, θ, mode)
        identity as the registry key, rendered as a string."""
        if graph not in self._digests:
            raise UnknownGraphError(f"unknown graph {graph!r}")
        dig = self._digests[graph]
        model = (problem.model or
                 ("lt" if self.config.solver_opts.get("model") == "lt"
                  else "ic"))
        pd = problem.pool_digest(model=model, graph_digest=dig)
        return f"{dig}|{pd}|{problem.theta}|{problem.mode}"

    @staticmethod
    def _entry_route(registry, key, entry) -> str:
        """Ring route of an existing registry entry — identical string to
        :meth:`route_key` for the problems that built it (``key[1]`` is the
        digest-mixed pool_digest, ``key[2]`` the θ)."""
        return (f"{registry.graph_digest(key[0])}|{key[1]}|{key[2]}"
                f"|{entry.problem.mode}")

    async def submit(self, graph: str, problem, deadline_s=None
                     ) -> ServeResponse:
        wid = self.ring.owner(self.route_key(graph, problem))
        w = self._workers[wid]
        return await asyncio.wrap_future(
            w.call(w.service.submit(graph, problem,
                                    deadline_s=deadline_s)))

    # -- membership / rebalance --------------------------------------------
    def _rebalance(self) -> int:
        """Move every idle entry whose route no longer hashes to its
        current worker (consistent hashing: that set is exactly the
        minimal key range).  Blocking control-plane call."""
        moved = 0
        owned_by = self.ring.owner
        for w in list(self._workers.values()):
            exports = w.call(_export_moving(
                w.service, owned_by, w.wid, self._entry_route)).result()
            for graph, route, problem, lease in exports:
                dest = self._workers[owned_by(route)]
                dest.call(_adopt(dest.service, graph, problem,
                                 lease)).result()
                moved += 1
        self.handoffs += moved
        return moved

    def add_worker(self) -> int:
        """Join: spawn a worker, extend the ring, hand off exactly the
        keys the new vnodes claimed.  Returns the new worker id."""
        wid = self._spawn()
        self._rebalance()
        return wid

    def remove_worker(self, wid: int) -> int:
        """Leave: drain the departing worker, shrink the ring, hand its
        entries to their new owners, stop it.  Returns entries moved."""
        if len(self._workers) <= 1:
            raise ValueError("cannot remove the last worker")
        w = self._workers[wid]
        w.call(w.service.drain()).result()
        self.ring.remove(wid)
        owned_by = self.ring.owner
        exports = w.call(_export_moving(
            w.service, owned_by, w.wid, self._entry_route)).result()
        moved = 0
        for graph, route, problem, lease in exports:
            dest = self._workers[owned_by(route)]
            dest.call(_adopt(dest.service, graph, problem,
                             lease)).result()
            moved += 1
        self.handoffs += moved
        del self._workers[wid]
        w.stop()
        return moved

    # -- stats --------------------------------------------------------------
    async def statsz(self, *, draining: bool = False) -> dict:
        """Aggregated /statsz payload: per-worker ServeStats trees plus
        cluster totals and the ring layout."""
        per_worker = []
        for w in list(self._workers.values()):
            snap = await asyncio.wrap_future(
                w.call(_statsz_async(w.service)))
            snap["worker"] = w.wid
            per_worker.append(snap)
        serve_total: dict = {}
        entries = []
        for snap in per_worker:
            entries.extend(dict(e, worker=snap["worker"])
                           for e in snap["entries"])
            for k, v in snap["serve"].items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    serve_total[k] = serve_total.get(k, 0) + v
        return {"cluster": True, "draining": draining,
                "workers": sorted(w.wid for w in self._workers.values()),
                "handoffs": self.handoffs,
                "serve_total": serve_total, "entries": entries,
                "per_worker": per_worker}


async def _statsz_async(service: IMService) -> dict:
    return service_statsz(service)
