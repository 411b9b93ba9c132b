"""Async request front for IM-as-a-service (the reference's
``repro.serve.front``, on the port; stdlib asyncio, no new deps).

Request lifecycle (DESIGN.md §7 has the diagram):

    submit(graph, problem)
      ├─ validate            → UnknownGraphError / InvalidProblemError
      ├─ result cache probe  → cached ServeResponse (no queue, no solver)
      ├─ admission           → QueueFullError when the bounded queue is full
      └─ enqueue ── worker ──┐
                             ├─ drain ≤ max_batch requests, group by
                             │  registry key (compatible = same graph +
                             │  pool signature + θ-mode)
                             ├─ drop expired requests → DeadlineExpiredError
                             ├─ execute_batch() per group on the group's
                             │  warm solver, on the single worker thread
                             └─ cache fills + respond

Admission control is three knobs: ``queue_cap`` (bounded queue —
overload sheds *at the door* with a typed error instead of growing
latency unboundedly), per-request deadlines (expired work is dropped
*before* it wastes solver time), and the registry's device-memory budget
(LRU pool eviction).  The solve itself runs on a dedicated
single-thread executor, so the event loop keeps admitting/shedding while
a batch computes — and one thread of a service launches the batch's
kernels, on PyTorch's current stream of that thread (the card's default
stream: a service makes no stream of its own, so two services' cooperative
selection grids never share the card at once).

Failure isolation (DESIGN.md §8): a batch whose execution dies does NOT
fail every request in it.  The entry that was executing is *quarantined*
(its possibly partially-appended pool must never serve again), then each
request re-runs alone on a fresh entry — a poisoned request fails with a
typed error by itself while its batch-mates still get served.  A
per-registry-key circuit breaker (closed → open after N consecutive
failures → half-open probe after a cooldown) stops a persistently failing
key from burning executor time, and requests carrying deadlines degrade
mid-solve to certified sketch-bound answers (``ServeResponse.degraded``)
instead of expiring.  Every outcome is typed: served, degraded, or a
``ServeError`` subclass — submit() never hangs and never returns an
unlabelled partial answer.
"""
from __future__ import annotations

import asyncio
import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.problem import IMProblem, IMResult
from repro_torch.ft.failures import DeadlineExceeded
from repro_torch.serve.batching import execute_batch, occur_fastpath_eligible
from repro_torch.serve.cache import CacheStats, ResultCache
from repro_torch.serve.registry import RegistryStats, WarmSolverRegistry


# -- typed errors ------------------------------------------------------------

class ServeError(Exception):
    """Base of the typed request-rejection responses."""
    code = "error"


class UnknownGraphError(ServeError):
    code = "unknown_graph"


class InvalidProblemError(ServeError):
    code = "invalid_problem"


class QueueFullError(ServeError):
    """Load shed: the bounded admission queue is full."""
    code = "queue_full"


class DeadlineExpiredError(ServeError):
    """The request's deadline passed before a solver picked it up (or
    expired mid-solve on an objective with no degraded answer)."""
    code = "deadline_expired"


class SolverFailedError(ServeError):
    """The request's solve raised even when run in isolation; the original
    error type/message is preserved in ``str(e)``."""
    code = "solver_failed"


class CircuitOpenError(ServeError):
    """The request's registry key has failed repeatedly and its circuit
    breaker is open; retry after the cooldown (a half-open probe will test
    the key again)."""
    code = "circuit_open"


# -- request/response envelopes ---------------------------------------------

@dataclass
class ServeConfig:
    """Admission-control + batching knobs (DESIGN.md §7)."""
    max_batch: int = 16           # requests drained into one micro-batch
    queue_cap: int = 64           # bounded admission queue (shed beyond)
    batch_window_s: float = 0.0   # linger after the first dequeue to let
    #                               a batch accumulate (0 = drain-only)
    default_deadline_s: Optional[float] = None   # None = no deadline
    cache_entries: int = 1024
    memory_budget_bytes: Optional[int] = None
    max_solvers: Optional[int] = None
    solver_opts: dict = field(default_factory=dict)
    # fault handling (DESIGN.md §8)
    breaker_threshold: int = 3    # consecutive failures that open a key's
    #                               circuit breaker
    breaker_cooldown_s: float = 1.0   # open -> half-open probe delay
    spill_dir: Optional[str] = None   # registry spill-on-evict directory
    # ε-driven resample watermark (DESIGN.md §9): an entry whose θ-less
    # shared pool has served this many requests since it was last sampled
    # fresh is refreshed (pool dropped + resampled) before serving more.
    # None = unbounded (the historical drift this knob exists to stop).
    max_pool_staleness: Optional[int] = None
    # batched on-device selection (DESIGN.md §11): fixed-θ requests in one
    # micro-batch share a single stacked selection scan instead of one scan
    # each.  Bit-identical either way — purely a throughput knob.
    stacked_selection: bool = True


@dataclass
class ServeResponse:
    result: IMResult
    cached: bool                  # served from the result cache
    batch_size: int               # occupancy of the batch that computed it
    queued_s: float               # admission -> execution start
    solve_s: float                # execution wall time of the batch
    degraded: bool = False        # deadline-clipped sketch answer: the
    #                               result carries certified spread_bounds
    #                               and is never cached


@dataclass
class _Breaker:
    """Per-registry-key circuit breaker.  closed → (threshold consecutive
    failures) → open → (cooldown) → half-open, where exactly one probe
    attempt runs: success closes the breaker, failure re-opens it.  The
    worker is single-threaded, so no locking is needed."""
    threshold: int
    cooldown_s: float
    state: str = "closed"
    failures: int = 0             # consecutive
    opened_at: float = 0.0
    trips: int = 0

    def allow(self, now: float) -> bool:
        if self.state == "open" and now - self.opened_at >= self.cooldown_s:
            self.state = "half-open"
        return self.state != "open"

    def record(self, ok: bool, now: float) -> None:
        if ok:
            self.state = "closed"
            self.failures = 0
            return
        self.failures += 1
        if self.state == "half-open" or self.failures >= self.threshold:
            if self.state != "open":
                self.trips += 1
            self.state = "open"
            self.opened_at = now
            self.failures = 0


@dataclass
class _Pending:
    graph: str
    problem: IMProblem
    deadline: Optional[float]     # absolute loop time
    t_submit: float
    future: "asyncio.Future[ServeResponse]"


@dataclass(frozen=True)
class ServeStats:
    """Point-in-time service counters (plus cache/registry snapshots)."""
    submitted: int
    served: int
    cache_hits: int
    shed: int
    expired: int
    failed: int
    batches: int
    batch_occupancy_mean: float
    batch_occupancy_max: int
    occur_fastpath: int
    cache: CacheStats
    registry: RegistryStats
    # fault handling (DESIGN.md §8)
    degraded: int = 0             # deadline-clipped sketch answers served
    quarantines: int = 0          # entries dropped after a mid-flight death
    isolated_retries: int = 0     # requests re-run alone after a batch died
    solver_retries: int = 0       # in-solver FaultPolicy retries (shared)
    breaker_trips: int = 0        # closed/half-open -> open transitions
    breakers_open: int = 0        # keys currently open or half-open
    # ε-driven pool staleness (DESIGN.md §9)
    pool_staleness: int = 0       # worst current staleness across entries
    refreshes: int = 0            # watermark-forced pool resamples
    # batched on-device selection (DESIGN.md §11)
    stacked_batches: int = 0      # micro-batches that ran a stacked scan
    stacked_requests: int = 0     # requests answered by a stacked scan


def build_service(graphs: dict, config: Optional[ServeConfig] = None
                  ) -> "IMService":
    """Construct a registry from ``config`` and wrap it in a service."""
    config = config or ServeConfig()
    registry = WarmSolverRegistry(
        memory_budget_bytes=config.memory_budget_bytes,
        max_solvers=config.max_solvers,
        solver_opts=config.solver_opts,
        spill_dir=config.spill_dir)
    for name, g in graphs.items():
        registry.add_graph(name, g)
    return IMService(registry, config)


class IMService:
    """The micro-batched request front over a :class:`WarmSolverRegistry`.

    Use as an async context manager (or call ``start()``/``stop()``)::

        registry = WarmSolverRegistry(solver_opts={"batch": 64})
        registry.add_graph("social", g)
        async with IMService(registry, ServeConfig(max_batch=8)) as svc:
            res = await svc.submit("social", IMProblem(k=5, theta=4096))
    """

    def __init__(self, registry: WarmSolverRegistry,
                 config: Optional[ServeConfig] = None):
        self.registry = registry
        self.config = config or ServeConfig()
        self.cache = ResultCache(self.config.cache_entries)
        self._queue: "asyncio.Queue[_Pending] | None" = None
        self._worker_task: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        # counters
        self.submitted = 0
        self.served = 0
        self.cache_hits = 0
        self.shed = 0
        self.expired = 0
        self.failed = 0
        self.batches = 0
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.occur_fastpath = 0
        self.stacked_batches = 0
        self.stacked_requests = 0
        self.degraded = 0
        self.quarantines = 0
        self.isolated_retries = 0
        self._breakers: "dict[tuple, _Breaker]" = {}
        # shared in-solver fault policy (chaos injection + retry counters):
        # the registry forwards it to every solver it builds
        self._policy = self.config.solver_opts.get("fault_policy")

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "IMService":
        if self._worker_task is not None:
            raise RuntimeError("service already started")
        self._queue = asyncio.Queue(maxsize=self.config.queue_cap)
        # one worker thread: batches execute strictly in order and one
        # thread launches this service's kernels
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="im-serve")
        if (self._policy is not None
                and self.registry.evict_coldest not in self._policy.on_oom):
            # growth-OOM recovery: free cold warm pools, then retry the
            # append that hit the allocation failure
            self._policy.on_oom.append(self.registry.evict_coldest)
        self._worker_task = asyncio.get_running_loop().create_task(
            self._worker())
        return self

    async def stop(self) -> None:
        if self._worker_task is None:
            return
        await self.drain()
        self._worker_task.cancel()
        try:
            await self._worker_task
        except asyncio.CancelledError:
            pass
        self._worker_task = None
        self._executor.shutdown(wait=True)
        self._executor = None

    async def drain(self) -> None:
        """Wait until every admitted request has been responded to."""
        await self._queue.join()

    async def __aenter__(self) -> "IMService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission --------------------------------------------------------
    async def submit(self, graph: str, problem: IMProblem,
                     deadline_s: Optional[float] = None) -> ServeResponse:
        """Admit one request and await its typed response.

        Raises :class:`UnknownGraphError` / :class:`InvalidProblemError`
        immediately, :class:`QueueFullError` when admission sheds, and
        :class:`DeadlineExpiredError` when the deadline passes in-queue.
        """
        if self._queue is None:
            raise RuntimeError("service not started")
        self.submitted += 1
        if not self.registry.has_graph(graph):
            self.failed += 1
            raise UnknownGraphError(f"graph {graph!r} is not registered")
        if not isinstance(problem, IMProblem):
            self.failed += 1
            raise InvalidProblemError(
                f"expected an IMProblem, got {type(problem).__name__}")
        try:
            # validate against the concrete graph up front so malformed
            # requests never consume queue or solver capacity
            problem.resolve(self.registry.graph(graph).n_nodes)
        except ValueError as e:
            self.failed += 1
            raise InvalidProblemError(str(e)) from e
        hit = self.cache.get(self.registry.cache_key(graph, problem))
        if hit is not None:
            self.cache_hits += 1
            self.served += 1
            return ServeResponse(result=hit, cached=True, batch_size=0,
                                 queued_s=0.0, solve_s=0.0)
        loop = asyncio.get_running_loop()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        pending = _Pending(
            graph=graph, problem=problem,
            deadline=(None if deadline_s is None
                      else loop.time() + deadline_s),
            t_submit=loop.time(), future=loop.create_future())
        try:
            self._queue.put_nowait(pending)
        except asyncio.QueueFull:
            self.shed += 1
            raise QueueFullError(
                f"admission queue full ({self.config.queue_cap} pending)"
            ) from None
        return await pending.future

    # -- worker ------------------------------------------------------------
    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch: List[_Pending] = [await self._queue.get()]
            if self.config.batch_window_s > 0:
                # linger so concurrent arrivals can share the batch
                await asyncio.sleep(self.config.batch_window_s)
            while len(batch) < self.config.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                # compatible requests share a warm solver: group by
                # registry key, preserving arrival order within groups
                groups: "dict[tuple, List[_Pending]]" = {}
                for p in batch:
                    key = self.registry.solver_key(p.graph, p.problem)
                    groups.setdefault(key, []).append(p)
                for group in groups.values():
                    await self._run_group(loop, group)
            finally:
                for _ in batch:
                    self._queue.task_done()

    async def _run_group(self, loop, group: List[_Pending]) -> None:
        now = loop.time()
        live: List[_Pending] = []
        for p in group:
            if p.deadline is not None and now > p.deadline:
                self.expired += 1
                self.failed += 1
                p.future.set_exception(DeadlineExpiredError(
                    f"deadline passed {now - p.deadline:.3f}s before "
                    "execution"))
            else:
                live.append(p)
        if not live:
            return
        # second cache probe: an identical request earlier in this very
        # run of batches may have just filled the entry
        todo: List[_Pending] = []
        for p in live:
            hit = self.cache.get(self.registry.cache_key(p.graph, p.problem))
            if hit is not None:
                self.cache_hits += 1
                self.served += 1
                p.future.set_result(ServeResponse(
                    result=hit, cached=True, batch_size=0,
                    queued_s=now - p.t_submit, solve_s=0.0))
            else:
                todo.append(p)
        if not todo:
            return
        key = self.registry.solver_key(todo[0].graph, todo[0].problem)
        breaker = self._breakers.get(key)
        if breaker is None:
            breaker = self._breakers[key] = _Breaker(
                self.config.breaker_threshold,
                self.config.breaker_cooldown_s)
        if not breaker.allow(loop.time()):
            self.failed += len(todo)
            for p in todo:
                p.future.set_exception(CircuitOpenError(
                    f"registry key {key[0]!r}/... is failing; circuit open "
                    f"for {self.config.breaker_cooldown_s:.1f}s"))
            return
        try:
            self._respond(todo, *await self._execute(loop, key, todo))
            breaker.record(True, loop.time())
            return
        except asyncio.CancelledError:
            raise
        except BaseException:
            # batch attempt died: the shared entry has been quarantined by
            # _execute.  Isolate the blast radius — re-run each request
            # alone on a fresh entry so a poisoned request fails by itself
            # while its batch-mates still get served.
            breaker.record(False, loop.time())
        for p in todo:
            if p.future.done():
                continue
            self.isolated_retries += 1
            try:
                self._respond([p], *await self._execute(loop, key, [p]))
                breaker.record(True, loop.time())
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                breaker.record(False, loop.time())
                self.failed += 1
                p.future.set_exception(self._typed(e))

    async def _execute(self, loop, key, reqs: List[_Pending]):
        """One executor attempt over requests sharing a registry key.
        Returns ``(results, t0, solve_s)``; on ANY failure the executing
        entry is quarantined first (its pool may be partially appended and
        must never serve again — DESIGN.md §8), then the error propagates
        to the caller's isolation/breaker logic."""
        entry = self.registry.get(reqs[0].graph, reqs[0].problem)
        if (key[2] is None and self.config.max_pool_staleness is not None
                and entry.staleness >= self.config.max_pool_staleness):
            # ε-driven entries answer off one shared growing pool; past the
            # resample watermark the pool is dropped and sampled fresh so
            # pool-reuse staleness stays bounded (DESIGN.md §9)
            self.registry.refresh_pool(entry)
        entry.in_use = True
        problems = [p.problem for p in reqs]
        t0 = loop.time()
        # per-request remaining budget at attempt start: solver-side
        # monotonic seconds (loop.time() is only valid on this loop)
        deadlines = [None if p.deadline is None
                     else max(0.0, p.deadline - t0) for p in reqs]
        try:
            fast_before = self._fastpath_probe(entry.solver, problems)
            if self._policy is not None:
                # chaos boundary standing in for an executor-side death
                self._policy.check("executor", {"n": len(reqs)})
            stack_stats: dict = {}
            results = await loop.run_in_executor(
                self._executor, functools.partial(
                    execute_batch, entry.solver, problems, deadlines,
                    stacked=self.config.stacked_selection,
                    stats_out=stack_stats))
        except BaseException:
            entry.in_use = False
            self.registry.quarantine(key)
            self.quarantines += 1
            raise
        entry.in_use = False
        solve_s = loop.time() - t0
        self.occur_fastpath += fast_before
        self.stacked_batches += stack_stats.get("stacked_batches", 0)
        self.stacked_requests += stack_stats.get("stacked_requests", 0)
        entry.solves += len(reqs)
        if key[2] is None:
            entry.staleness += len(reqs)
        self.registry.account(entry)
        self.batches += 1
        self.occupancy_sum += len(reqs)
        self.occupancy_max = max(self.occupancy_max, len(reqs))
        return results, t0, solve_s

    def _respond(self, reqs: List[_Pending], results, t0, solve_s) -> None:
        for p, res in zip(reqs, results):
            if res.degraded:
                # labelled partial answer: never cached (a later request
                # with more budget deserves the exact result)
                self.degraded += 1
            else:
                self.cache.put(self.registry.cache_key(p.graph, p.problem),
                               res)
            self.served += 1
            p.future.set_result(ServeResponse(
                result=res, cached=False, batch_size=len(reqs),
                queued_s=t0 - p.t_submit, solve_s=solve_s,
                degraded=res.degraded))

    @staticmethod
    def _typed(e: BaseException) -> ServeError:
        """Map an isolation-run failure to the typed error surface."""
        if isinstance(e, ServeError):
            return e
        if isinstance(e, DeadlineExceeded):
            return DeadlineExpiredError(str(e))
        return SolverFailedError(f"{type(e).__name__}: {e}")

    @staticmethod
    def _fastpath_probe(solver, problems) -> int:
        # on the event-loop thread: host-only, it reads no tensor
        return sum(1 for p in problems
                   if occur_fastpath_eligible(solver, p))

    def spill_pools(self) -> int:
        """Drain-time pool spill (the network server's SIGTERM path): evict
        every idle warm entry through the registry's spill-on-evict path.
        Call only after ``drain()`` — pinned entries are skipped."""
        return self.registry.spill_all()

    # -- stats -------------------------------------------------------------
    def stats(self) -> ServeStats:
        return ServeStats(
            submitted=self.submitted, served=self.served,
            cache_hits=self.cache_hits, shed=self.shed,
            expired=self.expired, failed=self.failed, batches=self.batches,
            batch_occupancy_mean=(self.occupancy_sum / self.batches
                                  if self.batches else 0.0),
            batch_occupancy_max=self.occupancy_max,
            occur_fastpath=self.occur_fastpath,
            cache=self.cache.snapshot(),
            registry=self.registry.snapshot(),
            degraded=self.degraded, quarantines=self.quarantines,
            isolated_retries=self.isolated_retries,
            solver_retries=(self._policy.retries
                            if self._policy is not None else 0),
            breaker_trips=sum(b.trips for b in self._breakers.values()),
            breakers_open=sum(1 for b in self._breakers.values()
                              if b.state != "closed"),
            pool_staleness=max(
                (e.staleness for e in self.registry.entries.values()),
                default=0),
            refreshes=self.registry.pool_refreshes,
            stacked_batches=self.stacked_batches,
            stacked_requests=self.stacked_requests)
