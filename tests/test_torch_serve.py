"""The serving front of the port on the CPU: registry, cache and service.

Holds ``repro_torch.serve`` to the assertions of the reference's
``tests/test_serve.py``, on the port's own fresh solvers:

* ``signature_digest``/``pool_digest`` are content hashes: two problems
  differing only in node_weights *values* never share a pool or a cache
  entry;
* ``export_pool``/``adopt_pool`` move a pool and resume its round stream;
* a batched multi-request run returns results bit-identical (seeds, gains,
  the float32 bits of ``frac`` and ``spread``) to solving each request
  alone on a fresh solver;
* requests batch together iff they share the registry key;
* cache hits return the stored object, recomputes agree;
* admission control sheds and expires with typed errors;
* the registry evicts LRU under ``max_solvers`` and the byte budget;
* replacing a graph rotates keys; the ε-driven staleness watermark
  refreshes shared pools.

And to the reference itself: the same registry keys, cache keys and spill
directory names on the same problems and graph content, the same 27
exported names, and ``solver_opts`` that take ``device`` where the
reference takes ``mesh``.  The reference's
``test_execute_batch_under_transfer_guard`` tests JAX's transfer guard and
has no counterpart on the port; its CLI test belongs to
``launch/im_solve.py``, which is not ported yet.
"""
import asyncio

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import serve as tserve
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr as csr_mod
from repro_torch.graph import generators, weights
from repro_torch.serve import (DeadlineExpiredError,
                               InvalidProblemError, QueueFullError,
                               ResultCache, ServeConfig, UnknownGraphError,
                               WarmSolverRegistry, build_service,
                               execute_batch, occur_fastpath_eligible)

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

OPTS = {"batch": 32, "seed": 7, "device": "cpu"}
THETA = 1024
TIMEOUT_S = 120.0


def _wc_graph(n=60, m=300, seed=0):
    src, dst = generators.erdos_renyi(n, m, seed=seed)
    return weights.wc_weights(csr_mod.from_edges(src, dst, n, device="cpu"))


def run(coro):
    """Run one test's event loop under a timeout of its own."""
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


@pytest.fixture(scope="module")
def g():
    return _wc_graph()


_COLD: dict = {}


def cold(g, p):
    """A cold solve of ``p`` on a fresh solver (memoised by graph and
    problem content: a fresh solver's answer depends on nothing else)."""
    key = (csr_mod.graph_digest(g), p.signature_digest())
    if key not in _COLD:
        _COLD[key] = IMMSolver(g, **OPTS).solve(p)
    return _COLD[key]


def _same(a, b):
    np.testing.assert_array_equal(a.seeds, b.seeds)
    np.testing.assert_array_equal(a.gains, b.gains)
    assert a.seeds.dtype == b.seeds.dtype and a.gains.dtype == b.gains.dtype
    assert a.frac == b.frac and a.spread == b.spread
    assert np.float32(a.frac).tobytes() == np.float32(b.frac).tobytes()
    assert np.float32(a.spread).tobytes() == np.float32(b.spread).tobytes()


# ------------------------------------------------------------- digests

def test_digests_distinguish_node_weight_values(g):
    w1 = np.ones(g.n_nodes, np.float32)
    w2 = np.ones(g.n_nodes, np.float32)
    w2[-1] = 2.0
    p1 = IMProblem(k=2, theta=THETA, node_weights=w1)
    p2 = IMProblem(k=2, theta=THETA, node_weights=w2)
    assert p1.pool_digest(model="ic") != p2.pool_digest(model="ic")
    assert p1.signature_digest() != p2.signature_digest()
    assert p1.pool_digest(model="ic") == \
        IMProblem(k=5, theta=2 * THETA,
                  node_weights=w1.copy()).pool_digest(model="ic")

    reg = WarmSolverRegistry(solver_opts=OPTS)
    reg.add_graph("g", g)
    assert reg.solver_key("g", p1) != reg.solver_key("g", p2)
    assert reg.cache_key("g", p1) != reg.cache_key("g", p2)
    assert reg.get("g", p1) is not reg.get("g", p2)

    s = IMMSolver(g, **OPTS)
    s.prepare(p1)
    sig1 = s._sig
    s.prepare(p2)
    assert s._sig != sig1


def test_signature_digest_covers_every_field():
    base = IMProblem(k=2, theta=THETA)
    variants = [
        IMProblem(k=3, theta=THETA),
        IMProblem(k=2, theta=THETA + 1),
        IMProblem(k=2, theta=THETA, eps=0.3),
        IMProblem(k=2, theta=THETA, candidates=np.arange(5)),
        IMProblem(k=2, theta=THETA, model="lt"),
        IMProblem(k=2, theta=THETA, ell=2.0),
    ]
    digests = {p.signature_digest() for p in [base] + variants}
    assert len(digests) == len(variants) + 1


# --------------------------------------------------- pool ownership transfer

def test_export_adopt_pool_resumes_bit_identically(g):
    p = IMProblem(k=3, theta=THETA)
    ref = cold(g, IMProblem(k=3, theta=2 * THETA))

    s1 = IMMSolver(g, **OPTS)
    s1.solve(p)
    lease = s1.export_pool()
    assert lease.pool_bytes() > 0
    assert s1.pool_bytes() == 0
    with pytest.raises(RuntimeError):
        s1.export_pool()

    s2 = IMMSolver(g, **OPTS)
    s2.adopt_pool(lease)
    _same(ref, s2.solve(IMProblem(k=3, theta=2 * THETA)))


# ---------------------------------------------------------------- batching

def test_batched_requests_bit_identical_to_fresh_solvers(g):
    cand = np.arange(10, 40)
    problems = [
        IMProblem(k=1, theta=THETA),
        IMProblem(k=5, theta=THETA),
        IMProblem(k=1, theta=THETA, candidates=cand),
        IMProblem(k=3, theta=THETA, candidates=cand),
    ]
    warm = IMMSolver(g, **OPTS)
    assert occur_fastpath_eligible(warm, problems[0])
    assert occur_fastpath_eligible(warm, problems[2])
    assert not occur_fastpath_eligible(warm, problems[1])
    stats: dict = {}
    batched = execute_batch(warm, problems, stats_out=stats)
    for p, b in zip(problems, batched):
        _same(cold(g, p), b)
    # the two k > 1 requests share one stacked scan, the two top-1
    # requests take the Occur fast path
    assert stats == {"stacked_batches": 1, "stacked_requests": 2}


# -------------------------------------------------- grouping / splitting

def test_solver_key_batches_compatible_splits_incompatible(g):
    reg = WarmSolverRegistry(solver_opts=OPTS)
    reg.add_graph("g", g)
    a = IMProblem(k=1, theta=THETA)
    assert reg.solver_key("g", a) == \
        reg.solver_key("g", IMProblem(k=9, theta=THETA))
    assert reg.solver_key("g", a) == reg.solver_key(
        "g", IMProblem(k=1, theta=THETA, candidates=np.arange(7)))
    assert reg.solver_key("g", a) != \
        reg.solver_key("g", IMProblem(k=1, theta=2 * THETA))
    assert reg.solver_key("g", a) != reg.solver_key(
        "g", IMProblem(k=1, theta=THETA, node_weights=np.ones(g.n_nodes)))
    assert reg.solver_key("g", a) != \
        reg.solver_key("g", IMProblem(k=1, theta=THETA, model="lt"))
    assert reg.solver_key("g", a) != \
        reg.solver_key("g", IMProblem(k=1, eps=0.5))


def test_incompatible_thetas_split_into_two_batches(g):
    probs = [IMProblem(k=1, theta=THETA), IMProblem(k=2, theta=THETA),
             IMProblem(k=1, theta=2 * THETA)]

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            max_batch=8, batch_window_s=0.01, solver_opts=OPTS))
        async with svc:
            got = await asyncio.gather(*(svc.submit("g", p) for p in probs))
        return got, svc.stats()
    got, st = run(go())
    assert st.served == 3 and st.batches == 2
    assert st.registry.solvers == 2
    assert st.batch_occupancy_max == 2
    for p, r in zip(probs, got):
        _same(cold(g, p), r.result)


# ----------------------------------------------------------- the cache

def test_cache_hit_bit_identical_to_recompute(g):
    p = IMProblem(k=4, theta=THETA)

    async def go():
        svc = build_service({"g": g}, ServeConfig(solver_opts=OPTS))
        async with svc:
            r1 = await svc.submit("g", p)
            r2 = await svc.submit("g", p)
        svc2 = build_service({"g": g}, ServeConfig(solver_opts=OPTS))
        async with svc2:
            r3 = await svc2.submit("g", p)
        return r1, r2, r3, svc.stats()
    r1, r2, r3, st = run(go())
    assert not r1.cached and r2.cached and not r3.cached
    assert r2.result is r1.result
    _same(r1.result, r3.result)
    assert st.cache_hits == 1 and st.cache.hits == 1


def test_result_cache_lru_eviction_counters():
    c = ResultCache(max_entries=2)
    c.put("a", 1), c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None
    s = c.snapshot()
    assert (s.hits, s.misses, s.evictions, s.entries) == (1, 1, 1, 2)
    assert s.hit_rate == 0.5
    with pytest.raises(ValueError):
        ResultCache(max_entries=0)


# -------------------------------------------------------- admission control

def test_queue_full_sheds_with_typed_error(g):
    async def go():
        svc = build_service({"g": g}, ServeConfig(
            queue_cap=1, solver_opts=OPTS))
        # no worker: the queue cannot drain, so admission is deterministic
        svc._queue = asyncio.Queue(maxsize=1)
        first = asyncio.ensure_future(
            svc.submit("g", IMProblem(k=1, theta=THETA)))
        await asyncio.sleep(0)
        with pytest.raises(QueueFullError):
            await svc.submit("g", IMProblem(k=2, theta=THETA))
        assert svc.shed == 1
        first.cancel()
    run(go())


def test_expired_deadline_raises_typed_error(g):
    async def go():
        svc = build_service({"g": g}, ServeConfig(solver_opts=OPTS))
        async with svc:
            with pytest.raises(DeadlineExpiredError):
                await svc.submit("g", IMProblem(k=1, theta=THETA),
                                 deadline_s=-0.001)
            ok = await svc.submit("g", IMProblem(k=1, theta=THETA),
                                  deadline_s=30.0)
        return svc.stats(), ok
    st, ok = run(go())
    assert st.expired == 1 and st.served == 1
    assert len(ok.result.seeds) == 1
    _same(cold(g, IMProblem(k=1, theta=THETA)), ok.result)


def test_invalid_requests_rejected_before_admission(g):
    async def go():
        svc = build_service({"g": g}, ServeConfig(solver_opts=OPTS))
        async with svc:
            with pytest.raises(UnknownGraphError):
                await svc.submit("nope", IMProblem(k=1, theta=THETA))
            with pytest.raises(InvalidProblemError):
                await svc.submit("g", IMProblem(
                    k=1, theta=THETA, candidates=np.array([g.n_nodes + 5])))
            with pytest.raises(InvalidProblemError):
                await svc.submit("g", {"k": 1})
        return svc.stats()
    st = run(go())
    assert st.failed == 3 and st.served == 0 and st.batches == 0


# -------------------------------------------------------- registry eviction

def test_registry_max_solvers_lru_eviction(g):
    reg = WarmSolverRegistry(max_solvers=2, solver_opts=OPTS)
    reg.add_graph("g", g)
    for t in (THETA, 2 * THETA, 4 * THETA):
        e = reg.get("g", IMProblem(k=1, theta=t))
        e.solver.solve(IMProblem(k=1, theta=t))
        reg.account(e)
    st = reg.snapshot()
    assert st.solvers == 2 and st.evictions == 1
    assert st.bytes_freed > 0
    assert {k[2] for k in reg.entries} == {2 * THETA, 4 * THETA}


def test_registry_memory_budget_eviction(g):
    reg = WarmSolverRegistry(solver_opts=OPTS)
    reg.add_graph("g", g)
    e1 = reg.get("g", IMProblem(k=1, theta=THETA))
    e1.solver.solve(IMProblem(k=1, theta=THETA))
    reg.account(e1)
    one_pool = reg.bytes_in_use()
    assert one_pool == e1.solver.pool_bytes() > 0
    reg.memory_budget_bytes = int(2.5 * one_pool)
    e2 = reg.get("g", IMProblem(k=1, theta=2 * THETA))
    e2.solver.solve(IMProblem(k=1, theta=2 * THETA))
    reg.account(e2)
    st = reg.snapshot()
    assert st.evictions == 1 and st.solvers == 1
    assert st.bytes_in_use <= reg.memory_budget_bytes
    assert list(reg.entries.values())[0] is e2


# ------------------------------------------------------ streaming graphs

def test_reregistering_graph_with_new_edges_misses_cache_and_evicts(g):
    g2 = _wc_graph(seed=99)
    p = IMProblem(k=3, theta=THETA)

    reg = WarmSolverRegistry(solver_opts=OPTS)
    reg.add_graph("g", g)
    k1 = reg.solver_key("g", p)
    c1 = reg.cache_key("g", p)
    e = reg.get("g", p)
    e.solver.solve(p)
    reg.account(e)
    assert reg.graph_version("g") == 0

    reg.add_graph("g", g)
    assert reg.graph_version("g") == 0
    assert reg.snapshot().graph_replacements == 0
    assert k1 in reg.entries

    reg.add_graph("g", g2)
    assert reg.graph_version("g") == 1
    st = reg.snapshot()
    assert st.graph_replacements == 1 and st.evictions == 1
    assert st.bytes_freed > 0
    assert k1 not in reg.entries and not reg.entries
    assert reg.solver_key("g", p) != k1
    assert reg.cache_key("g", p) != c1

    async def go():
        svc = build_service({"g": g}, ServeConfig(solver_opts=OPTS))
        async with svc:
            r1 = await svc.submit("g", p)
            r1b = await svc.submit("g", p)
            svc.registry.add_graph("g", g2)
            r2 = await svc.submit("g", p)
            r2b = await svc.submit("g", p)
        return r1, r1b, r2, r2b
    r1, r1b, r2, r2b = run(go())
    assert not r1.cached and r1b.cached
    assert not r2.cached and r2b.cached
    assert r2b.result is r2.result
    _same(cold(g, p), r1.result)
    _same(cold(g2, p), r2.result)


def test_eps_driven_pool_staleness_watermark_refreshes(g):
    async def go(problems, staleness):
        svc = build_service({"g": g}, ServeConfig(
            solver_opts=OPTS, max_pool_staleness=staleness))
        async with svc:
            for p in problems:
                await svc.submit("g", p)
            return svc.stats()
    st = run(go([IMProblem(k=k, eps=0.5) for k in (1, 2, 3, 4, 5)], 2))
    assert st.served == 5
    assert st.refreshes == 2
    assert st.pool_staleness == 1
    assert st.registry.pool_refreshes == 2
    assert st.registry.bytes_freed > 0

    st = run(go([IMProblem(k=k, theta=THETA) for k in (1, 2, 3)], 1))
    assert st.served == 3 and st.refreshes == 0 and st.pool_staleness == 0


# ------------------------------------------------- the port and its options

def test_solver_opts_take_device_where_the_reference_takes_mesh(g):
    with pytest.raises(TypeError, match="unknown solver_opts: mesh"):
        WarmSolverRegistry(solver_opts={"mesh": None})
    reg = WarmSolverRegistry(solver_opts={"batch": 32, "seed": 7})
    reg.add_graph("g", g)
    if not torch.cuda.is_available():
        # the default device is the card: without one the registry raises
        # instead of serving from the CPU
        with pytest.raises(RuntimeError, match="no CUDA card"):
            reg.get("g", IMProblem(k=1, theta=THETA))
    entry = WarmSolverRegistry(solver_opts=OPTS)
    entry.add_graph("g", g)
    assert entry.get("g", IMProblem(k=1, theta=THETA)).solver.device \
        == torch.device("cpu")


def test_exports_are_the_reference_names():
    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    assert len(tserve.__all__) == 27
    for name in tserve.__all__:
        obj = getattr(tserve, name)
        assert isinstance(obj, dict) or \
            obj.__module__.startswith("repro_torch.serve."), name


@pytest.mark.parametrize("kind", ["plain", "eps", "weighted", "lt"])
def test_keys_and_spill_names_equal_the_reference(g, kind):
    from repro.core.problem import IMProblem as JProblem
    src, dst = jgen.erdos_renyi(60, 300, seed=0)
    jg = jw.wc_weights(jcsr.from_edges(src, dst, 60))
    w = (np.arange(60) % 7 + 1).astype(np.float32)
    kw = {"plain": dict(k=3, theta=THETA), "eps": dict(k=3, eps=0.5),
          "weighted": dict(k=3, theta=THETA, node_weights=w),
          "lt": dict(k=3, theta=THETA, model="lt")}[kind]
    treg = WarmSolverRegistry(solver_opts=OPTS, spill_dir="/spill")
    jreg = jserve.WarmSolverRegistry(solver_opts={"batch": 32, "seed": 7},
                                     spill_dir="/spill")
    treg.add_graph("g", g)
    jreg.add_graph("g", jg)
    assert treg.graph_digest("g") == jreg.graph_digest("g")
    tp, jp = IMProblem(**kw), JProblem(**kw)
    assert treg.solver_key("g", tp) == jreg.solver_key("g", jp)
    assert treg.cache_key("g", tp) == jreg.cache_key("g", jp)
    key = treg.solver_key("g", tp)
    assert treg._spill_path(key) == jreg._spill_path(key)
