"""The serving front's fault handling on the port, on the CPU.

Holds ``repro_torch.serve`` to the assertions of the reference's serving
tests in ``tests/test_fault_tolerance.py``: one poisoned request among
healthy batch-mates fails alone with a typed error, the executing entry
is quarantined and never serves again, spill-on-evict rehydrates
bit-identically, the per-key circuit breaker walks closed → open →
half-open → closed, and degraded answers carry certified bounds and are
never cached.  Beside them: the ``executor`` fault site, chaos at every
site with only typed outcomes, a failed rehydrate that drops the
half-restored pool and answers cold, and spills that cross the packages
both ways (the reference side selects ``fused``: under jax 0.9 its
``auto`` takes ``bitset`` at these sizes and raises).
"""
import asyncio
import os

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.ft.failures import FaultInjector, FaultPolicy
from repro_torch.graph import csr as csr_mod
from repro_torch.graph import generators, weights
from repro_torch.serve import (CircuitOpenError, ServeConfig, ServeError,
                               SolverFailedError, WarmSolverRegistry,
                               build_service)

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

OPTS = {"batch": 32, "seed": 7, "device": "cpu"}
REF_OPTS = {"batch": 32, "seed": 7, "selection": "fused"}
THETA = 1024
# the degraded test's θ: the reference's 1 << 16 needs 2,048 rounds of the
# plain sampler for its exact answer, a minute on one core; 4,096 rows
# still take ~128 rounds, far past the 0.05 s deadline
DEGRADED_THETA = 1 << 12
TIMEOUT_S = 120.0


def run(coro):
    """Run one test's event loop under a timeout of its own."""
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


@pytest.fixture(scope="module")
def g():
    src, dst = generators.erdos_renyi(60, 300, seed=0)
    return weights.wc_weights(csr_mod.from_edges(src, dst, 60, device="cpu"))


@pytest.fixture(scope="module")
def jg():
    src, dst = jgen.erdos_renyi(60, 300, seed=0)
    return jw.wc_weights(jcsr.from_edges(src, dst, 60))


_COLD: dict = {}


def cold(g, p):
    """A cold solve of ``p`` on a fresh solver (memoised by content)."""
    key = (csr_mod.graph_digest(g), p.signature_digest())
    if key not in _COLD:
        _COLD[key] = IMMSolver(g, **OPTS).solve(p)
    return _COLD[key]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.seeds), np.asarray(b.seeds))
    np.testing.assert_array_equal(np.asarray(a.gains), np.asarray(b.gains))
    assert float(a.frac) == float(b.frac)
    assert float(a.spread) == float(b.spread)
    assert np.float32(a.frac).tobytes() == np.float32(b.frac).tobytes()
    assert np.float32(a.spread).tobytes() == np.float32(b.spread).tobytes()


def _poison_k9():
    """A policy whose injector fails every selection of a k=9 problem —
    the 'poisoned request' of the isolation tests."""
    return FaultPolicy(injector=FaultInjector(
        rate=1.0,
        match=lambda site, ctx: (site == "select" and isinstance(ctx, dict)
                                 and getattr(ctx.get("problem"), "k", None)
                                 == 9)),
        max_retries=0, sleep=lambda s: None)


# ----------------------------------------------------- failure isolation

def test_poisoned_request_fails_alone_batchmates_served(g):
    opts = {**OPTS, "fault_policy": _poison_k9()}

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            max_batch=8, batch_window_s=0.02, solver_opts=opts,
            breaker_threshold=100))
        async with svc:
            return await asyncio.gather(
                svc.submit("g", IMProblem(k=2, theta=THETA)),
                svc.submit("g", IMProblem(k=9, theta=THETA)),
                svc.submit("g", IMProblem(k=3, theta=THETA)),
                return_exceptions=True), svc.stats()
    results, st = run(go())
    ok = [r for r in results if not isinstance(r, BaseException)]
    bad = [r for r in results if isinstance(r, BaseException)]
    assert len(ok) == 2 and len(bad) == 1
    assert isinstance(bad[0], SolverFailedError)
    assert "InjectedFailure" in str(bad[0])
    assert st.served == 2 and st.failed == 1
    assert st.quarantines >= 1 and st.isolated_retries >= 1
    for r, k in zip(ok, (2, 3)):
        _same(cold(g, IMProblem(k=k, theta=THETA)), r.result)


def test_breaker_opens_then_halfopen_probe_heals(g):
    async def go():
        svc = build_service({"g": g}, ServeConfig(
            solver_opts={**OPTS, "fault_policy": _poison_k9()},
            breaker_threshold=2, breaker_cooldown_s=0.2))
        outcomes = []
        async with svc:
            for _ in range(2):
                try:
                    await svc.submit("g", IMProblem(k=9, theta=THETA))
                    outcomes.append("served")
                except Exception as e:
                    outcomes.append(type(e).__name__)
            try:
                await svc.submit("g", IMProblem(k=2, theta=THETA))
                outcomes.append("served")
            except Exception as e:
                outcomes.append(type(e).__name__)
            mid = svc.stats()
            await asyncio.sleep(0.25)
            await svc.submit("g", IMProblem(k=2, theta=THETA))
            outcomes.append("served")
            return outcomes, mid, svc.stats()
    outcomes, mid, end = run(go())
    assert outcomes[0] == "SolverFailedError"
    assert "CircuitOpenError" in outcomes[1:3]
    assert outcomes[-1] == "served"
    assert mid.breakers_open >= 1 and mid.breaker_trips >= 1
    assert end.breakers_open == 0
    assert CircuitOpenError.code == "circuit_open"


def test_executor_fault_quarantines_and_isolated_retries_serve(g):
    pol = FaultPolicy(injector=FaultInjector(fail_at={"executor": {1}}),
                      max_retries=0, sleep=lambda s: None)
    probs = [IMProblem(k=k, theta=THETA) for k in (2, 3, 4)]

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            max_batch=8, batch_window_s=0.02,
            solver_opts={**OPTS, "fault_policy": pol}))
        async with svc:
            # start() hands the registry's coldest-entry eviction to the
            # policy's allocation-failure hooks
            assert svc.registry.evict_coldest in pol.on_oom
            got = await asyncio.gather(*(svc.submit("g", p) for p in probs))
        return got, svc.stats()
    got, st = run(go())
    assert pol.injector.fired_log == [("executor", 1)]
    assert st.served == 3 and st.failed == 0
    assert st.quarantines == 1 and st.isolated_retries == 3
    assert st.breakers_open == 0
    for p, r in zip(probs, got):
        _same(cold(g, p), r.result)


def test_chaos_at_every_site_gives_only_typed_outcomes(g):
    pol = FaultPolicy(injector=FaultInjector(rate=0.1, seed=0),
                      sleep=lambda s: None)
    probs = [IMProblem(k=k, theta=THETA) for k in (1, 2, 3, 5)]

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            max_batch=8, batch_window_s=0.02, breaker_threshold=100,
            solver_opts={**OPTS, "fault_policy": pol}))
        async with svc:
            got = await asyncio.gather(*(svc.submit("g", p) for p in probs),
                                       return_exceptions=True)
        return got, svc.stats()
    got, st = run(go())
    assert pol.injector.fires >= 1
    assert {s for s, _ in pol.injector.fired_log} <= set(
        ("sample", "append", "grow", "select", "executor"))
    for p, r in zip(probs, got):
        if isinstance(r, BaseException):
            assert isinstance(r, ServeError), r
            continue
        assert not r.degraded
        _same(cold(g, p), r.result)
    assert st.served + st.failed == len(probs)


# ------------------------------------------------- spill and rehydrate

def test_spill_on_evict_rehydrate_on_miss_bit_identical(g, tmp_path):
    reg = WarmSolverRegistry(solver_opts=OPTS, spill_dir=str(tmp_path))
    reg.add_graph("g", g)
    p = IMProblem(k=2, theta=THETA)
    e1 = reg.get("g", p)
    e1.solver.solve(p)
    reg.account(e1)
    reg.evict(reg.solver_key("g", p))
    assert reg.snapshot().spills == 1
    e2 = reg.get("g", p)
    assert reg.snapshot().rehydrations == 1 and e2.bytes > 0
    _same(cold(g, IMProblem(k=2, theta=2 * THETA)),
          e2.solver.solve(IMProblem(k=2, theta=2 * THETA)))


def test_quarantine_drops_without_spilling(g, tmp_path):
    reg = WarmSolverRegistry(solver_opts=OPTS, spill_dir=str(tmp_path))
    reg.add_graph("g", g)
    p = IMProblem(k=2, theta=THETA)
    entry = reg.get("g", p)
    entry.solver.solve(p)
    reg.account(entry)
    key = reg.solver_key("g", p)
    freed = reg.quarantine(key)
    assert freed > 0 and key not in reg.entries
    st = reg.snapshot()
    assert st.quarantined == 1 and st.spills == 0
    assert reg.quarantine(key) == 0
    assert not os.listdir(tmp_path)
    fresh = reg.get("g", p)
    assert fresh.solver is not entry.solver
    _same(cold(g, p), fresh.solver.solve(p))


def test_failed_rehydrate_drops_and_answers_cold(g, tmp_path):
    reg = WarmSolverRegistry(solver_opts=OPTS, spill_dir=str(tmp_path))
    reg.add_graph("g", g)
    p = IMProblem(k=3, theta=THETA)
    spill = reg._spill_path(reg.solver_key("g", p))
    os.makedirs(spill)
    (tmp_path / os.path.basename(spill) / "junk").write_text("not a pool")
    entry = reg.get("g", p)
    st = reg.snapshot()
    assert st.rehydrations == 0 and st.rehydrate_failures == 1
    assert entry.bytes == 0 and entry.solver._sig is None
    _same(cold(g, p), entry.solver.solve(p))


def test_degraded_response_never_cached(g):
    p = IMProblem(k=3, theta=DEGRADED_THETA)

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            solver_opts={**OPTS, "sketch_k": 64}))
        async with svc:
            r1 = await svc.submit("g", p, deadline_s=0.05)
            r2 = await svc.submit("g", p)
        return r1, r2, svc.stats()
    r1, r2, st = run(go())
    assert r1.degraded and not r2.degraded and not r2.cached
    assert st.degraded == 1
    lo, hi = r1.result.spread_bounds
    assert lo <= r1.result.spread <= hi
    assert r2.result.spread >= lo


# ------------------------------------------ spills across the two packages

def _spill_reference(jg, p, spill_dir):
    jreg = jserve.WarmSolverRegistry(solver_opts=REF_OPTS,
                                     spill_dir=spill_dir)
    jreg.add_graph("g", jg)
    e = jreg.get("g", p)
    res = e.solver.solve(p)
    jreg.account(e)
    jreg.evict(jreg.solver_key("g", p))
    assert jreg.snapshot().spills == 1
    return res


def test_reference_spill_rehydrates_in_the_port(g, jg, tmp_path):
    kw = dict(k=3, theta=THETA)
    want = _spill_reference(jg, JProblem(**kw), str(tmp_path))
    reg = WarmSolverRegistry(solver_opts=OPTS, spill_dir=str(tmp_path))
    reg.add_graph("g", g)
    p = IMProblem(**kw)
    entry = reg.get("g", p)
    assert reg.snapshot().rehydrations == 1
    assert reg.snapshot().rehydrate_failures == 0
    rounds = entry.solver.stats.rounds
    assert entry.bytes > 0
    got = entry.solver.solve(p)
    assert entry.solver.stats.rounds == rounds       # nothing resampled
    _same(want, got)

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            solver_opts=OPTS, spill_dir=str(tmp_path)))
        async with svc:
            return await svc.submit("g", p), svc.stats()
    served, st = run(go())
    assert st.registry.rehydrations == 1
    _same(want, served.result)


def test_port_spill_rehydrates_in_the_reference(g, jg, tmp_path):
    kw = dict(k=3, theta=THETA)
    reg = WarmSolverRegistry(solver_opts=OPTS, spill_dir=str(tmp_path))
    reg.add_graph("g", g)
    p = IMProblem(**kw)
    e = reg.get("g", p)
    want = e.solver.solve(p)
    reg.account(e)
    reg.evict(reg.solver_key("g", p))
    assert reg.snapshot().spills == 1
    jreg = jserve.WarmSolverRegistry(solver_opts=REF_OPTS,
                                     spill_dir=str(tmp_path))
    jreg.add_graph("g", jg)
    jp = JProblem(**kw)
    entry = jreg.get("g", jp)
    assert jreg.snapshot().rehydrations == 1
    rounds = entry.solver.stats.rounds
    got = entry.solver.solve(jp)
    assert entry.solver.stats.rounds == rounds
    _same(want, got)
