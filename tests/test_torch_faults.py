"""The fault policy on the port, against the JAX reference on the CPU.

* ``repro_torch.ft.failures`` is the reference's module: the same sites,
  the same classification (``torch.cuda.OutOfMemoryError`` added, the
  reference's ``XlaRuntimeError`` name test kept), and under the same
  injector the same fired log, counters and backoff sleeps of
  ``FaultPolicy``, driven through one sequence of calls on both; the
  straggler timers give the reference's flags and weights.
* A fault injected at each hot-loop site (``sample``, ``append``,
  ``grow``, ``select``) leaves a solve's result bit-identical to the
  fault-free one, and so does chaos at every site; a ``grow`` fault on a
  wide append takes the reference's fallback to the exact footprint (the
  same capacity as the reference store's), and the ``on_oom`` hooks run.
* ``solve_stacked`` fires ``select`` once a request with the solo ctx and
  once for the batch.
* ``resilient_solve`` restarts from the latest checkpoint and finishes
  equal to the uninterrupted solve.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import coverage as jcov
from repro.ft import failures as jft, straggler as jstrag
from repro_torch.core import coverage as tcov
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.ft import failures as tft, straggler as tstrag
from repro_torch.ft.runner import resilient_solve
from repro_torch.graph import csr, generators, weights

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
OPTS = {"batch": 32, "seed": 7}
THETA = 1024


@pytest.fixture(scope="module")
def g():
    src, dst = generators.erdos_renyi(60, 300, seed=0)
    return weights.wc_weights(csr.from_edges(src, dst, 60, device=CPU))


@pytest.fixture(scope="module")
def clean(g):
    return IMMSolver(g, device=CPU, **OPTS).solve(IMProblem(k=3, theta=THETA))


def _same(a, b):
    np.testing.assert_array_equal(a.seeds, b.seeds)
    np.testing.assert_array_equal(a.gains, b.gains)
    assert a.frac == b.frac and a.spread == b.spread
    assert asdict(a.stats) == asdict(b.stats)


# ------------------------------------------------------------- the module

def test_sites_and_classification_match_the_reference():
    assert tft.SITES == jft.SITES

    class XlaRuntimeError(RuntimeError):
        pass
    for e in (tft.InjectedFailure("x"), tft.PoolAllocError("x"),
              ValueError("x"), tft.DeadlineExceeded("x"),
              XlaRuntimeError("RESOURCE_EXHAUSTED: oom"),
              XlaRuntimeError("INTERNAL: device lost")):
        assert tft.is_transient(e) == jft.is_transient(
            {tft.InjectedFailure: jft.InjectedFailure,
             tft.PoolAllocError: jft.PoolAllocError,
             tft.DeadlineExceeded: jft.DeadlineExceeded}.get(
                type(e), type(e))(str(e)))
    assert tft.is_transient(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    with pytest.raises(ValueError, match="unknown injection site"):
        tft.FaultInjector(fail_at={"bogus": {1}})


def _drive(mod, policy_kw, injector_kw, calls):
    """Run ``calls`` (site, fails-first-n) through a policy of ``mod``;
    returns what both packages must agree on."""
    sleeps, hooks = [], []
    inj = mod.FaultInjector(**injector_kw)
    pol = mod.FaultPolicy(injector=inj, sleep=sleeps.append, **policy_kw)
    pol.on_oom.append(lambda: hooks.append(1) or len(hooks) % 2)
    outcomes = []
    for site, real_failures in calls:
        left = [real_failures]

        def fn():
            if left[0]:
                left[0] -= 1
                raise mod.PoolAllocError("real") if site == "grow" \
                    else ValueError("not transient")
            return site
        try:
            outcomes.append(pol.run(fn, site, {"site": site}))
        except Exception as e:                          # noqa: BLE001
            outcomes.append(type(e).__name__)
    return {"outcomes": outcomes, "sleeps": sleeps, "hooks": len(hooks),
            "retries": pol.retries, "oom": pol.oom_recoveries,
            "gave_up": pol.gave_up, "fires": inj.fires,
            "log": inj.fired_log, "counts": inj.counts}


@pytest.mark.parametrize("policy_kw,injector_kw", [
    ({"max_retries": 3, "backoff_base_s": 0.01, "backoff_cap_s": 0.02},
     {"rate": 1.0}),
    ({}, {"fail_at": {"sample": {2, 3}, "grow": {1}, "select": {4}}}),
    ({"max_retries": 2}, {"rate": 0.4, "seed": 5}),
    ({}, {"rate": {"append": 0.5, "grow": 0.3}, "seed": 2, "max_fires": 6}),
    ({}, {"rate": 0.5, "seed": 1,
          "match": lambda site, ctx: site != "select"}),
])
def test_policy_counters_and_sleeps_equal_the_reference(policy_kw,
                                                        injector_kw):
    calls = [(site, 0) for site in tft.SITES] * 4 + [
        ("grow", 2), ("sample", 1), ("append", 0), ("grow", 1)]
    mine = _drive(tft, policy_kw, injector_kw, calls)
    theirs = _drive(jft, policy_kw, injector_kw, calls)
    assert mine == theirs
    assert mine["fires"] > 0


def test_straggler_timers_equal_the_reference():
    times = [0.01, 0.012, 0.011, 0.05, 0.009, 0.013]
    mine, theirs = tstrag.StepTimer(window=4), jstrag.StepTimer(window=4)
    for dt in times:
        assert mine.is_straggler(dt) == theirs.is_straggler(dt)
        mine.times.append(dt)
        theirs.times.append(dt)
        assert mine.median == theirs.median
    a, b = tstrag.ShardMonitor(3), jstrag.ShardMonitor(3)
    for s, dt in [(0, 1.0), (1, 1.1), (2, 5.0), (0, 0.9), (2, 4.0)]:
        a.report(s, dt)
        b.report(s, dt)
    assert a.stragglers() == b.stragglers() == [2]
    np.testing.assert_array_equal(a.work_weights(), b.work_weights())


# ------------------------------------------------------- the solve loop

@pytest.mark.parametrize("site,fail_at", [
    ("sample", {2, 5}), ("append", {1, 4}), ("select", {1}),
    ("grow", {1})])
def test_injected_fault_at_each_site_is_bit_identical(g, clean, site,
                                                      fail_at):
    theta = 2048 if site == "grow" else THETA      # grow: past 4,096 slots
    want = clean if site != "grow" else IMMSolver(
        g, device=CPU, **OPTS).solve(IMProblem(k=3, theta=theta))
    pol = tft.FaultPolicy(injector=tft.FaultInjector(
        fail_at={site: fail_at}), sleep=lambda s: None)
    got = IMMSolver(g, device=CPU, fault_policy=pol, **OPTS).solve(
        IMProblem(k=3, theta=theta))
    _same(want, got)
    assert pol.injector.fires == len(fail_at) == pol.retries
    assert pol.gave_up == 0


def test_chaos_at_every_site_is_bit_identical(g):
    p = IMProblem(k=3, theta=2048)
    want = IMMSolver(g, device=CPU, **OPTS).solve(p)
    sleeps = []
    pol = tft.FaultPolicy(injector=tft.FaultInjector(rate=0.2, seed=0),
                          sleep=sleeps.append)
    got = IMMSolver(g, device=CPU, fault_policy=pol, **OPTS).solve(p)
    _same(want, got)
    assert pol.retries == pol.injector.fires == len(sleeps) > 0
    assert {s for s, _ in pol.injector.fired_log} >= {"sample", "append"}


def test_grow_fault_takes_the_exact_footprint():
    """A wide append (R*W > 2^15, at most 2^15 elements) reserves 2^15
    elements of headroom; a refused growth retries at the exact footprint
    inside the store, as the reference's does, and a second refusal goes
    up to the policy, whose on_oom hooks run before the retry."""
    rng = np.random.default_rng(4)
    n = 500
    small = np.stack([rng.permutation(n)[:8] for _ in range(500)])
    wide = np.full((700, 64), n, np.int64)
    lens = rng.integers(0, 5, 700)
    for i, ln in enumerate(lens):
        wide[i, :ln] = rng.permutation(n)[:ln]
    caps = {}
    for name, store in (("port", tcov.DeviceRRStore(n, device=CPU)),
                        ("ref", jcov.ShardedDeviceRRStore(n))):
        store.append_batch((small, np.full(500, 8)))
        refused = []

        def gate(st, newcap, refused=refused):
            if not refused:
                refused.append(newcap)
                raise (tft if name == "port" else jft).PoolAllocError("oom")
        store.alloc_check = gate
        store.append_batch((wide, lens))
        caps[name] = (store.capacity, refused[0], store.n_elems)
    assert caps["port"] == caps["ref"]
    cap, first, elems = caps["port"]
    assert first >= 4000 + (1 << 15) and cap < first and cap >= elems

    # through the solver: the injected grow faults escalate to the policy
    src, dst = generators.erdos_renyi(60, 300, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 60, device=CPU))
    p = IMProblem(k=3, theta=2048)
    want = IMMSolver(g, batch=256, seed=7, device=CPU).solve(p)
    freed = []
    pol = tft.FaultPolicy(injector=tft.FaultInjector(fail_at={"grow": {1, 2}}),
                          sleep=lambda s: None)
    pol.on_oom.append(lambda: freed.append(1) or 1)
    got = IMMSolver(g, batch=256, seed=7, fault_policy=pol,
                    device=CPU).solve(p)
    _same(want, got)
    assert pol.injector.fires == 2 and freed and pol.oom_recoveries >= 1
    assert pol.injector.counts["grow"] >= 3


def test_stacked_select_site_fires_per_request_then_batch(g):
    probs = [IMProblem(k=2, theta=THETA), IMProblem(k=3, theta=THETA),
             IMProblem(k=4, theta=THETA)]
    want = IMMSolver(g, device=CPU, **OPTS).solve_stacked(probs)
    seen = []
    inj = tft.FaultInjector(
        fail_at={"select": {2, 4}},
        match=lambda site, ctx: seen.append(ctx) or True)
    pol = tft.FaultPolicy(injector=inj, sleep=lambda s: None)
    got = IMMSolver(g, device=CPU, fault_policy=pol, **OPTS).solve_stacked(
        probs)
    for a, b in zip(want, got):
        _same(a, b)
    sel = [c for c in seen if c and ("stacked" in c or "stacked_batch" in c)]
    # crossings 2 and 4 fail and are retried: k=3 and k=4 check twice
    assert [c.get("k") for c in sel if c.get("stacked")] == [2, 3, 3, 4, 4]
    assert sel[-1] == {"stacked_batch": 3}
    assert inj.fires == 2 and pol.retries == 2


def test_resilient_solve_restarts_from_the_checkpoint(g, tmp_path):
    p = IMProblem(k=3, eps=0.4, max_theta=2048)
    want = IMMSolver(g, device=CPU, **OPTS).solve(p)
    d = str(tmp_path / "ck")
    inj = tft.FaultInjector(fail_at={"sample": {6}, "select": {2}})

    def make_solver():
        pol = tft.FaultPolicy(injector=inj, max_retries=0,
                              sleep=lambda s: None)
        return IMMSolver(g, device=CPU, fault_policy=pol, checkpoint_dir=d,
                         checkpoint_every=1, **OPTS)
    got, report = resilient_solve(make_solver, p, d, max_restarts=4)
    _same(want, got)
    assert report.completed and report.restarts >= 1
    assert report.resumed_steps[0] is None
    assert all(s is not None for s in report.resumed_steps[1:])
    with pytest.raises(ValueError):
        resilient_solve(lambda: (_ for _ in ()).throw(ValueError("x")), p, d)
