"""The deadline's degraded answer on the port, against the JAX reference
on the CPU.

The same pool reaches both packages through a reference checkpoint, and
``solve_problem(IMProblem(k, theta=θ), deadline_s=0)`` on both gives equal
seeds, gains, ``frac``, ``spread_bounds``, ``degraded`` and stats in each
branch of the reference's ``_degraded_result``:

* the exact store with a sketch: k sweeps of ``union_gains`` and the host
  argmax, the linear count clamped into the bounds (with candidates too);
* the exact store without one: the exact row counts ranked by numpy's
  ``argsort(...)[::-1]``, ties broken as the reference breaks them (with
  candidates too);
* the pool-free store: its sketch greedy and certificate.

Budgeted, weighted (alias roots), row-weighted and MRIM objectives raise
``DeadlineExceeded`` with the reference's messages, and so does a deadline
that expires before the first round.  The sketch branch's seeds spread, by
forward Monte Carlo, inside ``[0.9 lo, 1.1 hi]``.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core.engine import make_engine as jmake_engine
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.ft.failures import DeadlineExceeded as JDeadline
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.core import forward
from repro_torch.core.engine import make_engine
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.ft.failures import DeadlineExceeded
from repro_torch.graph import csr

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N = 400
THETA = 1024
OPTS = {"batch": 64, "seed": 3, "selection": "fused"}
CAND = np.arange(0, N, 3)


@pytest.fixture(scope="module")
def graphs():
    src, dst = jgen.barabasi_albert(N, 3, seed=1)
    jg = jw.wc_weights(jcsr.from_edges(src, dst, N))
    tg = convert.graph_from_arrays(np.asarray(jg.offsets),
                                   np.asarray(jg.indices),
                                   np.asarray(jg.weights), device=CPU)
    return jg, tg


@pytest.fixture(scope="module")
def pools(graphs, tmp_path_factory):
    jg, _ = graphs
    out = {}
    for name, kw in (("sketch", {"sketch_k": 256}), ("plain", {})):
        d = str(tmp_path_factory.mktemp(name))
        js = JSolver(jg, **OPTS, **kw)
        js.prepare(JProblem(k=1))
        js.sample_until(THETA)
        js.save_pool(d)
        out[name] = (d, kw)
    d = str(tmp_path_factory.mktemp("free"))
    js = JSolver(jg, **OPTS, sketch_k=256)
    js.prepare(JProblem(k=1, mode="approximate"))
    js.sample_until(THETA)
    js.save_pool(d)
    out["free"] = (d, {"sketch_k": 256})
    return out


def _both(graphs, pools, name, **pkw):
    jg, tg = graphs
    d, kw = pools[name]
    js, ts = JSolver(jg, **OPTS, **kw), IMMSolver(tg, device=CPU, **OPTS,
                                                  **kw)
    js.restore_pool(d)
    ts.restore_pool(d)
    want = js.solve_problem(JProblem(theta=THETA, **pkw), deadline_s=0)
    got = ts.solve_problem(IMProblem(theta=THETA, **pkw), deadline_s=0)
    return got, want, ts


@pytest.mark.parametrize("name,pkw", [
    ("sketch", {"k": 8}), ("sketch", {"k": 8, "candidates": CAND}),
    ("plain", {"k": 8}), ("plain", {"k": 8, "candidates": CAND}),
    ("free", {"k": 8, "mode": "approximate"}),
    ("free", {"k": 8, "mode": "approximate", "candidates": CAND}),
])
def test_degraded_answer_equals_the_reference(graphs, pools, name, pkw):
    got, want, ts = _both(graphs, pools, name, **pkw)
    assert got.degraded is want.degraded is True
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert got.seeds.dtype == np.asarray(want.seeds).dtype
    np.testing.assert_array_equal(got.gains, want.gains)
    assert got.frac == want.frac and got.spread == want.spread
    assert got.spread_bounds == want.spread_bounds
    assert asdict(got.stats) == asdict(want.stats)
    lo, hi = got.spread_bounds
    assert lo <= got.spread <= hi
    if "candidates" in pkw:
        assert np.isin(got.seeds, CAND).all()
    if name == "sketch" and "candidates" not in pkw:
        mc = forward.ic_spread(ts.g, got.seeds, n_sims=1000, seed=0)
        assert 0.9 * lo <= mc <= 1.1 * hi


def test_objectives_without_a_certified_estimate_raise(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(0)
    w = rng.integers(1, 5, N).astype(np.float32)
    costs = (rng.random(N) + 0.5).astype(np.float32)
    cases = [
        {"theta": 256, "budget": 3.0, "costs": costs},
        {"k": 2, "theta": 256, "node_weights": w},
        {"k": 2, "theta": 256, "t_rounds": 2},
        {"k": 2, "eps": 0.5},                       # before the first round
    ]
    for pkw in cases:
        msgs = []
        for solver, prob, exc in (
                (IMMSolver(tg, device=CPU, **OPTS), IMProblem,
                 DeadlineExceeded),
                (JSolver(jg, **OPTS), JProblem, JDeadline)):
            with pytest.raises(exc) as e:
                solver.solve_problem(prob(**pkw), deadline_s=0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # the row-weighted estimator (an engine instance, weights on rows)
    inst = IMMSolver(tg, engine=make_engine("queue", csr.reverse(tg),
                                            batch=64), device=CPU)
    jinst = JSolver(jg, engine=jmake_engine("queue", jcsr.reverse(jg),
                                            batch=64), selection="fused")
    msgs = []
    for solver, prob, exc in ((inst, IMProblem, DeadlineExceeded),
                              (jinst, JProblem, JDeadline)):
        with pytest.raises(exc, match="certified") as e:
            solver.solve_problem(prob(k=2, theta=128, node_weights=w),
                                 deadline_s=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_a_deadline_that_does_not_expire_changes_nothing(graphs):
    _, tg = graphs
    p = IMProblem(k=4, eps=0.5)
    want = IMMSolver(tg, device=CPU, **OPTS).solve(p)
    got = IMMSolver(tg, device=CPU, **OPTS).solve_problem(p, deadline_s=3600)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert got.frac == want.frac and not got.degraded
    assert asdict(got.stats) == asdict(want.stats)
