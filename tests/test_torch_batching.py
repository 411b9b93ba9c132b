"""The stacked solve and the serving batch executor on the port, on the CPU.

Mirrors the reference's ``tests/test_serve_net.py`` stacked tests: a
stacked solve (``IMMSolver.solve_stacked``, one ``greedy_stacked`` call)
and ``execute_batch`` give the solo solves' results in every ``IMResult``
field, MRIM problems stack through their group quotas, and the refusals
(mixed or missing θ, approximate mode, a second pool signature, the
row-weighted estimator) carry the reference's messages.  A deadline is
passed to ``solve_problem``, whose degraded answer equals the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core.engine import make_engine
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.ft.failures import DeadlineExceeded
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ops
from repro_torch.serve import (execute_batch, occur_fastpath_eligible,
                               stacked_eligible)
import torch

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
THETA = 256


def ba(n=220, r=4, seed=0):
    src, dst = generators.barabasi_albert(n, r, seed=seed)
    return weights.wc_weights(csr.from_edges(src, dst, n, device=CPU))


def _mixed_problems(n, theta):
    cand = np.zeros(n, bool)
    cand[: n // 4] = True
    costs = (np.abs(np.random.default_rng(3).normal(1.0, 0.3, n))
             + 0.1).astype(np.float32)
    return [
        IMProblem(k=2, theta=theta),
        IMProblem(k=5, theta=theta),
        IMProblem(k=3, theta=theta, candidates=np.flatnonzero(cand)),
        IMProblem(k=None, budget=2.5, costs=costs, theta=theta),
        IMProblem(k=4, theta=theta),
    ]


def _assert_result_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.seeds), np.asarray(b.seeds))
    np.testing.assert_array_equal(np.asarray(a.gains), np.asarray(b.gains))
    assert np.asarray(a.seeds).dtype == np.asarray(b.seeds).dtype
    assert a.frac == b.frac and a.spread == b.spread and a.cost == b.cost
    assert a.problem is b.problem and a.n_nodes == b.n_nodes
    assert a.spread_bounds == b.spread_bounds


@pytest.fixture(scope="module")
def solo():
    """The solo solves of the mixed problems, of the MRIM pair, and of the
    mixed problems with a top-1 rider, on a solver each."""
    g = ba()
    probs = _mixed_problems(g.n_nodes, THETA)
    mrim = [IMProblem(k=2, theta=THETA, t_rounds=2),
            IMProblem(k=1, theta=THETA, t_rounds=2)]
    out = {"g": g, "probs": probs, "mrim": mrim}
    s = IMMSolver(g, batch=64, seed=0, device=CPU)
    out["mixed"] = [s.solve_problem(p) for p in probs]
    out["rider"] = s.solve_problem(IMProblem(k=1, theta=THETA))
    s = IMMSolver(g, batch=64, seed=0, device=CPU)
    out["mrim_res"] = [s.solve_problem(p) for p in mrim]
    return out


def test_stacked_matches_solo(solo):
    stk = IMMSolver(solo["g"], batch=64, seed=0, device=CPU)
    got = stk.solve_stacked(solo["probs"])
    for a, b in zip(solo["mixed"], got):
        _assert_result_equal(a, b)
    st = stk.stats
    assert (st.theta, st.lb, st.variant) == (THETA, 1.0, "plain")
    assert st.budget_spent == got[-1].cost == 0.0
    assert st.n_rr_sampled >= THETA
    assert stk.solve_stacked([]) == []


def test_stacked_mrim_and_guards(solo):
    g = solo["g"]
    stk = IMMSolver(g, batch=64, seed=0, device=CPU)
    for a, b in zip(solo["mrim_res"], stk.solve_stacked(solo["mrim"])):
        _assert_result_equal(a, b)
    assert len(solo["mrim_res"][0].seeds) == 4
    for bad in ([IMProblem(k=1, theta=128), IMProblem(k=1, theta=256)],
                [IMProblem(k=1), IMProblem(k=2)],
                [IMProblem(k=1, theta=128, mode="approximate"),
                 IMProblem(k=2, theta=128, mode="approximate")]):
        with pytest.raises(ValueError):
            stk.solve_stacked(bad)


def test_execute_batch_stacked_parity_and_counters(solo):
    g = solo["g"]
    probs = solo["probs"] + [IMProblem(k=1, theta=THETA)]   # fastpath rider
    stats: dict = {}
    ops.reset_launch_counts()
    res_stacked = execute_batch(IMMSolver(g, batch=64, seed=0, device=CPU),
                                probs, stacked=True, stats_out=stats)
    res_solo = execute_batch(IMMSolver(g, batch=64, seed=0, device=CPU),
                             probs, stacked=False)
    assert ops.launch_counts()["greedy_stacked"] == 0        # the CPU route
    for a, b in zip(res_solo, res_stacked):
        _assert_result_equal(a, b)
    for a, b in zip(solo["mixed"], res_stacked):
        _assert_result_equal(a, b)
    rider = res_stacked[-1]
    want = solo["rider"]
    np.testing.assert_array_equal(rider.seeds, want.seeds)
    np.testing.assert_array_equal(rider.gains, want.gains)
    assert (rider.frac, rider.spread, rider.cost) == \
        (want.frac, want.spread, want.cost)
    assert stats["stacked_batches"] == 1
    assert stats["stacked_requests"] == len(probs) - 1  # k=1 went fastpath
    assert execute_batch(IMMSolver(g, batch=64, seed=0, device=CPU), []) == []


def test_execute_batch_routes(solo, tmp_path):
    """A lone stackable request runs solo; two θs stack a θ at a time; a
    request's deadline goes to solve_problem: one that does not expire
    gives the solo result, an expired one the degraded answer, equal to
    the reference's on the same pool (saved by the port, restored by the
    reference), and a budgeted one raises as the reference's; the
    eligibility predicates follow the reference's."""
    g = solo["g"]
    s = IMMSolver(g, batch=64, seed=0, device=CPU)
    stats: dict = {}
    one = execute_batch(s, [solo["probs"][1]], stats_out=stats)
    _assert_result_equal(one[0], solo["mixed"][1])
    assert stats == {}
    late = execute_batch(s, [solo["probs"][1], IMProblem(k=2, theta=THETA)],
                         deadlines=[3600.0, 0.0], stats_out=stats)
    _assert_result_equal(late[0], solo["mixed"][1])
    assert not late[0].degraded and late[1].degraded and stats == {}
    s.save_pool(str(tmp_path))
    js = JSolver(jcsr.CSRGraph(*(jnp.asarray(a) for a in g.numpy())),
                 batch=64, seed=0, selection="fused")
    js.restore_pool(str(tmp_path))
    want = js.solve_problem(JProblem(k=2, theta=THETA), deadline_s=0.0)
    np.testing.assert_array_equal(late[1].seeds, want.seeds)
    np.testing.assert_array_equal(late[1].gains, want.gains)
    assert (late[1].frac, late[1].spread, late[1].spread_bounds) == \
        (want.frac, want.spread, want.spread_bounds)
    costs = np.ones(g.n_nodes, np.float32)
    with pytest.raises(DeadlineExceeded, match="budgeted"):
        execute_batch(s, [IMProblem(theta=THETA, budget=2.0, costs=costs)],
                      deadlines=[0.0])
    for p in (IMProblem(k=1, theta=8), IMProblem(k=2, theta=8),
              IMProblem(k=1), IMProblem(theta=8, budget=2.0),
              IMProblem(k=1, theta=8, t_rounds=2),
              IMProblem(k=1, theta=8, mode="approximate")):
        jp = JProblem(**{f: getattr(p, f) for f in
                         ("k", "theta", "budget", "t_rounds", "mode")})
        assert occur_fastpath_eligible(s, p) == (
            jp.theta is not None and jp.k == 1 and jp.t_rounds is None
            and jp.budget is None and jp.mode != "approximate")
        assert stacked_eligible(s, p) == (
            jp.theta is not None and jp.mode != "approximate")


def test_stacked_refusals_match_reference():
    """The messages of the reference's solve_stacked, word for word: mixed
    θ, an LB-loop problem, approximate mode and a second pool signature
    (on both packages), and the row-weighted estimator."""
    n = 60
    src, dst = jgen.barabasi_albert(n, 3, seed=1)
    jg = jw.wc_weights(jcsr.from_edges(src, dst, n))
    g = weights.wc_weights(csr.from_edges(src, dst, n, device=CPU))
    w = np.arange(1, n + 1, dtype=np.float32)
    cases = [
        [dict(k=1, theta=64), dict(k=1, theta=128)],
        [dict(k=1), dict(k=2)],
        [dict(k=1, theta=64, mode="approximate"),
         dict(k=2, theta=64, mode="approximate")],
        [dict(k=1, theta=64), dict(k=1, theta=64, node_weights=w)],
    ]
    for case in cases:
        msgs = []
        for solver, prob in ((JSolver(jg, batch=64, seed=0), JProblem),
                             (IMMSolver(g, batch=64, seed=0, device=CPU),
                              IMProblem)):
            with pytest.raises(ValueError) as err:
                solver.solve_stacked([prob(**kw) for kw in case])
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], case
    eng = make_engine("queue", csr.reverse(g), batch=64)
    weighted = IMMSolver(g, engine=eng, seed=0, device=CPU)
    with pytest.raises(ValueError, match="^solve_stacked does not support "
                                         "the row-weighted fallback "
                                         "estimator$"):
        weighted.solve_stacked([IMProblem(k=1, theta=64, node_weights=w),
                                IMProblem(k=2, theta=64, node_weights=w)])
