"""The torch port's IMM solve against the JAX reference.

Deterministic parts are exact: the θ maths gives equal floats, a fixed-θ
problem gives equal θ, and the port's ``bitset`` solve equals its ``fused``
solve (same pool, same seeds, gains and frac).  The two packages sample
with different generators, so seed quality is held statistically: the
forward Monte-Carlo spread of the port's seeds must reach the reference's
seeds' spread minus 5 sigma of the difference of the two MC means.

The approximate (pool-free) mode is held as the reference's own suite holds
it (``tests/test_approximate_mode.py``): in the exact regime (θ <= sketch_k)
it equals the port's fused solve seed for seed, with lo == spread == hi
(relative 1e-6); in the estimate regime its certified bounds bracket the
spread, and the forward-MC spread of its seeds clears
``(1 - 1/e - eps - eps_cert) * best * 0.9`` and lies in
``[0.7 lo, 1.3 hi]``.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import oracle as joracle
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core import coverage as tcov, forward, oracle as toracle
from repro_torch.core.imm import IMMSolver, imm
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr as tcsr, weights as tw

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
SIGMA = 5.0


@pytest.fixture(scope="module")
def graphs():
    src, dst = jgen.barabasi_albert(600, 3, seed=1)
    tg = tw.wc_weights(tcsr.from_edges(src, dst, 600, device=CPU))
    jg = jw.wc_weights(jcsr.from_edges(src, dst, 600))
    return tg, jg


@pytest.mark.parametrize("n,k,eps,ell", [(600, 10, 0.3, 1.0),
                                         (75879, 50, 0.5, 1.0),
                                         (10 ** 6, 1, 0.1, 2.0)])
def test_theta_maths_equal(n, k, eps, ell):
    assert toracle.log_cnk(n, k) == joracle.log_cnk(n, k)
    assert toracle.imm_theta_params(n, k, eps, ell) == \
        joracle.imm_theta_params(n, k, eps, ell)


def _mc_gap_ok(g, port_seeds, ref_seeds, sims=1024):
    a = forward.ic_sizes(g, port_seeds, sims, seed=3).double()
    b = forward.ic_sizes(g, ref_seeds, sims, seed=4).double()
    se = math.sqrt(float(a.var()) / sims + float(b.var()) / sims)
    gap = float(b.mean() - a.mean())
    assert gap <= SIGMA * se, (float(a.mean()), float(b.mean()), se)


def test_fixed_theta_solve_against_reference(graphs):
    tg, jg = graphs
    prob = dict(k=8, eps=0.3, theta=3000)
    tres = IMMSolver(tg, batch=256, selection="fused", seed=0,
                     device=CPU).solve(IMProblem(**prob))
    jres = JSolver(jg, batch=256, selection="fused", seed=0).solve(
        JProblem(**prob))
    assert tres.stats.theta == jres.stats.theta == 3000
    assert tres.stats.n_rr_sampled >= 3000
    assert tres.stats.lb == jres.stats.lb == 1.0
    assert len(tres.seeds) == len(set(tres.seeds.tolist())) == 8
    _mc_gap_ok(tg, tres.seeds, np.asarray(jres.seeds))


def test_eps_solve_against_reference_and_forward_mc(graphs):
    tg, jg = graphs
    tres = IMMSolver(tg, batch=256, selection="fused", seed=1,
                     device=CPU).solve(IMProblem(k=5, eps=0.4))
    jres = JSolver(jg, batch=256, selection="fused", seed=1).solve(
        JProblem(k=5, eps=0.4))
    st = tres.stats
    assert st.lb_iters >= 1 and st.rounds >= 1 and st.sampling_steps > 0
    assert st.theta == math.ceil(toracle.imm_theta_params(600, 5, 0.4)[1]
                                 / st.lb)
    assert st.n_rr_sampled >= st.theta
    assert st.overflow_fraction == 0.0
    _mc_gap_ok(tg, tres.seeds, np.asarray(jres.seeds))
    # Eq. 3: the RIS estimate agrees with forward MC within 10%, the
    # tolerance of the reference's examples/im_endtoend.py check
    mc = forward.ic_spread(tg, tres.seeds, n_sims=1024, seed=5)
    assert abs(tres.spread - mc) / mc < 0.10, (tres.spread, mc)


def test_bitset_solve_equals_fused_solve(graphs):
    tg, _ = graphs
    res = {sel: IMMSolver(tg, batch=128, selection=sel, seed=2,
                          device=CPU).solve(IMProblem(k=6, eps=0.5))
           for sel in ("fused", "bitset", "auto")}
    for sel in ("bitset", "auto"):
        np.testing.assert_array_equal(res[sel].seeds, res["fused"].seeds)
        np.testing.assert_array_equal(res[sel].gains, res["fused"].gains)
        assert res[sel].frac == res["fused"].frac
        assert res[sel].stats.theta == res["fused"].stats.theta


def test_imm_wrapper_and_determinism(graphs):
    tg, _ = graphs
    s1, sp1, st1 = imm(tg, k=4, eps=0.5, batch=128, seed=9, device=CPU)
    s2, sp2, _ = imm(tg, k=4, eps=0.5, batch=128, seed=9, device=CPU)
    np.testing.assert_array_equal(s1, s2)
    assert sp1 == sp2 and st1.selection == "auto"
    with pytest.raises(TypeError, match="sketchk"):
        imm(tg, k=4, sketchk=64, device=CPU)
    # the variants are ported (tests/test_torch_variants.py), MRIM too
    # (tests/test_torch_mrim.py): k seeds a round on the tagged items
    seeds, spread, st = imm(tg, k=4, t_rounds=2, theta=256, batch=128,
                            device=CPU)
    assert st.variant == "mrim" and len(seeds) == 8
    assert sorted((np.asarray(seeds) // tg.n_nodes).tolist()) == [0] * 4 + \
        [1] * 4


@pytest.mark.parametrize("field,value,item", [
    ("node_weights", np.ones(3), "item 7"), ("budget", 2.0, "item 7"),
    ("candidates", [0], "item 7"), ("t_rounds", 2, "item 7"),
    ("model", "lt", "item 7"), ("early_exit", True, "item 8"),
    ("mode", "approximate", "item 8")])
def test_variant_fields_not_ported(field, value, item):
    if field == "mode":
        # ported by Queue 1 item 8: accepted; an unknown mode raises
        assert IMProblem(k=1, **{field: value}).mode == value
        with pytest.raises(ValueError, match="unknown mode"):
            IMProblem(k=1, mode="bogus")
        return
    if field == "early_exit":
        # ported by Queue 1 item 8: accepted in either mode
        for mode in ("exact", "approximate"):
            assert IMProblem(k=1, early_exit=value, mode=mode).early_exit
        return
    if field in ("node_weights", "candidates", "model", "t_rounds"):
        # ported by Queue 1 item 7 (the lt and mrim engines too): accepted
        assert getattr(IMProblem(k=1, **{field: value}), field) is value
        return
    if field == "budget":
        # ported by Queue 1 item 7: it replaces k, as in the reference
        assert IMProblem(budget=value).budget == value
        with pytest.raises(ValueError, match="exactly one"):
            IMProblem(k=1, budget=value)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        IMProblem(k=1, **{field: value})


def test_candidates_with_approximate_mode_not_ported():
    """The reference's approximate mode accepts candidates, and so does the
    port's now (Queue 1 item 7); weights and a budget it refuses, as the
    reference does."""
    p = IMProblem(k=2, mode="approximate", candidates=[0, 1])
    assert p.variant == "candidates"
    with pytest.raises(ValueError, match="approximate"):
        IMProblem(k=2, mode="approximate", node_weights=[1.0, 1.0])


def test_problem_validation():
    with pytest.raises(ValueError):
        IMProblem()
    with pytest.raises(ValueError):
        IMProblem(k=0)
    with pytest.raises(ValueError):
        IMProblem(k=1, eps=1.5)
    with pytest.raises(ValueError):
        IMProblem(k=1, model="sir")


def test_solver_defaults_to_the_card(graphs):
    tg, _ = graphs
    if torch.cuda.is_available():
        assert IMMSolver(tg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            IMMSolver(tg)
    for sel in ("celf", "celf-sketch"):
        solver = IMMSolver(tg, selection=sel, eval_batch=4, device=CPU)
        assert solver.store.sketch_k == tcov.DeviceRRStore.DEFAULT_SKETCH_K
        assert solver.eval_batch == 4
    with pytest.raises(ValueError, match="selection"):
        IMMSolver(tg, selection="celf-fast", device=CPU)
    with pytest.raises(ValueError, match="eval_batch"):
        IMMSolver(tg, selection="celf", eval_batch=0, device=CPU)


# ------------------------------------------------------- approximate mode

def _er_graphs(n=60, m=300, seed=6):
    """The reference suite's graph (tests/test_approximate_mode.py)."""
    src, dst = jgen.erdos_renyi(n, m, seed=seed)
    return (tw.wc_weights(tcsr.from_edges(src, dst, n, device=CPU)),
            jw.wc_weights(jcsr.from_edges(src, dst, n)))


@pytest.fixture(scope="module")
def er_graphs():
    return _er_graphs()


def test_approximate_exact_regime_equals_fused(er_graphs):
    """θ <= sketch_k under "mod": the approximate solve walks the fused
    solve's round-seed stream and its selection is injective, so seeds,
    gains and spread are the fused solve's."""
    tg, _ = er_graphs
    fused = IMMSolver(tg, batch=64, seed=3, selection="fused",
                      device=CPU).solve(IMProblem(k=4, theta=192))
    solver = IMMSolver(tg, batch=64, seed=3, sketch_k=256, device=CPU)
    res = solver.solve(IMProblem(k=4, theta=192, mode="approximate"))
    np.testing.assert_array_equal(res.seeds, fused.seeds)
    np.testing.assert_array_equal(res.gains, fused.gains)
    assert res.spread == pytest.approx(fused.spread, rel=1e-6)
    lo, hi = res.spread_bounds
    assert lo == pytest.approx(res.spread, rel=1e-6)
    assert hi == pytest.approx(res.spread, rel=1e-6)
    assert fused.spread_bounds is None
    assert isinstance(solver.store, tcov.SketchRRStore)
    assert solver.store.per_device_pool_bytes() == 0
    assert solver.engine.name == "fused-sketch[queue]"
    assert solver._sketch_info["exact_regime"]


def test_approximate_estimate_regime_quality(er_graphs):
    """n_rr > sketch_k, unsaturated: bounds bracket the spread and the MC
    spread of the seeds clears the certified approximation bound."""
    tg, jg = er_graphs
    n, k, eps = tg.n_nodes, 4, 0.3
    solver = IMMSolver(tg, batch=64, seed=3, sketch_k=1024, device=CPU)
    res = solver.solve(IMProblem(k=k, eps=eps, max_theta=4096,
                                 mode="approximate"))
    info = solver._sketch_info
    assert solver.store.n_rr > 1024 and not info["exact_regime"]
    assert not info["saturated"]
    lo, hi = res.spread_bounds
    assert lo <= res.spread <= hi
    got = forward.ic_spread(tg, res.seeds, n_sims=2048, seed=7)
    rev = jcsr.reverse(jg)
    o_seeds, _, _ = joracle.imm_oracle(
        np.asarray(rev.offsets), np.asarray(rev.indices),
        np.asarray(rev.weights), n, k, eps, seed=11, max_theta=4096)
    best = forward.ic_spread(tg, list(o_seeds), n_sims=2048, seed=8)
    eps_cert = (res.spread - lo) / max(res.spread, 1e-9)
    bound = (1.0 - 1.0 / np.e - eps - eps_cert) * best
    assert got >= bound * 0.9, (got, bound, best, eps_cert)
    assert lo * 0.7 <= got <= hi * 1.3, (lo, got, hi)


def test_approximate_against_reference_solve(er_graphs):
    """Same problem in both packages (different RR sets): the port's
    seeds are as good under MC as the reference's, and its spread lies in
    the reference's certified bracket with the reference suite's slack."""
    tg, jg = er_graphs
    prob = dict(k=4, eps=0.3, max_theta=4096, mode="approximate")
    tres = IMMSolver(tg, batch=64, seed=5, sketch_k=1024,
                     device=CPU).solve(IMProblem(**prob))
    jres = JSolver(jg, engine="queue", batch=64, seed=5,
                   sketch_k=1024).solve(JProblem(**prob))
    _mc_gap_ok(tg, tres.seeds, np.asarray(jres.seeds))
    jlo, jhi = jres.spread_bounds
    assert jlo * 0.7 <= tres.spread <= jhi * 1.3, (jlo, tres.spread, jhi)


def test_store_follows_the_problem_mode(er_graphs):
    """A solve whose (mode, sketch_k) differs from the current store's
    starts a fresh store and stats on the same round-seed stream."""
    tg, _ = er_graphs
    solver = IMMSolver(tg, batch=64, seed=4, sketch_k=256, device=CPU)
    exact = solver.solve(IMProblem(k=3, theta=128))
    assert isinstance(solver.store, tcov.DeviceRRStore)
    approx = solver.solve(IMProblem(k=3, theta=128, mode="approximate"))
    assert isinstance(solver.store, tcov.SketchRRStore)
    assert approx.stats.rounds == exact.stats.rounds == 2
    np.testing.assert_array_equal(approx.seeds, exact.seeds)
    again = solver.solve(IMProblem(k=3, theta=128))
    assert isinstance(solver.store, tcov.DeviceRRStore)
    np.testing.assert_array_equal(again.seeds, exact.seeds)
    assert again.spread == exact.spread and again.spread_bounds is None
    # the auto sketch size: eps=0.5 on 60 nodes -> max(64, min(104, 60))
    solver2 = IMMSolver(tg, batch=64, seed=4, device=CPU)
    solver2.prepare(IMProblem(k=3, eps=0.5, mode="approximate"))
    assert solver2.store.sketch_k == 64


def test_imm_wrapper_approximate(er_graphs):
    tg, _ = er_graphs
    seeds, spread, stats = imm(tg, k=3, theta=192, mode="approximate",
                               sketch_k=256, batch=64, seed=3, device=CPU)
    s2, sp2, _ = imm(tg, k=3, theta=192, batch=64, seed=3,
                     selection="fused", device=CPU)
    np.testing.assert_array_equal(seeds, s2)
    assert spread == pytest.approx(sp2, rel=1e-6) and stats.theta == 192
