"""The torch port's IMM solve against the JAX reference.

Deterministic parts are exact: the θ maths gives equal floats, a fixed-θ
problem gives equal θ, and the port's ``bitset`` solve equals its ``fused``
solve (same pool, same seeds, gains and frac).  The two packages sample
with different generators, so seed quality is held statistically: the
forward Monte-Carlo spread of the port's seeds must reach the reference's
seeds' spread minus 5 sigma of the difference of the two MC means.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import oracle as joracle
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core import forward, oracle as toracle
from repro_torch.core.imm import IMMSolver, imm
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr as tcsr, weights as tw

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
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        imm(tg, k=4, node_weights=np.ones(600), device=CPU)


@pytest.mark.parametrize("field,value,item", [
    ("node_weights", np.ones(3), "item 7"), ("budget", 2.0, "item 7"),
    ("candidates", [0], "item 7"), ("t_rounds", 2, "item 7"),
    ("model", "lt", "item 7"), ("early_exit", True, "item 8"),
    ("mode", "approximate", "item 8")])
def test_variant_fields_not_ported(field, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        IMProblem(k=1, **{field: value})


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
    with pytest.raises(ValueError, match="selection"):
        IMMSolver(tg, selection="celf", device=CPU)
