"""The port's LT model (``core/lt.py``, the ``lt`` engine, ``lt_walk``)
against the JAX reference on the CPU.

* ``row_cumweights`` equals the reference's byte for byte.
* The LT round (``ops.lt_walk`` on the CPU, ``ref.lt_round_ref``) equals a
  numpy replay of its counter draws byte for byte: row seeds, roots
  (uniform and through an alias table), each walk (a draw a step, the
  first edge whose cumulative weight passes it, a stop on a revisit, the
  row's total or an empty row), the zeros after it, the overflow at qcap
  and each lane's draws.
* The port draws from the counter hash and the reference from numpy's
  generator, so walks are held by distribution: a two-sample KS test on
  walk sizes (p > 0.01, 320 of each) and a 5-sigma two-sample bound on
  every node's hit frequency, against the reference's oracle
  ``rr_set_lt``, as ``tests/test_conformance.py`` holds the reference.
* An LT solve's RIS estimate lies within 10% of the port's forward LT
  Monte Carlo (``forward.lt_spread``); a problem's ``model`` overrides
  the solver's; LT solves with ``flat``, ``bitset`` and ``celf`` agree in
  every field, and the approximate mode runs on LT walks.
"""
import numpy as np
import pytest
import torch
from scipy import stats as sps

from repro.core import lt as jlt, oracle as joracle
from repro.graph import csr as jcsr, generators as jgen
from repro_torch.core import forward, lt, oracle, roots
from repro_torch.core.engine import make_engine, resolve_engine_name
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.core.rrset import round_seed
from repro_torch.graph import csr as tcsr
from repro_torch.kernels import ops, ref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
P_MIN = 0.01        # KS acceptance, as test_conformance.py
SIGMA = 5.0         # two-sample bound, as test_conformance.py
N_SIZES = 320
MC_TOL = 0.10
M32 = 0xFFFFFFFF


def _bits(x):
    return np.asarray(x).tobytes()


def _scaled_wc(src, dst, n, scale):
    """Edge weights ``scale / indeg(dst)``: every in-row sums to ``scale``
    (WC at 1, a stopping walk below it)."""
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    return (scale / indeg[dst]).astype(np.float32)


def _graphs(kind):
    """(port forward graph, reference forward graph) of one topology."""
    if kind == "er":
        (src, dst), n, scale = jgen.erdos_renyi(40, 160, seed=2), 40, 0.9
    elif kind == "ba":
        (src, dst), n, scale = jgen.barabasi_albert(60, 3, seed=7), 60, 0.8
    else:                                        # WC: walks end on revisits
        (src, dst), n, scale = jgen.barabasi_albert(60, 2, seed=4), 60, 1.0
    w = _scaled_wc(src, dst, n, scale)
    return (tcsr.from_edges(src, dst, n, weights=w, device=CPU),
            jcsr.from_edges(src, dst, n, weights=w))


# ------------------------------------------------------- rows and rounds

@pytest.mark.parametrize("kind", ["er", "ba", "wc"])
def test_row_cumweights_equal_reference(kind):
    tg, jg = _graphs(kind)
    for a, b in ((tg, jg), (tcsr.reverse(tg), jcsr.reverse(jg))):
        mine, theirs = lt.row_cumweights(a), np.asarray(jlt.row_cumweights(b))
        assert mine.dtype == torch.float32 and theirs.dtype == np.float32
        assert _bits(mine.numpy()) == _bits(theirs)


def _fmix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _hash(seed, e):
    """The counter hash in numpy uint64: fmix32(fmix32(e * golden + seed)
    ^ golden)."""
    seed = np.asarray(seed, np.uint64) & M32
    e = np.asarray(e, np.uint64) & M32
    return _fmix32(_fmix32((e * 0x9E3779B9 + seed) & M32) ^ 0x9E3779B9)


def _u01(h):
    return np.float32(h) * np.float32(2.0 ** -32)


def _replay(g_rev, seed32, batch, qcap, table=None):
    """The LT round drawn lane by lane in numpy."""
    offs, idx, _ = g_rev.numpy()
    rowcum = lt.row_cumweights(g_rev).numpy()
    n = offs.size - 1
    walks = np.zeros((batch, qcap), np.int32)
    lens, ovf = np.zeros(batch, np.int32), np.zeros(batch, bool)
    steps, roots_ = np.zeros(batch, np.int64), np.zeros(batch, np.int32)
    for b in range(batch):
        s = int(_hash(seed32, b))
        root = (int(_hash(s, 0xFFFFFFFF)) * n) >> 32
        if table is not None:
            prob, alias = (t.numpy() for t in table)
            if not _u01(_hash(s, 0xFFFFFFFE)) < prob[root]:
                root = int(alias[root])
        walk, cur, t = [root], root, 0
        while True:
            u = _u01(_hash(s, t))
            t += 1
            lo, hi = offs[cur], offs[cur + 1]
            if hi == lo or u >= rowcum[hi - 1]:
                break
            v = int(idx[lo + np.searchsorted(rowcum[lo:hi], u, side="right")])
            if v in walk:
                break
            if len(walk) >= qcap:
                ovf[b] = True
                break
            walk.append(v)
            cur = v
        walks[b, :len(walk)] = walk
        lens[b], steps[b], roots_[b] = len(walk), t, root
    return walks, lens, ovf, steps, roots_


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind,qcap", [("ba", None), ("wc", None),
                                       ("wc", 3), ("er", 1)])
def test_lt_round_equals_numpy_replay(kind, qcap, weighted):
    tg, _ = _graphs(kind)
    g_rev = tcsr.reverse(tg)
    n = g_rev.n_nodes
    qcap = n if qcap is None else qcap
    table = (roots.build_alias_table(np.arange(n) % 5, device=CPU)
             if weighted else None)
    rowcum = lt.row_cumweights(g_rev)
    seed32 = round_seed(7, 2)
    got = ops.lt_walk(g_rev.offsets, g_rev.indices, rowcum, seed32, 96,
                      qcap=qcap, table=table)
    plain = ref.lt_round_ref(g_rev.offsets, g_rev.indices, rowcum, seed32,
                             96, qcap=qcap, table=table)
    want = _replay(g_rev, seed32, 96, qcap, table)
    for a, b, c in zip(got, plain, want):
        assert a.numpy().dtype == c.dtype
        assert _bits(a.numpy()) == _bits(b.numpy()) == _bits(c)
    lens, ovf = got[1].numpy(), got[2].numpy()
    if weighted:
        assert (got[4].numpy() % 5 != 0).all()   # no zero-weight root
    if qcap < n:
        assert ovf.any() and (lens[ovf] == qcap).all()
    else:
        assert not ovf.any() and lens.max() > 4
    # the sampler's batch: the walks trimmed to the longest, as RRBatch
    s = lt.sample_rrsets_lt(g_rev, 96, seed32, qcap=qcap, table=table)
    assert s.steps == int(got[3].max())
    assert _bits(s.nodes.numpy()) == _bits(got[0].numpy()[:, :lens.max()])


def test_lt_engine_and_name():
    tg, _ = _graphs("ba")
    g_rev = tcsr.reverse(tg)
    eng = make_engine("lt", g_rev, batch=32, ec=64)   # ec: not its option
    assert eng.name == "lt" and eng.qcap == g_rev.n_nodes
    assert resolve_engine_name("dense", "lt") == "lt"
    assert resolve_engine_name("dense", "ic") == "dense"
    b = eng.sample(round_seed(0, 0))
    b.validate(eng.item_space)
    assert (b.nodes[:, 0] == b.roots).all()


# --------------------------------------------------- the walks' law

def _port_sets(tg, count):
    eng = make_engine("lt", tcsr.reverse(tg), batch=64)
    sets, t = [], 0
    while len(sets) < count:
        b = eng.sample(round_seed(0, t))
        t += 1
        nodes, lens = b.nodes.numpy(), b.lengths.numpy()
        sets += [nodes[i, :lens[i]].tolist() for i in range(len(lens))]
    return sets[:count]


def _oracle_sets(jg, count, seed):
    rng = np.random.default_rng(seed)
    offs, idx, w = (np.asarray(a) for a in jcsr.reverse(jg))
    n = jg.n_nodes
    return [joracle.rr_set_lt(offs, idx, w, int(rng.integers(n)), rng)
            for _ in range(count)]


@pytest.mark.parametrize("kind", ["er", "ba", "wc"])
def test_ks_sizes_match_oracle(kind):
    tg, jg = _graphs(kind)
    sizes = [len(s) for s in _port_sets(tg, N_SIZES)]
    want = [len(s) for s in _oracle_sets(jg, N_SIZES, seed=1)]
    res = sps.ks_2samp(sizes, want)
    assert res.pvalue > P_MIN, (res, np.mean(sizes), np.mean(want))


@pytest.mark.parametrize("kind", ["ba", "wc"])
def test_node_hit_frequency_within_5_sigma(kind):
    tg, jg = _graphs(kind)
    n, t = tg.n_nodes, 2048
    hits_p = np.zeros(n)
    for s in _port_sets(tg, t):
        hits_p[s] += 1
    hits_o = np.zeros(n)
    for s in _oracle_sets(jg, t, seed=901):
        hits_o[s] += 1
    p1, p2 = hits_p / t, hits_o / t
    pool = (p1 + p2) / 2
    se = np.sqrt(np.maximum(pool * (1 - pool), 1e-12) * (2.0 / t))
    z = np.abs(p1 - p2) / se
    assert (np.abs(p1 - p2) <= SIGMA * se + 1e-12).all(), (z.max(), z.argmax())


def test_oracle_rr_set_lt_is_the_references():
    tg, _ = _graphs("ba")
    offs, idx, w = tcsr.reverse(tg).numpy()
    a = [oracle.rr_set_lt(offs, idx, w, r, np.random.default_rng(r))
         for r in range(20)]
    b = [joracle.rr_set_lt(offs, idx, w, r, np.random.default_rng(r))
         for r in range(20)]
    assert a == b
    assert oracle.imm_oracle(offs, idx, w, 60, 3, 0.5, seed=2, model="lt",
                             max_theta=200) == \
        joracle.imm_oracle(offs, idx, w, 60, 3, 0.5, seed=2, model="lt",
                           max_theta=200)


# --------------------------------------------------------------- solves

def _solve_graph():
    src, dst = jgen.barabasi_albert(400, 3, seed=1)
    w = _scaled_wc(src, dst, 400, 0.7)
    return tcsr.from_edges(src, dst, 400, weights=w, device=CPU)


def test_lt_ris_estimate_matches_forward_lt():
    g = _solve_graph()
    solver = IMMSolver(g, model="lt", batch=256, seed=3, device=CPU)
    res = solver.solve(IMProblem(k=5, eps=0.5))
    assert solver.engine_name == "lt"
    mc = forward.lt_spread(g, res.seeds, n_sims=256, seed=0)
    assert abs(res.spread - mc) / mc < MC_TOL, (res.spread, mc)
    assert forward.lt_sizes(g, res.seeds, 8, seed=1).shape == (8,)


def test_problem_model_overrides_solver_default():
    """test_problem_api's regression: an explicit model="ic" on the problem
    overrides a solver built with model="lt" (None inherits).  (Its
    t_rounds line: MRIM with the LT model raises, as the reference's.)"""
    g = _solve_graph()
    solver = IMMSolver(g, model="lt", batch=64, seed=0, device=CPU)
    solver.solve(IMProblem(k=2, eps=0.5, theta=128, model="ic"))
    assert solver.engine_name == "queue"
    solver.solve(IMProblem(k=2, eps=0.5, theta=128))   # None -> inherit lt
    assert solver.engine_name == "lt"
    solver = IMMSolver(g, batch=64, seed=0, device=CPU)
    solver.solve(IMProblem(k=2, eps=0.5, theta=128, model="lt"))
    assert solver.engine_name == "lt"
    with pytest.raises(ValueError, match="IC-only"):
        IMProblem(k=2, t_rounds=2, theta=128, model="lt")
    # a problem with t_rounds on a solver whose default model is LT
    with pytest.raises(ValueError, match="IC-only"):
        IMMSolver(g, model="lt", batch=64, seed=0, device=CPU).solve(
            IMProblem(k=2, t_rounds=2, theta=128))


def _fields(res, store):
    st = res.stats
    return (st.theta, st.lb, st.lb_iters, st.rounds, store.n_rr,
            store.n_elems, res.seeds.tolist(), res.gains.tolist(),
            _bits(np.float32(res.frac)), res.spread)


def test_lt_selections_agree_in_every_field():
    g = _solve_graph()
    prob = IMProblem(k=6, eps=0.5)
    out = {}
    for sel in ("flat", "bitset", "celf"):
        solver = IMMSolver(g, model="lt", batch=128, seed=5, selection=sel,
                           device=CPU)
        out[sel] = _fields(solver.solve(prob), solver.store)
    assert out["flat"] == out["bitset"] == out["celf"], out
    approx = IMMSolver(g, model="lt", batch=128, seed=5, sketch_k=4096,
                       device=CPU).solve(IMProblem(k=6, eps=0.5,
                                                   mode="approximate"))
    lo, hi = approx.spread_bounds
    assert len(set(approx.seeds.tolist())) == 6 and 0 < lo <= hi
