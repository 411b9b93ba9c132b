"""The row-weighted store and engine instances on the solver, against the
JAX reference on the CPU.

* ``DeviceRRStore(row_weighted=True)`` holds the reference's
  ``ShardedDeviceRRStore(row_weighted=True)`` buffers element for element
  (flat, ids, valid, the element weights ``ew``), the float32 ``wsum``,
  the capacity through growth and the packed append's headroom, the pool
  bytes (13 a slot) and ``config()``; both refuse a missing ``row_w`` and
  one given to an unweighted store.
* The weighted selections (``select_variant`` on ``flat`` and ``bitset``,
  the CELF variant) equal the reference's on one pool, with and without
  candidates and costs: seeds, gains, ``frac`` and ``spent`` bit for bit
  at integer weights (v mod 7 + 1) and dyadic ones ((v mod 7) / 8), whose
  float32 sums are exact in any order.  At non-dyadic weights (1 / (v mod
  7 + 1)) the float32 sums round, and the two packages add in other
  orders, so gains and ``frac`` are held to a relative 1e-5 (a float32
  sum of a few hundred positive terms drifts by at most ~n · 2^-24) with
  the seeds equal.
* Solves on an engine instance: the reference's solver paths of
  ``tests/test_problem_api.py`` (row-weight mode equal across the three
  selections and to ``oracle.greedy_max_coverage_weighted`` on the pool's
  root weights; a weighted-root instance under a plain problem raises "no
  node_weights"; a named engine draws roots by the weights), an instance
  of the wrong item space ("item space") or given with ``batch=``, and a
  row-weighted solve that replays the reference's recorded batches equal
  to the reference's solve in every field.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import coverage as jcov, oracle as joracle
from repro.core.engine import make_engine as jmake_engine
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core import coverage as tcov, oracle
from repro_torch.core.engine import RRBatch, make_engine
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr as tcsr, weights as tw
from repro_torch.kernels import ops, ref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N = 300
_V = np.arange(N)
WEIGHTS = {"integer": (_V % 7 + 1).astype(np.float32),
           "dyadic": ((_V % 7) / 8).astype(np.float32),
           "fraction": (1.0 / (_V % 7 + 1)).astype(np.float32)}
RTOL = 1e-5        # non-dyadic weights: float32 sums in another order


def _bits(x):
    return np.asarray(x).tobytes()


# ------------------------------------------------------------- the store

def _random_batches(dyadic, seed=3):
    """Padded batches of row-unique rows, their row weights (float64, so
    the stores round them: eighths, or any reals), one wide batch for the
    packed append, and one past the first capacity."""
    rng = np.random.default_rng(seed)
    out = []
    for r, w, fill in ((40, 12, 0.6), (512, 80, 0.05), (700, 9, 0.9)):
        lens = (rng.random(r) < fill) * rng.integers(1, w + 1, r)
        nodes = np.stack([rng.permutation(N)[:w] for _ in range(r)])
        roww = rng.integers(0, 40, r) / 8 if dyadic else rng.random(r) * 5
        out.append((nodes.astype(np.int32), lens.astype(np.int32), roww))
    return out


@pytest.mark.parametrize("dyadic", [True, False])
def test_store_buffers_equal_reference(dyadic):
    """The buffers bit for bit; ``wsum`` too where the weights' float32
    sums are exact, else to a relative 1e-6 (a float32 sum of 1,252 terms
    in another order)."""
    js = jcov.ShardedDeviceRRStore(N, row_weighted=True)
    ps = tcov.DeviceRRStore(N, row_weighted=True, device=CPU)
    assert ps.per_device_pool_bytes() == js.per_device_pool_bytes() \
        == 13 * 4096
    for nodes, lens, roww in _random_batches(dyadic):
        js.append_batch((nodes, lens), row_w=roww)
        ps.append_batch((nodes, lens), row_w=roww)
        assert ps.capacity == js.capacity
        assert ps.n_rr == js.n_rr and ps.n_elems == js.n_elems
        for mine, theirs in ((ps.flat, js._flat), (ps.ids, js._ids),
                             (ps.valid, js._valid), (ps.ew, js._ew)):
            want = np.asarray(theirs)[0]
            assert mine.numpy().dtype == want.dtype
            assert _bits(mine.numpy()) == _bits(want)
        wsum = np.asarray(js._w_dev)[0]
        assert ps.wsum.numpy().dtype == wsum.dtype
        if dyadic:
            assert _bits(ps.wsum.numpy()) == _bits(wsum)
        else:
            np.testing.assert_allclose(ps.wsum.numpy(), wsum, rtol=1e-6)
    assert ps.capacity > 4096                    # the appends grew it
    assert ps.per_device_pool_bytes() == js.per_device_pool_bytes()
    assert ps.config() == js.config()
    plain = tcov.DeviceRRStore(N, device=CPU)
    assert plain.per_device_pool_bytes() == 9 * 4096
    assert not plain.config()["row_weighted"] and plain.ew is None


def test_store_refuses_row_weights_as_reference():
    batch = (np.array([[0, 1]]), np.array([2]))
    for store in (tcov.DeviceRRStore(4, row_weighted=True, device=CPU),
                  jcov.ShardedDeviceRRStore(4, row_weighted=True)):
        with pytest.raises(ValueError, match="needs row_w"):
            store.append_batch(batch)
        with pytest.raises(ValueError, match="aligned"):
            store.append_batch(batch, row_w=np.ones(2))
    for store in (tcov.DeviceRRStore(4, device=CPU),
                  jcov.ShardedDeviceRRStore(4)):
        with pytest.raises(ValueError, match="row_weighted=True"):
            store.append_batch(batch, row_w=np.ones(1))
    ps = tcov.DeviceRRStore(4, device=CPU)
    ps.append_batch(batch)
    spec = tcov.SelectionSpec(k_steps=1, n_group=4, weighted=True)
    with pytest.raises(ValueError, match="row_weighted store"):
        tcov.select_variant(ps, spec)
    with pytest.raises(ValueError, match="row_weighted store"):
        tcov.select_seeds_celf(ps, 1, spec=spec)


# --------------------------------------------- the weighted selections

@pytest.fixture(scope="module")
def pool():
    """Three batches of the reference's queue engine (numpy) with their
    roots, on a BA graph of N nodes."""
    src, dst = jgen.barabasi_albert(N, 3, seed=2)
    jg = jw.wc_weights(jcsr.from_edges(src, dst, N))
    eng = jmake_engine("queue", jcsr.reverse(jg), batch=128)
    out, key = [], jax.random.key(5)
    for _ in range(3):
        key, sub = jax.random.split(key)
        b = eng.sample(sub)
        out.append((np.asarray(b.nodes), np.asarray(b.lengths),
                    np.asarray(b.roots)))
    return out


def _stores(pool, w, sketch_k=None):
    js = jcov.ShardedDeviceRRStore(N, sketch_k=sketch_k, row_weighted=True)
    ps = tcov.DeviceRRStore(N, sketch_k=sketch_k, row_weighted=True,
                            device=CPU)
    for nodes, lens, roots in pool:
        js.append_batch((nodes, lens), row_w=w[roots])
        ps.append_batch((nodes, lens), row_w=w[roots])
    return js, ps


_CAND = _V % 3 == 0
_COSTS = (1 + _V % 5).astype(np.float32)
_CASES = {"plain": dict(k_steps=10),
          "candidates": dict(k_steps=8, cand=_CAND),
          "budget": dict(k_steps=12, costs=_COSTS, budget=12.0)}


def _spec(mod, case):
    kw = dict(_CASES[case])
    return mod.SelectionSpec(n_group=N, group_quota=kw["k_steps"],
                             weighted=True, **kw)


def _same(got, want, exact):
    for f in ("seeds", "gains", "frac", "spent"):
        x, y = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype, f
        if exact or f == "seeds":
            assert _bits(x) == _bits(y), (f, x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, err_msg=f)


@pytest.mark.parametrize("weights,case", [
    ("integer", "plain"), ("integer", "candidates"), ("integer", "budget"),
    ("dyadic", "budget"), ("fraction", "plain"), ("fraction", "budget")])
def test_weighted_select_variant_equals_reference(pool, weights, case):
    js, ps = _stores(pool, WEIGHTS[weights])
    exact = weights != "fraction"
    for method in ("flat", "bitset"):
        want = jcov.select_variant(js, _spec(jcov, case), method=method)
        got = tcov.select_variant(ps, _spec(tcov, case), method=method)
        _same(got, want, exact)
        assert got.gains.dtype == torch.float32
    # the plain version on the pool's arrays is ops' CPU route
    t = ps.n_elems
    cand, costs, budget = tcov._spec_operands(ps, _spec(tcov, case))
    kw = dict(n=N, num_rows=ps.row_capacity(), k=_CASES[case]["k_steps"],
              cand=cand, costs=costs, budget=float(budget), n_group=N,
              n_groups=1, group_quota=_CASES[case]["k_steps"],
              ew=ps.ew[:t])
    pool_args = (ps.flat[:t], ps.ids[:t], ps.valid[:t])
    for a, b in zip(ops.greedy_flat_variant(*pool_args, **kw),
                    ref.greedy_flat_variant_ref(*pool_args, **kw)):
        assert _bits(a.numpy()) == _bits(b.numpy())


@pytest.mark.parametrize("eval_batch", [1, 8])
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("weights", ["integer", "dyadic"])
def test_weighted_celf_variant_equals_flat_and_reference(pool, weights, case,
                                                         eval_batch):
    js, ps = _stores(pool, WEIGHTS[weights], sketch_k=256)
    flat = tcov.select_variant(ps, _spec(tcov, case))
    st, jst = {}, {}
    got = tcov.select_seeds_celf(ps, 0, spec=_spec(tcov, case),
                                 eval_batch=eval_batch, stats_out=st)
    want = jcov.select_seeds_celf(js, 0, spec=_spec(jcov, case),
                                  eval_batch=eval_batch, stats_out=jst)
    _same(got, want, exact=True)
    assert st == jst
    live = flat.seeds.numpy() < N
    assert _bits(got.seeds.numpy()) == _bits(flat.seeds.numpy()[live])
    assert _bits(got.gains.numpy()) == _bits(flat.gains.numpy()[live])
    for f in ("frac", "spent"):
        assert _bits(getattr(got, f).numpy()) == \
            _bits(getattr(flat, f).numpy()), f


def test_weighted_celf_kernels_plain_versions(pool):
    """The weighted forms of celf_eval/celf_apply (CPU route) against the
    reference's eval_batch_w/apply_seed_w arithmetic: covered weight of
    each candidate, then the commit's gain, and the unweighted forms
    unchanged."""
    w = WEIGHTS["integer"]
    _, ps = _stores(pool, w)
    t = ps.n_elems
    flat, ids, valid = ps.flat[:t], ps.ids[:t], ps.valid[:t]
    rows = ps.row_capacity()
    roww = tcov.row_weights(ids, valid, ps.ew[:t], rows)
    cov = torch.zeros(rows // 32, dtype=torch.int32)
    cands = torch.tensor([0, 5, -1, 17, 0], dtype=torch.int32)
    got = ops.celf_eval(flat, ids, valid, cov, cands, roww=roww)
    f, i = flat.numpy(), ids.numpy()
    rw = roww.numpy()
    want = [rw[np.unique(i[f == u])].sum(dtype=np.float32) if u >= 0 else 0
            for u in cands.tolist()]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.float32(want))
    gain = ops.celf_apply(flat, ids, valid, cov, 0, roww=roww)
    assert gain.dtype == torch.float32 and float(gain) == want[0]
    again = ops.celf_apply(flat, ids, valid, cov, 0, roww=roww)
    assert float(again) == 0.0
    counts = ops.celf_eval(flat, ids, valid, torch.zeros_like(cov), cands)
    assert counts.dtype == torch.int32
    assert counts.tolist() == [len(np.unique(i[f == u])) if u >= 0 else 0
                               for u in cands.tolist()]


# --------------------------------------------------------------- solves

def _graph(n=50, m=250, seed=3):
    src, dst = jgen.erdos_renyi(n, m, seed=seed)
    return (tw.wc_weights(tcsr.from_edges(src, dst, n, device=CPU)),
            jw.wc_weights(jcsr.from_edges(src, dst, n)))


def _pool_lists(store):
    t = store.n_elems
    flat = store.flat[:t].numpy()
    ids = store.ids[:t].numpy()
    return [flat[ids == i].tolist() for i in range(store.n_rr)]


def test_weighted_row_estimator_matches_numpy_reference():
    """test_problem_api's path on the port's own pool: an instance with
    uniform roots runs the row-weighted estimator, every selection gives
    the same seeds and gains, equal to the weighted numpy greedy on the
    pool's root weights."""
    g, _ = _graph()
    w = (np.arange(50) % 7 + 1).astype(np.float32)
    eng = make_engine("queue", tcsr.reverse(g), batch=64)
    outs = {}
    for sel in ("fused", "bitset", "celf"):
        solver = IMMSolver(g, engine=eng, seed=6, selection=sel, device=CPU)
        assert solver.engine is eng        # built eagerly
        res = solver.solve(IMProblem(k=4, eps=0.5, theta=512,
                                     node_weights=w))
        assert solver._row_weight_mode and solver.store.row_weighted
        outs[sel] = (res.seeds.tolist(), res.gains.tolist(), res.frac)
        if sel == "fused":
            rr = _pool_lists(solver.store)
            roww = w[[r[0] for r in rr]]   # queue rows are root-first
            ref_seeds, ref_frac = oracle.greedy_max_coverage_weighted(
                rr, 50, 4, roww)
            assert (ref_seeds, ref_frac) == \
                joracle.greedy_max_coverage_weighted(rr, 50, 4, roww)
            assert res.seeds.tolist() == ref_seeds
            assert res.frac == pytest.approx(ref_frac, rel=1e-5)
            assert res.spread == pytest.approx(float(w.sum()) * ref_frac,
                                               rel=1e-5)
            assert float(solver.store.wsum) == float(roww.sum())
    assert len(set(map(str, outs.values()))) == 1, outs


def test_instance_raises():
    g, _ = _graph()
    w = (np.arange(50) % 3 + 1).astype(np.float32)
    g_rev = tcsr.reverse(g)
    eng = make_engine("queue", g_rev, batch=32, root_weights=w)
    solver = IMMSolver(g, engine=eng, seed=0, device=CPU)   # deferred
    assert solver.store is None
    with pytest.raises(ValueError, match="no node_weights"):
        solver.solve(IMProblem(k=2, eps=0.5, theta=128))
    # matching weights keep the plain selection on the alias roots
    res = IMMSolver(g, engine=eng, seed=0, device=CPU).solve(
        IMProblem(k=2, eps=0.5, theta=128, node_weights=w))
    assert len(res.seeds) == 2 and res.gains.sum() > 0
    assert res.gains.dtype.kind == "i"
    with pytest.raises(ValueError, match="no effect"):
        IMMSolver(g, engine=make_engine("queue", g_rev), batch=64,
                  device=CPU)
    with pytest.raises(ValueError, match="no effect"):
        IMMSolver(g, engine=make_engine("queue", g_rev), model="lt",
                  device=CPU)

    class Wide:
        name = "wide"
        root_weights = None
        item_space = 51
        g_rev = None

        def sample(self, seed32):
            raise AssertionError("never sampled")

    wide = IMMSolver(g, engine=Wide(), device=CPU)   # deferred: not n
    with pytest.raises(ValueError, match="item space"):
        wide.solve(IMProblem(k=1, eps=0.5, theta=16))


def test_named_engine_draws_weight_proportional_roots():
    g, _ = _graph(seed=4)
    w = np.zeros(50, np.float32)
    w[:10] = 1.0
    solver = IMMSolver(g, batch=64, seed=1, device=CPU)
    res = solver.solve(IMProblem(k=3, eps=0.5, theta=256, node_weights=w))
    assert not solver._row_weight_mode and not solver.store.row_weighted
    assert solver.engine.root_weights is not None
    assert all(r[0] < 10 for r in _pool_lists(solver.store))
    assert res.spread <= float(w.sum()) + 1e-6


class _Recorder:
    """The reference's side: a queue engine whose batches, roots
    included, are kept (numpy)."""
    name = "recorder"
    root_weights = None

    def __init__(self, inner):
        self.inner, self.g_rev = inner, inner.g_rev
        self.batches = []

    @property
    def item_space(self):
        return self.inner.item_space

    def sample(self, key):
        b = self.inner.sample(key)
        self.batches.append(tuple(np.asarray(x) for x in (
            b.nodes, b.lengths, b.overflowed, b.roots)) + (int(b.steps),))
        return b


class _Replay:
    """The port's side: an engine instance that gives the recorded
    batches, in order."""
    name = "replay"
    root_weights = None
    g_rev = None

    def __init__(self, batches, n):
        self._it, self.item_space = iter(batches), n

    def sample(self, seed32):
        nodes, lens, ovf, roots, steps = next(self._it)
        return RRBatch(torch.from_numpy(nodes.copy()),
                       torch.from_numpy(lens.copy()),
                       torch.from_numpy(ovf.copy()), steps,
                       roots=torch.from_numpy(roots.copy()))


@pytest.mark.parametrize("weights,selection", [("integer", "fused"),
                                               ("dyadic", "celf")])
def test_row_weighted_solve_equals_reference(weights, selection):
    tg, jg = _graph(n=60, m=240, seed=1)
    w = ((np.arange(60) % 7 + 1) if weights == "integer"
         else (np.arange(60) % 7) / 8).astype(np.float32)
    rec = _Recorder(jmake_engine("queue", jcsr.reverse(jg), batch=64))
    prob = dict(k=4, eps=0.5, node_weights=w)
    want = JSolver(jg, engine=rec, seed=3, selection=selection).solve(
        JProblem(**prob))
    port = IMMSolver(tg, engine=_Replay(rec.batches, 60), seed=3,
                     selection=selection, device=CPU)
    got = port.solve(IMProblem(**prob))
    assert port._row_weight_mode
    a, b = got.stats, want.stats
    assert (a.theta, a.lb, a.lb_iters, a.rounds, a.n_rr_sampled) == \
        (b.theta, b.lb, b.lb_iters, b.rounds, b.n_rr_sampled)
    assert a.history == [tuple(h) for h in b.history]
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    assert _bits(np.asarray(got.gains, np.float32)) == \
        _bits(np.asarray(want.gains, np.float32))
    assert _bits(np.float32(got.frac)) == _bits(np.float32(want.frac))
    assert got.spread == want.spread
