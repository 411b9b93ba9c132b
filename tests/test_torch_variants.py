"""The problem variants on the port against the JAX reference, on the CPU.

* ``IMProblem`` validates, digests, resolves and round-trips as the
  reference's (exact: digests and arrays equal).
* ``build_alias_table`` equals the reference's byte for byte; the weighted
  root draw follows w / Σw (χ² over 2^18 rows, p > 1e-3), never draws a
  zero-weight node, keeps the uniform draw without a table, and takes its
  accept draw as float32, rounded to nearest (bit 31 and values past 2^24).
* On one JAX-sampled pool fed to both stores, the variant greedy
  (``select_variant`` ``flat`` and ``bitset``), the CELF variant and the
  sketch greedy with candidates equal the reference's in seeds, gains and
  the float32 bytes of ``frac`` and ``spent`` (tolerance 0).
* Solves: every selection agrees, the budget holds, the seeds equal the
  numpy cost-ratio oracle on the port's own pool, a weighted solve draws
  only supported roots and equals the dense engine's, the pool is reused
  for an equal signature, and the variant keywords reach ``imm`` and
  ``imm_result``.
"""
import numpy as np
import jax
import pytest
import torch
from scipy import stats

from repro.core import coverage as jcov, roots as jroots
from repro.core.engine import make_engine as jmake_engine
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import (IMProblem as JProblem,
                                problem_from_state as jfrom_state,
                                problem_state as jstate)
from repro.ft.failures import DeadlineExceeded as JDeadline
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.core import coverage as tcov, forward, oracle, roots
from repro_torch.core.imm import IMMSolver, imm, imm_result
from repro_torch.core.problem import (IMProblem, IMResult, problem_from_state,
                                      problem_state)
from repro_torch.ft.failures import DeadlineExceeded
from repro_torch.graph import csr as tcsr, weights as tw
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bernoulli import counter_uniform_u32

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N = 300


def _bits(x):
    return np.asarray(x).tobytes()


# ------------------------------------------------------------- the spec

_PROBLEMS = [
    dict(k=3),
    dict(k=5, eps=0.3, node_weights=np.arange(6, dtype=np.float32)),
    dict(budget=7.5, costs=np.array([1, 2, 3, 4, 5, 6], np.float32)),
    dict(budget=4.0),
    dict(k=2, candidates=[1, 4]),
    dict(k=2, candidates=np.array([0, 1, 0, 1, 1, 0], bool)),
    dict(k=2, candidates=[5], mode="approximate", early_exit=True),
    dict(budget=9.0, costs=np.arange(1, 7, dtype=np.float32),
         candidates=[0, 2, 5], theta=100, max_theta=50, ell=2.0),
]


@pytest.mark.parametrize("kw", _PROBLEMS)
def test_problem_digests_and_resolve_equal_reference(kw):
    p, q = IMProblem(**kw), JProblem(**kw)
    assert p.signature_digest() == q.signature_digest()
    assert p.pool_digest(model="ic") == q.pool_digest(model="ic")
    assert p.pool_digest(graph_digest="g") == q.pool_digest(graph_digest="g")
    assert (p.variant, p.is_plain) == (q.variant, q.is_plain)
    a, b = p.resolve(6), q.resolve(6)
    for f in ("n_nodes", "n_items", "t_rounds", "k_steps", "scale"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("node_weights", "costs", "cand_mask", "cand_mask_items"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and _bits(x) == _bits(y), f
    # state round trips, across packages too
    state = problem_state(p)
    assert state == jstate(q)
    assert problem_from_state(state).signature_digest() == \
        jfrom_state(state).signature_digest() == p.signature_digest()


def test_budget_k_steps_is_the_affordable_bound():
    """costs 1 + (v mod 5) and B = 100 over the stand-in's node count: the
    budget buys 100 seeds at the cheapest cost, so k_steps = 100."""
    n = 75879
    costs = (1 + np.arange(n) % 5).astype(np.float32)
    r = IMProblem(costs=costs, budget=100.0).resolve(n)
    assert r.k_steps == 100 == JProblem(costs=costs, budget=100.0).resolve(
        n).k_steps
    r = IMProblem(costs=costs, budget=100.0, candidates=[3, 4]).resolve(n)
    assert r.k_steps == 2                 # two affordable candidates


@pytest.mark.parametrize("kw,err", [
    (dict(), ValueError), (dict(k=2, budget=3.0), ValueError),
    (dict(k=2, costs=[1.0]), ValueError), (dict(budget=-1.0), ValueError),
    (dict(k=0), ValueError), (dict(k=2, eps=1.0), ValueError),
    (dict(k=2, mode="approximate", node_weights=[1.0]), ValueError),
    (dict(budget=2.0, mode="approximate"), ValueError),
    (dict(k=2, model="sir"), ValueError)])
def test_problem_validation_equals_reference(kw, err):
    with pytest.raises(err):
        IMProblem(**kw)
    with pytest.raises(err):
        JProblem(**kw)


@pytest.mark.parametrize("kw,msg", [
    (dict(k=2, t_rounds=2, budget=3.0), "budgeted MRIM"),
    (dict(k=2, model="lt", t_rounds=2), "IC-only")])
def test_mrim_and_lt_still_raise(kw, msg):
    """MRIM is ported, with the reference's refusals: no budget with
    ``t_rounds`` and no LT model (``k`` with a budget fails first in both
    packages); ``model="lt"`` alone is ported (tests/test_torch_lt.py)."""
    assert IMProblem(k=2, model="lt").model == "lt"
    assert IMProblem(k=2, t_rounds=2).variant == "mrim"
    kw = {k: v for k, v in kw.items() if not (k == "k" and "budget" in kw)}
    with pytest.raises(ValueError, match=msg):
        IMProblem(**kw)
    with pytest.raises(ValueError, match=msg):
        JProblem(**kw)


@pytest.mark.parametrize("kw", [
    dict(node_weights=np.zeros(6)), dict(node_weights=np.ones(5)),
    dict(costs=np.zeros(6)), dict(budget=0.5, costs=np.ones(6) * 2),
    dict(candidates=[]), dict(candidates=[6]),
    dict(candidates=np.zeros(6, bool))])
def test_resolve_refuses_what_the_reference_refuses(kw):
    base = dict(k=2) if "budget" not in kw and "costs" not in kw \
        else dict(budget=kw.pop("budget", 3.0))
    kw = {**base, **kw}
    with pytest.raises(ValueError):
        IMProblem(**kw).resolve(6)
    with pytest.raises(ValueError):
        JProblem(**kw).resolve(6)


def test_result_seeds_per_round():
    res = IMResult(seeds=np.array([4, 1]), spread=1.0, gains=np.ones(2),
                   frac=0.5, stats=None, problem=IMProblem(k=2), n_nodes=6)
    assert res.seeds_per_round() == [[1, 4]]
    assert res.cost == 0.0 and not res.degraded


# ------------------------------------------------------- the alias table

_WEIGHTS = [np.arange(1, m + 1, dtype=np.float32) for m in range(1, 8)] + [
    np.array([0, 3, 0, 1, 0, 0, 2], np.float32),
    np.array([0, 0, 5, 0], np.float32),
    np.random.default_rng(0).random(200).astype(np.float32),
    np.random.default_rng(1).random(1000) ** 4,
    np.array([2.5], np.float32)]


@pytest.mark.parametrize("i", range(len(_WEIGHTS)))
def test_alias_table_equals_reference_byte_for_byte(i):
    w = _WEIGHTS[i]
    want = jroots.build_alias_table(w)
    got = roots.build_alias_table(w, device=CPU)
    assert got.prob.dtype == torch.float32 and got.alias.dtype == torch.int32
    assert _bits(got.prob.numpy()) == _bits(want.prob)
    assert _bits(got.alias.numpy()) == _bits(want.alias)
    carried = convert.alias_table_from_arrays(want.prob, want.alias,
                                              device=CPU)
    assert _bits(carried.prob.numpy()) == _bits(want.prob)


def test_alias_table_refuses_bad_weights():
    for w in ([], [0.0, 0.0], [1.0, -1.0], [np.inf], [[1.0]]):
        with pytest.raises(ValueError):
            roots.build_alias_table(np.asarray(w, np.float64), device=CPU)
    with pytest.raises(ValueError):
        convert.alias_table_from_arrays([0.5, 1.0], [0, 2], device=CPU)


def test_weighted_roots_follow_the_weights():
    """χ² of 2^18 roots against w / Σw over the non-zero buckets (p >
    1e-3), no zero-weight root, and no table keeps the uniform draw."""
    w = np.array([1, 2, 3, 0, 4, 5, 1, 0, 8], np.float32)
    table = roots.build_alias_table(w, device=CPU)
    seeds = roots.row_seeds(12345, 1 << 18, CPU)
    got = roots.draw_roots(seeds, w.size, table).numpy()
    counts = np.bincount(got, minlength=w.size)
    assert counts[w == 0].sum() == 0
    live = w > 0
    expect = w[live] / w.sum() * got.size
    assert stats.chisquare(counts[live], expect).pvalue > 1e-3
    plain = roots.draw_roots(seeds, w.size)
    u = counter_uniform_u32(seeds, roots.ROOT_COUNTER).numpy()
    assert _bits(plain.numpy()) == _bits(((u * w.size) >> 32).astype(
        np.int32))


def _accept_seeds(want_up: bool, count: int = 4) -> list:
    """Row seeds whose accept draw h has bit 31 set, lies past 2^24 and
    rounds up (``want_up``) or down when cast to float32."""
    cand = roots.row_seeds(99, 4096, CPU)
    h = counter_uniform_u32(cand, roots.ALIAS_COUNTER).numpy()
    f = h.astype(np.float32).astype(np.float64)
    ok = (h >= 1 << 31) & ((f > h) if want_up else (f < h))
    picked = cand.numpy()[ok][:count]
    assert len(picked) == count
    return picked.tolist()


@pytest.mark.parametrize("up", [True, False])
def test_weighted_accept_draw_is_float32(up):
    """prob at the float32 value of the accept draw: refused (x < x is
    false), and accepted one float32 step above, however h rounds."""
    n = 16
    seeds = torch.tensor(_accept_seeds(up), dtype=torch.int64)
    bucket = ((counter_uniform_u32(seeds, roots.ROOT_COUNTER) * n) >> 32)
    h = counter_uniform_u32(seeds, roots.ALIAS_COUNTER).numpy()
    draw = (h.astype(np.float32) * np.float32(2.0 ** -32))
    for step, accept in ((0, False), (1, True)):
        prob = np.zeros(n, np.float32)
        alias = np.full(n, n - 1, np.int32)
        for b, d in zip(bucket.tolist(), draw.tolist()):
            prob[b] = np.nextafter(np.float32(d), np.float32(2)) if step \
                else np.float32(d)
            alias[b] = (b + 1) % n
        table = roots.AliasTable(torch.from_numpy(prob),
                                 torch.from_numpy(alias))
        got = roots.draw_roots(seeds, n, table).numpy()
        want = bucket.numpy() if accept else (bucket.numpy() + 1) % n
        np.testing.assert_array_equal(got, want)


def test_queue_round_with_a_table_draws_the_tables_roots():
    """The plain round (what the kernel is held to) takes the roots of
    ``draw_roots(..., table)``; without a table its bytes are unchanged."""
    g = _graphs()[0]
    g_rev = tcsr.reverse(g)
    w = (np.arange(N) % 7).astype(np.float32)
    table = roots.build_alias_table(w, device=CPU)
    args = (g_rev.offsets, g_rev.indices, g_rev.weights, 77, 64)
    got = ops.queue_bfs(*args, qcap=N, ec=32, table=table)
    want_roots = roots.draw_roots(roots.row_seeds(77, 64, CPU), N, table)
    assert _bits(got[4].numpy()) == _bits(want_roots.numpy())
    assert (w[got[4].numpy()] > 0).all()
    q, lens = got[0].numpy(), got[1].numpy()
    assert (q[:, 0] == got[4].numpy()).all() and (lens >= 1).all()
    plain = ops.queue_bfs(*args, qcap=N, ec=32)
    again = ref.queue_round_ref(*args, qcap=N, ec=32)
    for a, b in zip(plain, again):
        assert _bits(a.numpy()) == _bits(b.numpy())


# ------------------------------------------------------ one sampled pool

_GRAPHS = {}


def _graphs():
    if not _GRAPHS:
        src, dst = jgen.barabasi_albert(N, 3, seed=2)
        _GRAPHS["g"] = (tw.wc_weights(tcsr.from_edges(src, dst, N,
                                                      device=CPU)),
                        jw.wc_weights(jcsr.from_edges(src, dst, N)))
    return _GRAPHS["g"]


@pytest.fixture(scope="module")
def batches():
    """Three batches of the reference's queue engine (numpy)."""
    _, jg = _graphs()
    eng = jmake_engine("queue", jcsr.reverse(jg), batch=128)
    out, key = [], jax.random.key(5)
    for _ in range(3):
        key, sub = jax.random.split(key)
        b = eng.sample(sub)
        out.append((np.asarray(b.nodes), np.asarray(b.lengths)))
    return out


def _stores(batches, n=N, shift=False, sketch_k=None):
    """The reference's and the port's exact stores on the same batches;
    ``shift`` puts row r's nodes in block r mod 3 of a 3n item space."""
    js = jcov.ShardedDeviceRRStore(n * (3 if shift else 1),
                                   sketch_k=sketch_k)
    ps = tcov.DeviceRRStore(n * (3 if shift else 1), sketch_k=sketch_k,
                            device=CPU)
    for nodes, lens in batches:
        if shift:
            nodes = nodes + n * (np.arange(nodes.shape[0]) % 3)[:, None]
        js.append_batch((nodes, lens))
        ps.append_batch((nodes.copy(), lens))
    return js, ps


_COSTS = (1 + np.arange(N) % 5).astype(np.float32)
_CAND = np.arange(N) % 3 == 0
_CASES = {
    "candidates": dict(k_steps=12, cand=_CAND),
    "budget": dict(k_steps=20, costs=_COSTS, budget=20.0),
    "cand_budget": dict(k_steps=13, cand=_CAND, costs=_COSTS, budget=13.0),
    "unit_budget": dict(k_steps=6, budget=6.0),
    "exhausted": dict(k_steps=5, cand=np.isin(np.arange(N), [7, 9])),
    "groups": dict(k_steps=6, n_group=N, n_groups=3, group_quota=2),
    "narrow_groups": dict(k_steps=8, n_group=7, n_groups=-(-N // 7),
                          group_quota=1),
}


def _spec(mod, case, n_items=N):
    kw = dict(_CASES[case])
    kw.setdefault("n_group", n_items)
    kw.setdefault("group_quota", kw["k_steps"])
    return mod.SelectionSpec(**kw)


@pytest.mark.parametrize("method", ["flat", "bitset", "auto"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_select_variant_equals_reference(batches, case, method):
    shift = case == "groups"
    js, ps = _stores(batches, shift=shift)
    items = N * (3 if shift else 1)
    want = jcov.select_variant(js, _spec(jcov, case, items), method=method)
    got = tcov.select_variant(ps, _spec(tcov, case, items), method=method)
    for f in ("seeds", "gains", "frac", "spent"):
        x, y = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and _bits(x) == _bits(y), (f, x, y)
    s = got.seeds.numpy()
    live = s[s < items]
    assert len(live) == len(set(live.tolist()))
    if case == "exhausted":
        assert set(live.tolist()) <= {7, 9}
        assert (s[len(live):] == items).all()
    if case == "groups":
        assert np.bincount(live // N, minlength=3).max() <= 2
    if case == "narrow_groups":
        assert len(set((live // 7).tolist())) == len(live)
    via_store = ps.select(_CASES[case]["k_steps"], method=method,
                          spec=_spec(tcov, case, items))
    assert _bits(via_store.seeds.numpy()) == _bits(s)


@pytest.mark.parametrize("eval_batch", [1, 8])
@pytest.mark.parametrize("case", ["candidates", "budget", "cand_budget",
                                  "exhausted", "groups", "narrow_groups"])
def test_celf_variant_equals_flat_variant_and_reference(batches, case,
                                                        eval_batch):
    shift = case == "groups"
    items = N * (3 if shift else 1)
    js, ps = _stores(batches, shift=shift, sketch_k=256)
    flat = tcov.select_variant(ps, _spec(tcov, case, items))
    st, jst = {}, {}
    got = tcov.select_seeds_celf(ps, 0, spec=_spec(tcov, case, items),
                                 eval_batch=eval_batch, stats_out=st)
    want = jcov.select_seeds_celf(js, 0, spec=_spec(jcov, case, items),
                                  eval_batch=eval_batch, stats_out=jst)
    live = flat.seeds.numpy() < items
    np.testing.assert_array_equal(got.seeds.numpy(),
                                  flat.seeds.numpy()[live])
    np.testing.assert_array_equal(got.gains.numpy(),
                                  flat.gains.numpy()[live])
    for f in ("frac", "spent"):
        assert _bits(getattr(got, f).numpy()) == \
            _bits(getattr(flat, f).numpy()), f
    for f in ("seeds", "gains", "frac", "spent"):
        assert _bits(getattr(got, f).numpy()) == \
            _bits(np.asarray(getattr(want, f))), f
    assert st == jst
    nosk = tcov.select_seeds_celf(ps, 0, spec=_spec(tcov, case, items),
                                  eval_batch=eval_batch, use_sketch=False)
    assert _bits(nosk.seeds.numpy()) == _bits(got.seeds.numpy())


def test_spec_checks():
    ps = tcov.DeviceRRStore(4, device=CPU)
    ps.append_batch((np.array([[0, 1]]), np.array([2])))
    with pytest.raises(ValueError, match="row_weighted store"):
        tcov.select_variant(ps, tcov.SelectionSpec(k_steps=1, n_group=4,
                                                   weighted=True))
    with pytest.raises(ValueError, match="cover"):
        tcov.select_variant(ps, tcov.SelectionSpec(k_steps=1, n_group=1,
                                                   n_groups=2))
    with pytest.raises(ValueError, match="shape"):
        tcov.select_variant(ps, tcov.SelectionSpec(
            k_steps=1, n_group=4, cand=np.ones(3, bool)))
    with pytest.raises(ValueError, match="method"):
        tcov.select_variant(ps, tcov.SelectionSpec(k_steps=1, n_group=4),
                            method="celf")


@pytest.mark.parametrize("sketch_k,cand,k", [
    (64, _CAND, 8), (1024, _CAND, 8), (256, np.isin(np.arange(N), [7, 9]), 5),
    (256, None, 6)])
def test_sketch_greedy_with_candidates_equals_reference(batches, sketch_k,
                                                        cand, k):
    js = jcov.SketchRRStore(N, sketch_k=sketch_k)
    ps = tcov.SketchRRStore(N, sketch_k=sketch_k, device=CPU)
    for nodes, lens in batches:
        js.append_batch((nodes, lens))
        ps.append_batch((nodes.copy(), lens))
    ji, pi = {}, {}
    want = jcov.select_seeds_sketch(js, k, cand=cand, info_out=ji)
    got = ps.select(k, cand=cand, info_out=pi)
    for f in ("seeds", "gains", "frac"):
        assert _bits(getattr(got, f).numpy()) == \
            _bits(np.asarray(getattr(want, f))), f
    assert pi == ji
    if cand is not None:
        s = got.seeds.numpy()
        assert set(s[s < N].tolist()) <= set(np.flatnonzero(cand).tolist())
    plain = ref.greedy_sketch_ref(ps.words, n=N, k=k, cand=None if cand is None
                                  else torch.from_numpy(cand))
    assert _bits(plain[0].numpy()) == _bits(got.seeds.numpy())


# ----------------------------------------------------------------- solves

def _pool_lists(store):
    t = store.n_elems
    flat = store.flat[:t].numpy()
    ids = store.ids[:t].numpy()
    valid = store.valid[:t].numpy()
    flat, ids = flat[valid], ids[valid]
    return [flat[ids == i].tolist() for i in range(store.n_rr)]


_SELECTIONS = ("fused", "bitset", "celf")


def test_budgeted_solves_agree_and_equal_the_oracle():
    tg, _ = _graphs()
    prob = IMProblem(eps=0.5, theta=768, costs=_COSTS, budget=12.0)
    outs = {}
    for sel in _SELECTIONS:
        solver = IMMSolver(tg, batch=256, seed=4, selection=sel,
                           eval_batch=8, device=CPU)
        res = solver.solve(prob)
        assert res.cost <= 12.0
        assert res.cost == float(np.float32(_COSTS[res.seeds].sum()))
        assert res.stats.variant == "budgeted"
        assert res.stats.budget_spent == res.cost
        outs[sel] = (res.seeds.tolist(), res.gains.tolist(),
                     np.float32(res.frac).tobytes(), res.cost)
        if sel == "fused":
            want, frac, spent = oracle.budgeted_greedy_cost_ratio(
                _pool_lists(solver.store), N, _COSTS, 12.0)
            assert res.seeds.tolist() == want
            assert res.cost == spent
            assert res.frac == pytest.approx(frac, rel=1e-6)
    assert len(set(map(str, outs.values()))) == 1, outs


def test_candidate_solves_agree_and_stay_inside():
    tg, _ = _graphs()
    ids = np.flatnonzero(_CAND)
    outs = {}
    for sel in _SELECTIONS:
        res = IMMSolver(tg, batch=128, seed=2, selection=sel, eval_batch=8,
                        device=CPU).solve(
            IMProblem(k=4, eps=0.5, max_theta=256, candidates=ids))
        assert set(res.seeds.tolist()) <= set(ids.tolist())
        outs[sel] = (res.seeds.tolist(), res.gains.tolist(),
                     np.float32(res.frac).tobytes(), res.stats.theta)
    assert len(set(map(str, outs.values()))) == 1, outs
    for sel in _SELECTIONS:
        res = IMMSolver(tg, batch=128, seed=2, selection=sel, eval_batch=8,
                        device=CPU).solve(
            IMProblem(k=5, theta=256, candidates=[7, 9]))
        s = res.seeds.tolist()
        assert len(s) == len(set(s)) and set(s) <= {7, 9}


def test_weighted_solve_draws_supported_roots_and_equals_dense():
    tg, _ = _graphs()
    w = (np.arange(N) % 7).astype(np.float32)
    prob = IMProblem(k=4, eps=0.5, theta=512, node_weights=w)
    res = {}
    for engine in ("queue", "dense"):
        solver = IMMSolver(tg, engine=engine, batch=128, seed=1, device=CPU)
        seen = []
        solver.prepare(prob)
        inner = solver.engine.sample

        def sample(seed32, inner=inner, seen=seen):
            b = inner(seed32)
            seen.append(b.roots.numpy())
            return b

        solver.engine.sample = sample
        res[engine] = solver.solve(prob)
        assert solver.engine.root_weights is not None
        assert (w[np.concatenate(seen)] > 0).all()
        r = res[engine]
        assert 0 < r.spread <= float(w.sum())
        assert r.stats.variant == "weighted"
    a, b = res["queue"], res["dense"]
    assert a.seeds.tolist() == b.seeds.tolist()
    assert a.gains.tolist() == b.gains.tolist() and a.frac == b.frac
    mc = forward.ic_spread(tg, a.seeds, n_sims=512, seed=3, node_weights=w)
    assert abs(a.spread - mc) / mc < 0.15, (a.spread, mc)


def test_forward_spread_weighs_the_active_set():
    tg, _ = _graphs()
    w = (np.arange(N) % 7).astype(np.float32)
    sizes = forward.ic_sizes(tg, [0, 1], n_sims=8, seed=2)
    wsum = forward.ic_sizes(tg, [0, 1], n_sims=8, seed=2, node_weights=w)
    assert wsum.dtype == torch.float32
    assert (wsum <= sizes * 6).all() and (wsum >= w[[0, 1]].sum()).all()
    ones = forward.ic_sizes(tg, [0, 1], n_sims=8, seed=2,
                            node_weights=np.ones(N))
    np.testing.assert_array_equal(ones.numpy(), sizes.numpy())


def test_prepare_reuses_the_pool_for_an_equal_signature():
    tg, _ = _graphs()
    solver = IMMSolver(tg, batch=64, seed=7, device=CPU)
    solver.solve(IMProblem(k=2, theta=128))
    store, rounds = solver.store, solver.stats.rounds
    solver.solve(IMProblem(k=3, theta=128, candidates=[1, 2, 3]))
    solver.solve(IMProblem(budget=3.0, theta=128))
    assert solver.store is store and solver.stats.rounds == rounds
    w = np.ones(N, np.float32)
    solver.solve(IMProblem(k=2, theta=128, node_weights=w))
    assert solver.store is not store
    assert solver.engine.root_weights is not None
    again = solver.store
    solver.solve(IMProblem(k=1, theta=128, node_weights=w.copy()))
    assert solver.store is again


def test_imm_and_imm_result_take_the_variant_keywords():
    tg, jg = _graphs()
    seeds, spread, st = imm(tg, k=3, theta=256, candidates=[5, 6, 7, 8],
                            batch=64, seed=1, device=CPU)
    assert set(seeds.tolist()) <= {5, 6, 7, 8} and st.variant == "candidates"
    res = imm_result(tg, IMProblem(theta=256, costs=_COSTS, budget=5.0),
                     batch=64, seed=1, device=CPU)
    assert res.cost <= 5.0 and res.stats.variant == "budgeted"
    with pytest.raises(TypeError, match="bogus"):
        imm_result(tg, IMProblem(k=1), bogus=1, device=CPU)
    # a deadline that expires before the first round: the reference's
    # DeadlineExceeded, word for word
    with pytest.raises(DeadlineExceeded) as mine:
        IMMSolver(tg, batch=64, device=CPU).solve_problem(
            IMProblem(k=1), deadline_s=0.0)
    with pytest.raises(JDeadline) as theirs:
        JSolver(jg, batch=64, selection="fused").solve_problem(
            JProblem(k=1), deadline_s=0.0)
    assert str(mine.value) == str(theirs.value)
    # MRIM is ported: imm takes t_rounds (tests/test_torch_mrim.py)
    seeds, _, st = imm(tg, k=2, t_rounds=2, theta=256, batch=64, seed=1,
                       device=CPU)
    assert st.variant == "mrim" and len(seeds) == 4


def test_approximate_solve_with_candidates():
    tg, _ = _graphs()
    ids = np.flatnonzero(_CAND)
    solver = IMMSolver(tg, batch=128, seed=3, sketch_k=512, device=CPU)
    res = solver.solve(IMProblem(k=4, theta=400, candidates=ids,
                                 mode="approximate"))
    assert set(res.seeds.tolist()) <= set(ids.tolist())
    exact = IMMSolver(tg, batch=128, seed=3, selection="fused",
                      device=CPU).solve(IMProblem(k=4, theta=400,
                                                  candidates=ids))
    # the exact regime (θ <= sketch_k, "mod"): the sketch greedy is exact
    assert res.seeds.tolist() == exact.seeds.tolist()


def test_the_kernels_round_as_the_reference():
    """The variant kernel's float32 maths is written with round-to-nearest
    intrinsics (XLA's float32 ``budget - spent``, ``spent + cost`` and
    ``occur / cost``), the alias accept with the edge trial's conversion,
    and the build never takes fast-math flags."""
    from repro_torch.kernels import _build
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "ftz" not in flags and "prec-div" not in flags
    greedy = (_build.CSRC / "greedy.cu").read_text()
    for op in ("__fsub_rn(va.budget, spent)", "__fadd_rn(spent",
               "__fdiv_rn(__int2float_rn(o), c)"):
        assert op in greedy, op
    # the queue and refill kernels draw their roots in the lane loop's
    # shared header
    queue = (_build.CSRC / "bfs_lane.cuh").read_text()
    assert "__uint2float_rn(counter_uniform_u32(seed, kAliasCounter)) * " \
           "0x1p-32f" in queue
    for src in ("queue.cu", "refill.cu"):
        assert '#include "bfs_lane.cuh"' in (_build.CSRC / src).read_text()


def test_variant_layout_words_and_scratch():
    """greedy_flat_variant's extra words a block (a blocked bit a slice
    node, the quotas of the groups a slice meets) and its 24-byte records,
    as csrc/greedy.cu's flat_layout counts them."""
    from repro_torch.kernels import greedy as tgreedy
    assert tgreedy.variant_words(575, None, 1) == (0, 0)
    assert tgreedy.variant_words(575, 75_879, 1) == (18, 1)
    assert tgreedy.variant_words(575, 100, 759) == (18, 7)
    # a bound: 575 nodes of width-1 groups meet 575 groups, counted 576
    assert tgreedy.variant_words(575, 1, 75_879) == (18, 576)
    shared = (232_448 - 256) & ~15
    plain = tgreedy.flat_scratch_bytes(75_879, 16_384, 35_538, 50, 132,
                                       shared)
    variant = tgreedy.flat_scratch_bytes(75_879, 16_384, 35_538, 50, 132,
                                         shared, 75_879, 1)
    assert variant - plain == 8 * 50 * 132
    assert tgreedy.flat_layout(75_879, 16_384, 132, shared, 75_879, 1) == \
        (575, 512, True)
    big = tgreedy.flat_layout(4_000_000, 64, 132, shared, 4_000_000, 1)
    assert not big.shared
    assert tgreedy.flat_scratch_bytes(4_000_000, 64, 10, 5, 132, shared,
                                      4_000_000, 1) == \
        24 * 5 * 132 + 8 * 10 + 4 * (2 * 4_000_000 + 65 + 2 * 10 + 132) \
        + 4 * 132 * (2 * 30_304 + 1 + 2 + 947 + 1)


def test_oracles_equal_reference():
    """The port's numpy oracles against the reference's on the same inputs
    and generator seeds: equal lists and floats (tolerance 0)."""
    from repro.core import oracle as joracle
    tg, jg = _graphs()
    rev = tcsr.reverse(tg)
    offs, idx, w = (x.numpy() for x in (rev.offsets, rev.indices,
                                        rev.weights))
    sets = [oracle.rr_set_ic(offs, idx, w, r, np.random.default_rng(r))
            for r in range(40)]
    assert sets == [joracle.rr_set_ic(offs, idx, w, r,
                                      np.random.default_rng(r))
                    for r in range(40)]
    rw = np.arange(40) % 4 + 0.5
    assert oracle.greedy_max_coverage(sets, N, 5) == \
        joracle.greedy_max_coverage(sets, N, 5)
    assert oracle.greedy_max_coverage_weighted(sets, N, 5, rw) == \
        joracle.greedy_max_coverage_weighted(sets, N, 5, rw)
    for cand in (None, _CAND):
        assert oracle.budgeted_greedy_cost_ratio(sets, N, _COSTS, 9.0,
                                                 cand) == \
            joracle.budgeted_greedy_cost_ratio(sets, N, _COSTS, 9.0, cand)
    got = oracle.imm_oracle(offs, idx, w, N, 3, 0.5, seed=2, max_theta=200)
    assert got == joracle.imm_oracle(offs, idx, w, N, 3, 0.5, seed=2,
                                     max_theta=200)
    assert oracle.imm_oracle(offs, idx, w, N, 3, 0.5, seed=2, model="lt",
                             max_theta=200) == \
        joracle.imm_oracle(offs, idx, w, N, 3, 0.5, seed=2, model="lt",
                           max_theta=200)
    fwd = tg.numpy()
    for nw in (None, (np.arange(N) % 7).astype(np.float32)):
        assert oracle.forward_ic_spread(*fwd, [0, 5], np.random.default_rng(
            4), n_sims=20, node_weights=nw) == joracle.forward_ic_spread(
            *fwd, [0, 5], np.random.default_rng(4), n_sims=20,
            node_weights=nw)
