"""Streaming graphs on the port, against the JAX reference on the CPU.

* ``repro_torch.core.stream``: ``apply_edge_deltas`` (IC merges, removals,
  the strict error, out-of-range endpoints) gives the reference's offsets,
  indices, float32 weights and ``graph_digest``; ``affected_nodes``,
  ``make_deltas`` and ``VersionedGraph`` equal the reference's.
* Windowed eviction on one pool: JAX-sampled batches go into the
  reference's ``ShardedDeviceRRStore`` and the port's ``DeviceRRStore``,
  both with a sketch, plain and row-weighted (dyadic row weights, whose
  float32 sums are exact in any order); after ``evict_earliest_rounds``,
  ``evict_to_bytes`` and ``evict_rows_containing``, and after an append
  that follows each, the stats dicts and ``state()`` (round history and
  sketch words included) are equal.  A compaction that drops nothing
  keeps the incremental fold's words; ``from_state`` takes the
  reference's state, a state without a round history as one round, and
  refuses a row that holds a node twice.
* ``resolve_incremental``: on a restored reference pool with a θ no
  larger than the rows kept it samples nothing, and its
  ``last_incremental`` and seeds equal the reference's; with sampling no
  round seed repeats within the pool's life and no surviving row holds an
  affected node; the seeds' RIS estimate is within 10% of forward Monte
  Carlo on the new graph; the refusals and the cold fallback (equal to a
  cold solve on the new graph) as the reference's.
"""
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from repro.core import coverage as jcov, stream as jstream
from repro.core.engine import make_engine as jmake_engine
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.core import coverage as tcov, forward, stream
from repro_torch.core import imm as timm
from repro_torch.core.engine import make_engine
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N, M = 300, 1500
OPTS = {"batch": 64, "seed": 7, "selection": "fused"}


def _both_graphs(n=N, m=M, seed=0):
    src, dst = jgen.erdos_renyi(n, m, seed=seed)
    jg = jw.wc_weights(jcsr.from_edges(src, dst, n))
    tg = convert.graph_from_arrays(np.asarray(jg.offsets),
                                   np.asarray(jg.indices),
                                   np.asarray(jg.weights), device=CPU)
    return jg, tg


@pytest.fixture(scope="module")
def graphs():
    return _both_graphs()


def _graph_bytes(g):
    return [np.asarray(a).tobytes() for a in g]


def _arrays_equal(mine: dict, theirs: dict):
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        want = np.asarray(theirs[k])
        assert mine[k].dtype == want.dtype and mine[k].shape == want.shape, k
        assert mine[k].tobytes() == want.tobytes(), k


def _deltas(rng, g_src, g_dst, n, n_rm, n_add, p=0.1):
    rm = rng.choice(g_src.shape[0], n_rm, replace=False)
    a_s = rng.integers(0, n, n_add)
    a_d = (a_s + rng.integers(1, n, n_add)) % n
    return ((a_s, a_d, np.full(n_add, p, np.float32)),
            (g_src[rm], g_dst[rm]))


# ------------------------------------------------------------ deltas

def test_apply_edge_deltas_equals_the_reference(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(1)
    s, d, _ = jcsr.to_edges(jg)
    adds, removes = _deltas(rng, s, d, N, 40, 60)
    # re-adding existing edges merges them IC-exactly
    adds = tuple(np.concatenate([a, b]) for a, b in
                 zip(adds, (s[:10], d[:10], np.full(10, 0.5, np.float32))))
    for kw in ({"adds": adds}, {"removes": removes},
               {"adds": adds, "removes": removes}):
        mine = stream.apply_edge_deltas(tg, **kw)
        theirs = jstream.apply_edge_deltas(jg, **kw)
        assert mine.weights.dtype == torch.float32
        assert mine.device == tg.device
        assert _graph_bytes(mine.numpy()) == _graph_bytes(theirs)
        assert csr.graph_digest(mine) == jcsr.graph_digest(theirs)
    d1 = stream.make_deltas(adds, removes)
    d2 = jstream.make_deltas(adds, removes)
    np.testing.assert_array_equal(stream.affected_nodes(d1),
                                  jstream.affected_nodes(d2))
    assert (d1.n_adds, d1.n_removes, bool(d1)) == \
        (d2.n_adds, d2.n_removes, bool(d2))
    assert not stream.make_deltas()
    # strict removals of an absent edge, endpoints, probabilities
    absent = next((u, v) for u in range(N) for v in range(N)
                  if u != v and not ((s == u) & (d == v)).any())
    errs, lax = [], []
    for mod, g in ((stream, tg), (jstream, jg)):
        with pytest.raises(ValueError, match="absent edge") as e:
            mod.apply_edge_deltas(g, removes=([absent[0]], [absent[1]]))
        errs.append(str(e.value))
        lax.append(mod.apply_edge_deltas(
            g, removes=([absent[0]], [absent[1]]), strict=False))
        with pytest.raises(ValueError, match="out of range"):
            mod.apply_edge_deltas(g, adds=([0], [N], [0.5]))
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            mod.make_deltas(adds=([0], [1], [1.5]))
    assert errs[0] == errs[1]
    # lax: the absent removal is ignored (parallel edges still merge)
    assert _graph_bytes(lax[0].numpy()) == _graph_bytes(lax[1])
    assert _graph_bytes(lax[0].numpy()) == _graph_bytes(
        csr.coalesce_ic(tg).numpy())


def test_versioned_graph_equals_the_reference(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(2)
    s, d, _ = jcsr.to_edges(jg)
    mine, theirs = stream.VersionedGraph.wrap(tg), \
        jstream.VersionedGraph.wrap(jg)
    assert mine.digest == theirs.digest and mine.version == 0
    for _ in range(2):
        delta = _deltas(rng, s, d, N, 5, 5)
        mine, theirs = mine.apply(delta), theirs.apply(delta)
        s, d, _ = jcsr.to_edges(theirs.g)
        assert (mine.version, mine.digest) == (theirs.version, theirs.digest)


# ---------------------------------------------------------- eviction

def _jax_batches(jg, count, batch=64, seed=0):
    eng = jmake_engine("queue", jcsr.reverse(jg), batch=batch)
    out = []
    for i in range(count):
        b = eng.sample(jax.random.key(seed + i))
        out.append((np.asarray(b.nodes), np.asarray(b.lengths),
                    np.asarray(b.overflowed), int(b.steps)))
    return out


def _append_both(port, ref, b, rng, weighted):
    nodes, lens, ovf, steps = b
    row_w = (rng.integers(0, 40, lens.shape[0]) / 8).astype(np.float64) \
        if weighted else None
    port.append_batch(convert.batch_from_arrays(nodes, lens, ovf, steps,
                                                device=CPU), row_w=row_w)
    ref.append_batch((nodes, lens), row_w=row_w)


@pytest.mark.parametrize("weighted", [False, True])
def test_evictions_equal_the_reference(graphs, weighted):
    jg, _ = graphs
    rng = np.random.default_rng(5)
    batches = iter(_jax_batches(jg, 10))
    kw = dict(sketch_k=64, row_weighted=weighted)
    port = tcov.DeviceRRStore(N, capacity=512, device=CPU, **kw)
    ref = jcov.ShardedDeviceRRStore(N, capacity=512, **kw)
    for _ in range(6):
        _append_both(port, ref, next(batches), rng, weighted)
    assert port.n_rounds == ref.n_rounds == 6
    _arrays_equal(port.state(), ref.state())
    aff = np.array([3, 17, 40, 41, 99, 250])
    evictions = [
        lambda s: s.evict_earliest_rounds(2),
        lambda s: s.evict_to_bytes(s.per_device_pool_bytes() // 2),
        lambda s: s.evict_rows_containing(aff),
    ]
    for evict in evictions:
        a, b = evict(port), evict(ref)
        assert a == b
        assert a["rows_kept"] == port.n_rr
        _arrays_equal(port.state(), ref.state())
        np.testing.assert_array_equal(
            port.sketch_words().numpy().view(np.uint32),
            np.asarray(ref.sketch_words()))
        # the fold of a later append continues on the rebuilt sketch
        _append_both(port, ref, next(batches), rng, weighted)
        _arrays_equal(port.state(), ref.state())
    # membership eviction left no row with an affected node, then one
    # round (and the append after it)
    assert port.n_rounds == 2
    # clamping: more rounds than exist empty the pool
    assert port.evict_earliest_rounds(10) == ref.evict_earliest_rounds(10)
    assert port.n_rr == 0 and port.n_rounds == 0
    assert port.evict_earliest_rounds(1)["rows_dropped"] == 0
    _arrays_equal(port.state(), ref.state())


def test_compaction_keeps_the_incremental_fold_and_the_state(graphs):
    jg, _ = graphs
    rng = np.random.default_rng(6)
    port = tcov.DeviceRRStore(N, sketch_k=128, device=CPU)
    ref = jcov.ShardedDeviceRRStore(N, sketch_k=128)
    for b in _jax_batches(jg, 3):
        _append_both(port, ref, b, rng, False)
    # a wide append reserves 2^15 slots of headroom
    wide = np.full((600, 64), N, np.int32)
    lens = rng.integers(0, 4, 600).astype(np.int32)
    for i, ln in enumerate(lens):
        wide[i, :ln] = rng.permutation(N)[:ln]
    port.append_batch((wide, lens))
    ref.append_batch((wide, lens))
    assert port.capacity >= 1 << 15
    folded = port.sketch_words().clone()
    bound = port.per_device_pool_bytes() - 1
    a, b = port.evict_to_bytes(bound), ref.evict_to_bytes(bound)
    assert a == b and a["rounds_dropped"] == 0 and a["rows_dropped"] == 0
    assert port.capacity < 1 << 15
    assert torch.equal(port.sketch_words(), folded)
    _arrays_equal(port.state(), ref.state())
    # the reference's state restores, and one without a round history
    # counts as one round
    twin = tcov.DeviceRRStore.from_state(ref.state(), ref.config(),
                                         device=CPU)
    _arrays_equal(twin.state(), ref.state())
    old = {k: v for k, v in ref.state().items() if not k.startswith("round")}
    once = tcov.DeviceRRStore.from_state(old, ref.config(), device=CPU)
    assert once.n_rounds == 1 and once.n_rr == port.n_rr
    with pytest.raises(ValueError, match="shard"):
        tcov.DeviceRRStore.from_state(old, dict(ref.config(), n_shards=2),
                                      device=CPU)
    # a row holding a node twice is refused (the greedies need row-unique
    # rows)
    bad = dict(old, flat=old["flat"].copy())
    bad["flat"][0, 1] = bad["flat"][0, 0]
    bad["ids"] = old["ids"].copy()
    bad["ids"][0, 1] = bad["ids"][0, 0]
    with pytest.raises(ValueError, match="twice"):
        tcov.DeviceRRStore.from_state(bad, ref.config(), device=CPU)


# ---------------------------------------------------- incremental solve

@pytest.fixture(scope="module")
def ref_pool(graphs, tmp_path_factory):
    jg, _ = graphs
    d = str(tmp_path_factory.mktemp("pool"))
    js = JSolver(jg, **OPTS)
    js.solve(JProblem(k=3, theta=2048))
    js.save_pool(d)
    return d


def test_resolve_incremental_on_a_restored_pool_equals_the_reference(
        graphs, ref_pool):
    jg, tg = graphs
    rng = np.random.default_rng(3)
    s, d, _ = jcsr.to_edges(jg)
    deltas = _deltas(rng, s, d, N, 4, 4)
    js = JSolver(jg, **OPTS)
    js.restore_pool(ref_pool)
    want = js.resolve_incremental(JProblem(k=3, theta=512), deltas)
    ts = IMMSolver(tg, device=CPU, **OPTS)
    ts.restore_pool(ref_pool)
    got = ts.resolve_incremental(IMProblem(k=3, theta=512), deltas)
    assert ts.last_incremental == js.last_incremental
    assert ts.last_incremental["reused"]
    assert ts.last_incremental["rows_kept"] >= 512
    assert got.stats.rounds == want.stats.rounds == 0     # no sampling
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.gains, want.gains)
    assert got.frac == want.frac
    assert got.stats.history == want.stats.history
    assert csr.graph_digest(ts.g) == jcsr.graph_digest(js.g)


def test_resolve_incremental_never_repeats_a_round_seed(graphs, monkeypatch):
    _, tg = graphs
    drawn = []
    real = timm.round_seed
    monkeypatch.setattr(timm, "round_seed",
                        lambda seed, t: drawn.append((seed, t)) or
                        real(seed, t))
    solver = IMMSolver(tg, device=CPU, **OPTS)
    p = IMProblem(k=10, theta=1024)
    solver.solve(p)
    before = len(drawn)
    src, dst, _ = csr.to_edges(tg)
    deltas = _deltas(np.random.default_rng(4), src, dst, N, 20, 20)
    aff = stream.affected_nodes(stream.make_deltas(*deltas))
    res = solver.resolve_incremental(IMProblem(k=10, theta=2048), deltas)
    info = solver.last_incremental
    assert info["reused"] and 0 < info["rows_kept"] < 1024
    assert len(drawn) > before                     # the top-up sampled
    assert len(set(drawn)) == len(drawn)           # no seed twice
    assert [t for _, t in drawn] == list(range(len(drawn)))
    assert len({real(s, t) for s, t in drawn}) == len(drawn)
    # the kept rows come first: none holds an affected node
    st = solver.store
    t = st.n_elems
    kept = st.ids[:t] < info["rows_kept"]
    assert not np.isin(st.flat[:t][kept].numpy(), aff).any()
    assert st.n_rr >= 2048 and res.stats.history[0] == \
        ("delta", info["rows_dropped"], info["rows_kept"])
    # the estimate on the new graph against forward Monte Carlo
    mc = forward.ic_spread(solver.g, res.seeds, n_sims=2000, seed=0)
    assert abs(res.spread - mc) / mc < 0.10


def test_resolve_incremental_refusals_and_cold_fallback(graphs):
    _, tg = graphs
    src, dst, _ = csr.to_edges(tg)
    deltas = _deltas(np.random.default_rng(8), src, dst, N, 6, 6)
    inst = IMMSolver(tg, engine=make_engine("queue", csr.reverse(tg),
                                            batch=32), device=CPU)
    with pytest.raises(ValueError, match="string engine"):
        inst.resolve_incremental(IMProblem(k=2, theta=64), deltas)
    s = IMMSolver(tg, device=CPU, **OPTS)
    with pytest.raises(ValueError, match="MRIM"):
        s.resolve_incremental(IMProblem(k=2, theta=64, t_rounds=2), deltas)
    with pytest.raises(ValueError, match="exact pool"):
        s.resolve_incremental(IMProblem(k=2, theta=64, mode="approximate"),
                              deltas)
    p = IMProblem(k=3, theta=512)
    s.solve(p)
    got = s.resolve_incremental(p, deltas, min_surviving_fraction=1.01)
    assert s.last_incremental["reused"] is False
    assert s.last_incremental["rows_dropped"] > 0
    cold = IMMSolver(stream.apply_edge_deltas(tg, *deltas), device=CPU,
                     **OPTS).solve(p)
    np.testing.assert_array_equal(got.seeds, cold.seeds)
    assert got.frac == cold.frac and asdict(got.stats) == asdict(cold.stats)
    # another signature (a sketch the pool lacks) starts cold too
    s2 = IMMSolver(tg, device=CPU, **OPTS)
    s2.solve(p)
    s2.resolve_incremental(IMProblem(k=3, theta=512, early_exit=True),
                           deltas)
    assert s2.last_incremental["reused"] is False
    assert s2.last_incremental["n_rr_before"] == 0
