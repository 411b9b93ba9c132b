"""The torch port's dense-frontier engine and bit-packed sampler against the
JAX reference (``repro.core.dense``, ``repro.kernels``).

Tolerances: every comparison here is exact (integer and boolean results,
and float32 trials computed with the same rounding), except the two
distribution tests, which use the suite's laws: a two-sample KS test on
RR-set sizes (p > 0.01) and a 5-sigma two-sample bound on every node's hit
frequency, as ``tests/test_torch_rrset.py`` holds the queue sampler.

* The new plain kernels equal ``repro.kernels.ref`` and the reference's
  Pallas kernels in interpret mode (``repro.kernels.ops``), bit for bit.
* ``_sample_dense_packed`` given the reference's roots equals
  ``repro.core.dense.sample_rrsets_dense_packed`` in words, Occur, sizes
  and roots: both draw their trials from the same counter hash and seeds.
* The ``dense`` engine keeps the queue sampler's per-row contract, so it
  gives the queue engine's RR sets, row for row, and the same solves.
"""
import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch
from scipy import stats as sps

from repro.core import dense as jdense, oracle
from repro.core import packing as jpacking, sketch as jsketch
from repro.core.engine import make_engine as jmake_engine
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import dense as tdense, packing as tpacking
from repro_torch.core import sketch as tsketch
from repro_torch.core.engine import DenseEngine, RRBatch, make_engine
from repro_torch.core.imm import IMMSolver, imm
from repro_torch.core.problem import IMProblem
from repro_torch.core.rrset import round_seed
from repro_torch.graph import csr as tcsr, weights as tw
from repro_torch.kernels import ops as tops, ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
P_MIN = 0.01        # KS acceptance, as test_conformance.py
SIGMA = 5.0         # two-sample bound, as test_conformance.py
RNG = np.random.default_rng(13)


def _bits(shape, rng=RNG):
    """Random bool matrix; byte 31 of every 32-byte group is set in about
    half the groups, so bit 31 of the packed words is exercised."""
    return rng.integers(0, 2, size=shape).astype(bool)


def _u32_words(shape, rng=RNG):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.int64).astype(
        np.uint32)


def _as_i32(words_u32):
    return torch.tensor(np.ascontiguousarray(words_u32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


# ------------------------------------------------------------ plain kernels

@pytest.mark.parametrize("b,n", [(1, 32), (7, 96), (37, 320), (64, 64)])
def test_pack_bits_plain_equals_reference(b, n):
    x = _bits((b, n))
    x[0, 31] = True                                  # bit 31 of word 0
    want = np.asarray(jops.pack_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(want, np.asarray(jref.pack_bits_ref(
        jnp.asarray(x))))
    got = tref.pack_bits_ref(torch.tensor(x))
    assert got.dtype == torch.int32 and got.shape == (b, n // 32)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(tops.pack_bits(torch.tensor(x))),
                                  want)
    assert (want >> 31).any() and (got < 0).any()


@pytest.mark.parametrize("n", [1, 33, 95])
def test_pack_bits_rejects_ragged_width(n):
    with pytest.raises(ValueError, match="multiple of 32"):
        jops.pack_bits(jnp.zeros((2, n), bool))
    with pytest.raises(ValueError, match="multiple of 32"):
        tref.pack_bits_ref(torch.zeros(2, n, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of 32"):
        tops.pack_bits(torch.zeros(2, n, dtype=torch.bool))


@pytest.mark.parametrize("b,w", [(1, 1), (8, 5), (37, 7), (64, 75)])
def test_bitset_or_andnot_popcount_plain_equal_reference(b, w):
    x, y = _u32_words((b, w)), _u32_words((b, w))
    x[0, 0] = 0x80000000                            # bit 31 alone
    ja, jb = jnp.asarray(x), jnp.asarray(y)
    for jfn, jrfn, tfn, trfn in [
            (jops.bitset_or, jref.bitset_or_ref, tops.bitset_or,
             tref.bitset_or_ref),
            (jops.bitset_andnot, jref.bitset_andnot_ref, tops.bitset_andnot,
             tref.bitset_andnot_ref)]:
        want = np.asarray(jfn(ja, jb))
        np.testing.assert_array_equal(want, np.asarray(jrfn(ja, jb)))
        np.testing.assert_array_equal(_u32(trfn(_as_i32(x), _as_i32(y))), want)
        np.testing.assert_array_equal(_u32(tfn(_as_i32(x), _as_i32(y))), want)
    want = np.asarray(jops.popcount_words(ja))
    got = tops.popcount_words(_as_i32(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.popcount_words_ref(ja)))
    assert got[0, 0] == 1


@pytest.mark.parametrize("b,w", [(1, 1), (8, 5), (37, 7), (64, 75)])
def test_frontier_update_plain_equals_reference_pair(b, w):
    """``ref.frontier_update_ref(a, visited)`` (and ``ops`` on CPU tensors)
    is the reference's level: ``new = bitset_andnot(a, visited)`` and
    ``visited = bitset_or(visited, new)`` (Pallas, interpret mode), with
    visited updated in place; bit 31 alone in a word on purpose, and a
    aliasing visited."""
    x, y = _u32_words((b, w)), _u32_words((b, w))
    x[0, 0], y[-1, -1] = 0x80000000, 0x80000000
    ja, jv = jnp.asarray(x), jnp.asarray(y)
    jnew = jops.bitset_andnot(ja, jv)
    jvis = np.asarray(jops.bitset_or(jv, jnew))
    for fn in (tref.frontier_update_ref, tops.frontier_update):
        visited = _as_i32(y)
        new = fn(_as_i32(x), visited)
        assert new.dtype == visited.dtype == torch.int32
        np.testing.assert_array_equal(_u32(new), np.asarray(jnew))
        np.testing.assert_array_equal(_u32(visited), jvis)
    same = _as_i32(y)
    assert not tref.frontier_update_ref(same, same).any()
    np.testing.assert_array_equal(_u32(same), y)


def _weights(e, rng=RNG):
    """Float32 weights in [0, 1] with exact 0s and 1s."""
    w = rng.uniform(size=e).astype(np.float32)
    w[::17] = 0.0
    w[5::19] = 1.0
    return w


@pytest.mark.parametrize("e", [1, 1000, 1025, 3001])
@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF, 0xFFFFFFFF])
def test_bernoulli_edges_one_seed_equals_reference(e, seed):
    """E ragged against the Pallas block of 1024; bit for bit."""
    w = _weights(e)
    want = np.asarray(jops.bernoulli_edges(jnp.asarray(w), jnp.uint32(seed)))
    np.testing.assert_array_equal(want, np.asarray(jref.bernoulli_edges_ref(
        jnp.asarray(w), jnp.uint32(seed))))
    for s in (seed, torch.tensor(seed, dtype=torch.int64)):
        got = tops.bernoulli_edges(torch.tensor(w), s)
        assert got.dtype == torch.bool and got.shape == (e,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bernoulli_edges_seed_vector_equals_vmapped_reference():
    """A (B,) seed vector gives what jax.vmap(bernoulli_edges) gives, also
    when the plain version splits the seeds into blocks."""
    w = _weights(3001)
    seeds = (np.arange(6, dtype=np.uint64) * 2654435761 + 11) % (1 << 32)
    want = np.asarray(jax.vmap(lambda s: jops.bernoulli_edges(
        jnp.asarray(w), s))(jnp.asarray(seeds.astype(np.uint32))))
    t_seeds = torch.tensor(seeds.astype(np.int64))
    got = tops.bernoulli_edges(torch.tensor(w), t_seeds)
    assert got.shape == (6, 3001)
    np.testing.assert_array_equal(got.numpy(), want)
    old = tref._TRIAL_ELEMS
    try:
        tref._TRIAL_ELEMS = 2 * 3001                 # blocks of 2 seeds
        np.testing.assert_array_equal(
            tref.bernoulli_edges_ref(torch.tensor(w), t_seeds).numpy(), want)
    finally:
        tref._TRIAL_ELEMS = old
    # int32 seeds holding bit 31 are taken mod 2^32
    neg = torch.tensor(seeds.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(
        tops.bernoulli_edges(torch.tensor(w), neg).numpy(), want)


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize("b,c", [(1, 1), (5, 9), (16, 40)])
def test_pack_rows_equal_reference(b, c):
    mask = RNG.integers(0, 2, size=(b, c)).astype(bool)
    mask[0] = False                                  # an empty row
    vals = RNG.integers(0, 1000, size=(b, c)).astype(np.int32)
    want_rows, want_lens = jpacking.pack_rows(vals, mask)
    got_rows, got_lens = tpacking.pack_rows(vals, mask)
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_lens, want_lens)
    jr, jl = jpacking.pack_rows_device(jnp.asarray(vals), jnp.asarray(mask))
    tr, tl = tpacking.pack_rows_device(torch.tensor(vals), torch.tensor(mask))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tr.dtype == torch.int32 and tl.dtype == torch.int32
    # a width of the longest row is the reference's rows, trimmed
    width = max(int(mask.sum(axis=1).max()), 1)
    tw_rows, tw_lens = tpacking.pack_rows_device(
        torch.tensor(vals), torch.tensor(mask), width)
    np.testing.assert_array_equal(tw_rows.numpy(), np.asarray(jr)[:, :width])
    np.testing.assert_array_equal(tw_lens.numpy(), np.asarray(jl))


def test_membership_conversions_equal_reference():
    mem = RNG.integers(0, 2, size=(12, 70)).astype(bool)
    mem[3] = False
    assert tdense.membership_to_lists(torch.tensor(mem)) == \
        jdense.membership_to_lists(jnp.asarray(mem))
    want_nodes, want_lens = jdense.membership_to_padded(jnp.asarray(mem))
    got_nodes, got_lens = tdense.membership_to_padded(torch.tensor(mem))
    np.testing.assert_array_equal(got_nodes, want_nodes)
    np.testing.assert_array_equal(got_lens, want_lens)


def test_pack_sketch_equals_reference():
    occ = _bits((40, 96))
    want = np.asarray(jsketch.pack_sketch(jnp.asarray(occ), words=3))
    got = tsketch.pack_sketch(torch.tensor(occ), words=3)
    np.testing.assert_array_equal(_u32(got), want)
    with pytest.raises(ValueError, match="words \\* 32"):
        tsketch.pack_sketch(torch.tensor(occ), words=2)


# ----------------------------------------------------- bit-packed sampler

def _graphs(kind, p=None):
    """(port graph, reference graph) of one topology: WC weights, or
    uniform p when given."""
    if kind == "er":
        (src, dst), n = jgen.erdos_renyi(100, 500, seed=1), 100
    elif kind == "er40":
        (src, dst), n = jgen.erdos_renyi(40, 160, seed=1), 40
    else:
        (src, dst), n = jgen.barabasi_albert(200, 3, seed=4), 200
    tg = tcsr.from_edges(src, dst, n, device=CPU)
    jg = jcsr.from_edges(src, dst, n)
    if p is None:
        return tw.wc_weights(tg), jw.wc_weights(jg), (src, dst, n)
    return (tw.uniform_weights(tg, p=p), jw.uniform_weights(jg, p=p),
            (src, dst, n))


@pytest.mark.parametrize("kind,base_seed", [("er", 0), ("er", 1),
                                            ("ba", 7), ("ba", 0xFFFFFFFF)])
def test_packed_sampler_equals_reference_given_its_roots(kind, base_seed):
    tg, jg, _ = _graphs(kind)
    t_rev, j_rev = tcsr.reverse(tg), jcsr.reverse(jg)
    want = jdense.sample_rrsets_dense_packed(jax.random.key(base_seed % 97),
                                             j_rev, 24, base_seed=base_seed)
    roots = torch.tensor(np.asarray(want.roots))
    got = tdense._sample_dense_packed(t_rev, roots, base_seed)
    np.testing.assert_array_equal(_u32(got.words), np.asarray(want.words))
    np.testing.assert_array_equal(got.occur.numpy(), np.asarray(want.occur))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    np.testing.assert_array_equal(got.roots.numpy(), np.asarray(want.roots))
    assert got.levels >= 1 and int(got.sizes.max()) > 1


def test_packed_sampler_p1_exact():
    """p = 1: every lane's set is its root's ancestors (the reference's
    test_packed_engine_p1_exact); Occur and sizes are the column and row
    sums of the membership."""
    tg, _, (src, dst, n) = _graphs("er40", p=1.0)
    s = tdense.sample_rrsets_dense_packed(tcsr.reverse(tg), 8, 5)
    G = nx.DiGraph()
    G.add_nodes_from(range(n))
    G.add_edges_from(zip(src.tolist(), dst.tolist()))
    words = _u32(s.words)
    mem = np.array([[(int(words[b, v >> 5]) >> (v & 31)) & 1
                     for v in range(n)] for b in range(8)], np.int32)
    for b, root in enumerate(s.roots.tolist()):
        assert set(np.nonzero(mem[b])[0].tolist()) == \
            nx.ancestors(G, root) | {root}
    np.testing.assert_array_equal(s.occur.numpy()[:n], mem.sum(axis=0))
    np.testing.assert_array_equal(s.sizes.numpy(), mem.sum(axis=1))
    assert s.occur.shape == (64,) and not s.occur[n:].any()


# ------------------------------------------------------------ dense engine

def test_rrbatch_validate_accepts_root_anywhere_in_row():
    """The root must be in the row, not at its head (the reference's
    invariant): an ascending dense row passes, a row without it fails."""
    nodes = torch.tensor([[1, 4, 7], [0, 2, 0]], dtype=torch.int32)
    lens = torch.tensor([3, 2], dtype=torch.int32)
    ok = RRBatch(nodes, lens, torch.zeros(2, dtype=torch.bool), 1,
                 roots=torch.tensor([7, 0], dtype=torch.int32))
    ok.validate(8)
    with pytest.raises(ValueError, match="does not hold its root"):
        ok._replace(roots=torch.tensor([7, 3], dtype=torch.int32)).validate(8)


@pytest.mark.parametrize("kind", ["er", "ba", "multi"])
def test_dense_engine_equals_queue_engine_row_for_row(kind):
    """The same per-row contract: the same roots and, as sets, the same RR
    sets in every row; dense rows are ascending and hold their roots."""
    if kind == "multi":
        # parallel edges: both engines coalesce under p' = 1 - prod(1 - p)
        rng = np.random.default_rng(3)
        src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
        g = tcsr.from_edges(src, dst, 50, weights=rng.uniform(
            0.05, 0.6, 400).astype(np.float32), device=CPU)
    else:
        g = _graphs(kind)[0]
    g_rev = tcsr.reverse(g)
    dense = make_engine("dense", g_rev, batch=48)
    queue = make_engine("queue", g_rev, batch=48)
    assert isinstance(dense, DenseEngine) and dense.config.batch == 48
    for t in range(3):
        s = round_seed(9, t)
        d, q = dense.sample(s), queue.sample(s)
        d.validate(dense.item_space)
        assert torch.equal(d.roots, q.roots)
        assert torch.equal(d.lengths, q.lengths)
        assert d.nodes.shape[1] == max(int(d.lengths.max()), 1)
        assert not d.overflowed.any() and d.steps >= 1
        for i in range(48):
            row = d.nodes[i, :int(d.lengths[i])].tolist()
            assert row == sorted(row)
            assert set(row) == set(q.nodes[i, :int(q.lengths[i])].tolist())


def test_dense_engine_default_config_and_levels():
    g_rev = tcsr.reverse(_graphs("ba")[0])
    eng = DenseEngine(g_rev)
    assert eng.config.batch == 256
    b = eng.sample(3)
    assert b.n_sets == 256
    # one level per BFS step that found a non-empty frontier: the deepest
    # set's depth + 1 (the last level finds nothing new)
    s = tdense.sample_rrsets_dense(eng.g_rev, 256, 3)
    assert s.levels == b.steps
    assert torch.equal(s.membership.sum(dim=1).to(torch.int32), b.lengths)


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_dense_sampler_deterministic_weights(p):
    """p = 0: singletons; p = 1: exact reverse reachability (the
    reference's test_core_rrset cases)."""
    tg, _, (src, dst, n) = _graphs("er40", p=p)
    s = tdense.sample_rrsets_dense(tcsr.reverse(tg), 16, 4)
    G = nx.DiGraph()
    G.add_nodes_from(range(n))
    G.add_edges_from(zip(src.tolist(), dst.tolist()))
    for row, root in zip(tdense.membership_to_lists(s.membership),
                         s.roots.tolist()):
        want = {root} if p == 0.0 else nx.ancestors(G, root) | {root}
        assert set(row) == want
    if p == 0.0:
        assert s.levels == 1
    else:
        assert s.levels > 1


@pytest.mark.parametrize("mode", ["exact", "approximate"])
def test_dense_solve_equals_queue_solve(mode):
    tg = _graphs("ba")[0]
    kw = dict(batch=64, seed=2, device=CPU)
    if mode == "approximate":
        kw.update(mode="approximate", sketch_k=4096, max_theta=4096)
    d_seeds, d_spread, d_st = imm(tg, 5, 0.4, engine="dense", **kw)
    q_seeds, q_spread, q_st = imm(tg, 5, 0.4, engine="queue", **kw)
    np.testing.assert_array_equal(d_seeds, q_seeds)
    assert d_spread == q_spread
    assert (d_st.theta, d_st.lb, d_st.rounds, d_st.n_rr_sampled) == \
        (q_st.theta, q_st.lb, q_st.rounds, q_st.n_rr_sampled)
    assert 0 < d_st.sampling_steps < q_st.sampling_steps


def test_dense_solver_bitset_selection_equals_queue_fused():
    tg = _graphs("er")[0]
    d = IMMSolver(tg, engine="dense", batch=64, selection="bitset", seed=1,
                  device=CPU)
    q = IMMSolver(tg, engine="queue", batch=64, selection="fused", seed=1,
                  device=CPU)
    rd, rq = d.solve(IMProblem(k=4, eps=0.5)), q.solve(IMProblem(k=4, eps=0.5))
    np.testing.assert_array_equal(rd.seeds, rq.seeds)
    np.testing.assert_array_equal(rd.gains, rq.gains)
    assert rd.frac == rq.frac and d.store.n_elems == q.store.n_elems


# ------------------------------------------------------------ distribution

def _dense_sets(g_rev, count, batch=64):
    eng = make_engine("dense", g_rev, batch=batch)
    sets, t = [], 0
    while len(sets) < count:
        b = eng.sample(round_seed(1, t))
        t += 1
        sets += [b.nodes[i, :int(b.lengths[i])].tolist()
                 for i in range(b.n_sets)]
    return sets[:count]


def _oracle_sets(jg_rev, count, seed):
    rng = np.random.default_rng(seed)
    offs, idx, w = (np.asarray(a) for a in jg_rev)
    n = jg_rev.n_nodes
    return [oracle.rr_set_ic(offs, idx, w, int(rng.integers(n)), rng)
            for _ in range(count)]


def _reference_dense_sets(jg_rev, count, batch=64):
    eng = jmake_engine("dense", jg_rev, batch=batch)
    sets, t = [], 0
    while len(sets) < count:
        b = eng.sample(jax.random.key(500 + t))
        t += 1
        nodes, lens = np.asarray(b.nodes), np.asarray(b.lengths)
        sets += [nodes[i, :lens[i]].tolist() for i in range(len(lens))]
    return sets[:count]


def _hits(sets, n):
    h = np.zeros(n)
    for s in sets:
        h[s] += 1
    return h / len(sets)


@pytest.mark.parametrize("against", ["oracle", "reference_dense"])
@pytest.mark.parametrize("kind", ["er", "ba"])
def test_dense_engine_law_matches(kind, against):
    """KS on RR-set sizes (p > 0.01) and every node's hit frequency within
    5 sigma, against the serial oracle and the reference's dense engine."""
    tg, jg, _ = _graphs(kind)
    t_rev, j_rev = tcsr.reverse(tg), jcsr.reverse(jg)
    count = 2048
    port = _dense_sets(t_rev, count)
    other = (_oracle_sets(j_rev, count, seed=31) if against == "oracle"
             else _reference_dense_sets(j_rev, count, batch=256))
    res = sps.ks_2samp([len(s) for s in port], [len(s) for s in other])
    assert res.pvalue > P_MIN, res
    p1, p2 = _hits(port, tg.n_nodes), _hits(other, tg.n_nodes)
    pool = (p1 + p2) / 2
    se = np.sqrt(np.maximum(pool * (1 - pool), 1e-12) * (2.0 / count))
    assert (np.abs(p1 - p2) <= SIGMA * se + 1e-12).all(), \
        (np.abs(p1 - p2) / se).max()
