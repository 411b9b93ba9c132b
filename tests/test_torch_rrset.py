"""The torch port's queue sampler against the JAX reference's laws.

The port draws from the counter hash, the reference from threefry, so RR
sets are held by distribution: a two-sample KS test on RR-set sizes
(p > 0.01) and a 5-sigma two-sample bound on every node's hit frequency,
both against the serial oracle ``repro.core.oracle.rr_set_ic``, as
``tests/test_conformance.py`` holds the reference's engines.  Exactly: each
RR set equals the set reachable from its root over the live edges that the
reference's own hash (``repro.kernels.ref.counter_uniform_u32_ref``)
defines, whatever the chunk width EC.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import stats as sps

from repro.core import oracle
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro.kernels.ref import counter_uniform_u32_ref
from repro_torch.core import rrset
from repro_torch.core.engine import QueueEngine, RRBatch, make_engine
from repro_torch.graph import csr as tcsr, weights as tw

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
P_MIN = 0.01        # KS acceptance, as test_conformance.py
SIGMA = 5.0         # two-sample bound, as test_conformance.py


def _graphs(kind):
    """(port reverse graph, reference reverse graph) of one topology."""
    if kind == "er":
        (src, dst), n = jgen.erdos_renyi(30, 150, seed=2), 30
    else:
        (src, dst), n = jgen.barabasi_albert(40, 3, seed=7), 40
    tg = tw.wc_weights(tcsr.from_edges(src, dst, n, device=CPU))
    jg = jw.wc_weights(jcsr.from_edges(src, dst, n))
    return tcsr.reverse(tg), jcsr.reverse(jg)


def _port_sets(g_rev, count, batch=64, first_round=0, **opts):
    eng = make_engine("queue", g_rev, batch=batch, **opts)
    sets, t = [], first_round
    while len(sets) < count:
        b = eng.sample(rrset.round_seed(0, t))
        t += 1
        sets += rrset.to_lists(rrset.QueueSample(
            b.nodes, b.lengths, b.roots, b.overflowed, b.steps))
    return sets[:count]


def _oracle_sets(jg_rev, count, seed):
    rng = np.random.default_rng(seed)
    offs, idx, w = (np.asarray(a) for a in jg_rev)
    n = jg_rev.n_nodes
    return [oracle.rr_set_ic(offs, idx, w, int(rng.integers(n)), rng)
            for _ in range(count)]


@pytest.mark.parametrize("kind", ["er", "ba"])
def test_ks_sizes_match_oracle(kind):
    tg_rev, jg_rev = _graphs(kind)
    sizes = [len(s) for s in _port_sets(tg_rev, 320)]
    ref = [len(s) for s in _oracle_sets(jg_rev, 320, seed=1)]
    res = sps.ks_2samp(sizes, ref)
    assert res.pvalue > P_MIN, (res, np.mean(sizes), np.mean(ref))


@pytest.mark.parametrize("kind", ["er", "ba"])
def test_node_hit_frequency_within_5_sigma(kind):
    """Every node's share of RR sets that hold it: port vs oracle within
    5 sigma of the pooled two-sample standard error."""
    tg_rev, jg_rev = _graphs(kind)
    n, t = tg_rev.n_nodes, 2048
    hits_p = np.zeros(n)
    for s in _port_sets(tg_rev, t):
        hits_p[s] += 1
    hits_o = np.zeros(n)
    for s in _oracle_sets(jg_rev, t, seed=901):
        hits_o[s] += 1
    p1, p2 = hits_p / t, hits_o / t
    pool = (p1 + p2) / 2
    se = np.sqrt(np.maximum(pool * (1 - pool), 1e-12) * (2.0 / t))
    z = np.abs(p1 - p2) / se
    assert (np.abs(p1 - p2) <= SIGMA * se + 1e-12).all(), (z.max(), z.argmax())


def _live_reachable(offs, idx, w, row_seed, root):
    """Nodes reachable from ``root`` over the edges that are live for
    ``row_seed`` under the reference's hash."""
    bits = np.asarray(counter_uniform_u32_ref(
        np.uint32(row_seed), jnp.arange(idx.size, dtype=jnp.uint32)))
    live = bits.astype(np.float32) * np.float32(2.0 ** -32) < w
    seen, stack = {int(root)}, [int(root)]
    while stack:
        u = stack.pop()
        for e in range(offs[u], offs[u + 1]):
            v = int(idx[e])
            if live[e] and v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


@pytest.mark.parametrize("ec", [128, 8, 1])
def test_rr_sets_are_live_edge_reachability(ec):
    """Rows, roots and RR sets follow the counter-hash contract exactly:
    row seed = hash(round_seed, r), root = (hash(row_seed, 2^32-1)*n)>>32,
    RR set = live-edge reachability.  Independent of EC."""
    src, dst = jgen.barabasi_albert(300, 3, seed=5)
    g_rev = tcsr.coalesce_ic(tcsr.reverse(tw.wc_weights(
        tcsr.from_edges(src, dst, 300, device=CPU))))
    offs, idx, w = g_rev.numpy()
    assert np.diff(offs).max() > 8                # rows span several chunks
    n, batch, seed32 = 300, 48, 0xC0FFEE
    s = rrset.sample_rrsets_queue(g_rev, batch, seed32, ec=ec)
    row_seed = np.asarray(counter_uniform_u32_ref(
        np.uint32(seed32), jnp.arange(batch, dtype=jnp.uint32))).astype(
        np.int64)
    root_bits = np.asarray(counter_uniform_u32_ref(
        jnp.asarray(row_seed.astype(np.uint32)),
        jnp.full(batch, 0xFFFFFFFF, jnp.uint32))).astype(np.int64)
    roots = (root_bits * n) >> 32
    np.testing.assert_array_equal(s.roots.numpy(), roots)
    assert not s.overflowed.any()
    for r, rr in enumerate(rrset.to_lists(s)):
        assert rr[0] == roots[r]
        assert set(rr) == _live_reachable(offs, idx, w, row_seed[r], roots[r])


def test_rr_sets_independent_of_chunk_width():
    tg_rev, _ = _graphs("ba")
    a = _port_sets(tg_rev, 256, ec=128)
    b = _port_sets(tg_rev, 256, ec=8)
    assert [sorted(x) for x in a] == [sorted(x) for x in b]


def test_batches_meet_rrbatch_invariants_and_are_deterministic():
    tg_rev, _ = _graphs("er")
    eng = QueueEngine(tg_rev, QueueEngine.Config(batch=32))
    b1, b2 = eng.sample(5), eng.sample(5)
    b1.validate(eng.item_space)
    assert b1.nodes.shape[1] == int(b1.lengths.max())
    for x, y in zip(b1[:3] + (b1.roots,), b2[:3] + (b2.roots,)):
        assert torch.equal(x, y)
    assert b1.steps == b2.steps > 0
    assert not torch.equal(b1.roots, eng.sample(6).roots)


def test_overflow_is_flagged_and_truncates():
    tg_rev = tcsr.coalesce_ic(_graphs("ba")[0])
    big = rrset.sample_rrsets_queue(tg_rev, 64, 3)
    small = rrset.sample_rrsets_queue(tg_rev, 64, 3, qcap=2)
    over = big.lengths.numpy() > 2
    assert over.any()
    np.testing.assert_array_equal(small.overflowed.numpy(), over)
    assert (small.lengths.numpy() <= 2).all()
    for full, cut in zip(rrset.to_lists(big), rrset.to_lists(small)):
        assert cut == full[:len(cut)]


def test_parallel_edges_need_coalescing():
    """The sampler serves parallel edges through the chunk dedup, as the
    reference's does (tests/test_torch_dedup.py holds it to the reference);
    the engine coalesces instead."""
    g = tcsr.from_edges([0, 0, 1], [1, 1, 0], 2, weights=[0.5, 0.5, 1.0],
                        device=CPU)
    g_rev = tcsr.reverse(g)
    assert rrset.detect_dedup_mode(g_rev) == "segmented"
    s = rrset.sample_rrsets_queue(g_rev, 64, 0)
    for row in rrset.to_lists(s):
        assert len(set(row)) == len(row) and set(row) <= {0, 1}
    # both parallel edges keep their own trial: 1 - 0.5^2 of the rows
    # rooted at 1 reach 0
    hits = [len(r) == 2 for r in rrset.to_lists(s) if r[0] == 1]
    assert 0 < sum(hits) < len(hits)
    eng = QueueEngine(g_rev)
    assert rrset.detect_dedup_mode(eng.g_rev) == "none"
    assert eng.g_rev.n_edges == 2
    eng.sample(0).validate(2)


def test_validate_catches_broken_batches():
    nodes = torch.tensor([[1, 1], [0, 2]], dtype=torch.int32)
    bad = RRBatch(nodes, torch.tensor([2, 1], dtype=torch.int32),
                  torch.zeros(2, dtype=torch.bool), 1)
    with pytest.raises(ValueError, match="repeats"):
        bad.validate(3)
    with pytest.raises(ValueError, match="leaves"):
        bad._replace(lengths=torch.tensor([1, 2], dtype=torch.int32)).validate(2)
