"""The queue sampler's chunk dedup on rows with parallel edges
(``kernels/ref.py::first_occurrence_ref``, ``queue_bfs_ref(dedup=...)``,
``core/rrset.py::sample_rrsets_queue``) against the JAX reference.

* ``first_occurrence_ref`` equals the reference's ``rrset._first_occurrence``
  bit for bit in both modes, on duplicate-heavy chunks (long runs of
  repeated destinations, the reference's own conformance chunks) sorted by
  destination and shuffled, at chunk widths 8, 32 and 128.
* On a destination-sorted multigraph (every third edge repeated twice at
  its own weight) the ``segmented`` and ``sort`` rounds give the same bytes
  at EC 8, 32 and 128, and each RR set is the live-edge reachable set of
  its row seed under the reference's hash, every parallel edge with its
  own trial.
* The RR-set law on the multigraph, sampled as it is, matches the
  coalesced graph's (``coalesce_ic``) and the oracle's ``rr_set_ic`` on the
  multigraph: KS on the sizes (p > 0.01) and 5σ on every node's hit
  frequency, as ``tests/test_conformance.py`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from repro.core import oracle, rrset as jrrset
from repro.kernels.ref import counter_uniform_u32_ref
from repro_torch.core import rrset
from repro_torch.core.engine import make_engine
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
P_MIN = 0.01
SIGMA = 5.0
N = 120


def _adversarial_chunks(rng, b=8, ec=32, n=16):
    """Duplicate-heavy chunks, as tests/test_conformance.py makes them:
    runs of one to five equal destinations, sometimes the same value in
    two runs in a row."""
    reps = []
    for _ in range(b):
        row, v = [], 0
        while len(row) < ec:
            row += [v] * int(rng.integers(1, 6))
            v += int(rng.integers(0, 2))
        reps.append(row[:ec])
    return np.asarray(reps, np.int32) % n, rng.random((b, ec)) < 0.6


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("ec", [8, 32, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_occurrence_equals_reference(seed, ec, order):
    rng = np.random.default_rng(seed)
    nbr, cand = _adversarial_chunks(rng, ec=ec)
    if order == "sorted":
        idx = np.argsort(nbr, axis=1, kind="stable")
    else:
        idx = np.tile(rng.permutation(ec), (nbr.shape[0], 1))
    nbr = np.take_along_axis(nbr, idx, axis=1)
    cand = np.take_along_axis(cand, idx, axis=1)
    ar = jnp.arange(ec, dtype=jnp.int32)
    for mode in ("none", "segmented", "sort"):
        want = np.asarray(jrrset._first_occurrence(
            jnp.asarray(nbr), jnp.asarray(cand), ar, mode=mode))
        got = ref.first_occurrence_ref(torch.from_numpy(nbr),
                                       torch.from_numpy(cand), mode)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)
    with pytest.raises(ValueError, match="unknown dedup"):
        ref.first_occurrence_ref(torch.from_numpy(nbr),
                                 torch.from_numpy(cand), "bogus")


def _edges():
    """A BA(120, 3) graph with WC weights, every third edge repeated twice
    at its own weight: (src, dst, w)."""
    src, dst = generators.barabasi_albert(N, 3, seed=11)
    s, d, w = csr.to_edges(weights.wc_weights(csr.from_edges(
        src, dst, N, device=CPU)))
    rep = np.arange(s.size) % 3 == 0
    cat = np.concatenate
    return cat([s, s[rep], s[rep]]), cat([d, d[rep], d[rep]]), \
        cat([w, w[rep], w[rep]])


def _multigraph():
    s, d, w = _edges()
    return csr.reverse(csr.from_edges(s, d, N, weights=w, device=CPU))


def _live_reachable(offs, idx, w, row_seed, root):
    """Nodes reachable from ``root`` over the edges that are live for
    ``row_seed`` under the reference's hash (a parallel edge is one more
    edge with its own trial)."""
    bits = np.asarray(counter_uniform_u32_ref(
        np.uint32(row_seed), jnp.arange(idx.size, dtype=jnp.uint32)))
    live = bits.astype(np.float32) * np.float32(2.0 ** -32) < w
    seen, stack = {int(root)}, [int(root)]
    while stack:
        u = stack.pop()
        for e in range(offs[u], offs[u + 1]):
            if live[e] and int(idx[e]) not in seen:
                seen.add(int(idx[e]))
                stack.append(int(idx[e]))
    return seen


def test_segmented_equals_sort_and_live_reachability():
    g = _multigraph()
    assert rrset.detect_dedup_mode(g) == "segmented"
    offs, idx, w = g.numpy()
    row = np.diff(offs.astype(np.int64))
    assert row.max() > 128                     # rows span several chunks
    rounds = {}
    for ec in (8, 32, 128):
        for mode in ("segmented", "sort"):
            rounds[ec, mode] = ref.queue_round_ref(
                g.offsets, g.indices, g.weights, 0xBEEF, 64, qcap=N, ec=ec,
                dedup=mode)
    base = rounds[8, "segmented"]
    for (ec, mode), got in rounds.items():
        for i in (0, 1, 2, 4):                 # queue, lengths, over, roots
            assert torch.equal(got[i], base[i]), (ec, mode, i)
        assert torch.equal(got[3], rounds[ec, "segmented"][3])
    seeds = ref.row_seeds(0xBEEF, 64, CPU).numpy()
    queue, lengths, _, _, roots = (x.numpy() for x in base)
    assert lengths.max() > 10
    for b in range(64):
        got = queue[b, :lengths[b]].tolist()
        assert len(set(got)) == len(got) and got[0] == roots[b]
        assert set(got) == _live_reachable(offs, idx, w, seeds[b], roots[b])
    # the sampler detects the mode and takes the same path
    s = rrset.sample_rrsets_queue(g, 64, 0xBEEF, ec=32)
    assert torch.equal(s.lengths, base[1])
    with pytest.raises(ValueError, match="sorted by destination"):
        shuffled = csr.CSRGraph(g.offsets, g.indices.flip(0),
                                g.weights.flip(0))
        rrset.sample_rrsets_queue(shuffled, 8, 1, dedup="segmented")


def _sets_multigraph(count):
    g = _multigraph()
    sets, t = [], 0
    while len(sets) < count:
        sets += rrset.to_lists(rrset.sample_rrsets_queue(
            g, 256, rrset.round_seed(3, t), ec=32))
        t += 1
    return sets[:count]


def _sets_coalesced(count):
    eng = make_engine("queue", _multigraph(), batch=256)
    assert eng.g_rev.n_edges < _multigraph().n_edges
    sets, t = [], 0
    while len(sets) < count:
        b = eng.sample(rrset.round_seed(5, t))
        t += 1
        sets += rrset.to_lists(rrset.QueueSample(
            b.nodes, b.lengths, b.roots, b.overflowed, b.steps))
    return sets[:count]


def _sets_oracle(count):
    g = _multigraph()
    offs, idx, w = g.numpy()
    rng = np.random.default_rng(17)
    return [oracle.rr_set_ic(offs, idx, w, int(rng.integers(N)), rng)
            for _ in range(count)]


@pytest.mark.parametrize("other", ["coalesced", "oracle"])
def test_multigraph_law_matches_coalesced_and_oracle(other):
    t = 2048
    mine = _sets_multigraph(t)
    theirs = (_sets_coalesced if other == "coalesced" else _sets_oracle)(t)
    res = sps.ks_2samp([len(s) for s in mine], [len(s) for s in theirs])
    assert res.pvalue > P_MIN, res
    hits = np.zeros((2, N))
    for i, sets in enumerate((mine, theirs)):
        for s in sets:
            hits[i, s] += 1
    p1, p2 = hits / t
    pool = (p1 + p2) / 2
    se = np.sqrt(np.maximum(pool * (1 - pool), 1e-12) * (2.0 / t))
    z = np.abs(p1 - p2) / se
    assert (np.abs(p1 - p2) <= SIGMA * se + 1e-12).all(), (z.max(), z.argmax())
