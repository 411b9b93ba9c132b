"""Device pool and greedy selection of the torch port against the JAX
reference, on the same JAX-sampled pool.

Both stores receive the same batches (the reference's RRBatches turned into
numpy and carried over by ``convert.batch_from_arrays``).  Every check is
exact: the pool buffers, the bit matrix, and the seeds, gains and ``frac``
of the port's ``flat``, ``bitset`` and ``auto`` selections against the
reference's ``fused`` scan.  The reference's own ``bitset``/``auto`` paths
are not used as anchors: under jax 0.9 their ``pallas_call`` inside
``shard_map`` raises (ROADMAP Queue 3 item 1).
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import coverage as jcov
from repro.core.engine import make_engine
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.core import coverage as tcov

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"


def _ref_graph(n=400, r=3, seed=2):
    src, dst = jgen.barabasi_albert(n, r, seed=seed)
    return jw.wc_weights(jcsr.from_edges(src, dst, n))


def _random_batch(rng, n, count, max_len=12):
    """Padded batch with empty rows and bit-31 ids (n > 32)."""
    lens = rng.integers(0, max_len, count)
    nodes = np.full((count, max(int(lens.max()), 1)), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    return nodes, lens


def _both_stores(n, batches):
    ref = jcov.ShardedDeviceRRStore(n)
    port = tcov.DeviceRRStore(n, device=CPU)
    for nodes, lens in batches:
        ref.append_batch((nodes, lens))
        port.append_batch(convert.batch_from_arrays(
            nodes, lens, np.zeros(len(lens), bool), 0, device=CPU))
    return ref, port


def _assert_buffers_equal(ref, port):
    assert port.n_rr == ref.n_rr and port.n_elems == ref.n_elems
    assert port.capacity == ref.capacity
    for t, j in ((port.flat, ref._flat), (port.ids, ref._ids),
                 (port.valid, ref._valid)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[0])


def _jax_pool(n=400, rounds=((64, 3), (160, 2), (32, 4))):
    """Batches sampled by the reference's queue engine at two widths: a
    (64, n) batch goes through the plain rank-scatter append, a (160, n)
    one through the reference's packed append (R*W > 2^15)."""
    g_rev = jcsr.reverse(_ref_graph(n))
    out, key = [], jax.random.key(11)
    for batch, count in rounds:
        eng = make_engine("queue", g_rev, batch=batch)
        for _ in range(count):
            key, sub = jax.random.split(key)
            b = eng.sample(sub)
            out.append((np.asarray(b.nodes), np.asarray(b.lengths)))
    return out


@pytest.fixture(scope="module")
def jax_pool():
    return _jax_pool()


def test_store_buffers_equal_on_jax_sampled_pool(jax_pool):
    ref, port = _both_stores(400, jax_pool)
    assert port.capacity > 4096                  # the pool grew
    _assert_buffers_equal(ref, port)


def test_store_buffers_equal_with_empty_rows_and_growth():
    rng = np.random.default_rng(3)
    n = 97
    batches = [_random_batch(rng, n, int(rng.integers(1, 900)))
               for _ in range(12)]
    ref, port = _both_stores(n, batches)
    _assert_buffers_equal(ref, port)
    assert port.n_rr < sum(len(l) for _, l in batches)   # empties dropped


def test_bitset_matrix_equal(jax_pool):
    ref, port = _both_stores(400, jax_pool)
    want = np.asarray(ref.bitset_matrix())[0].view(np.int32)
    got = port.bitset_matrix().numpy()
    assert got.shape == want.shape == (port.row_capacity(), (400 + 31) // 32)
    assert (got < 0).any()                        # bit 31 present
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 7, 25])
def test_selections_equal_reference_fused(jax_pool, k):
    ref, port = _both_stores(400, jax_pool)
    want = jcov.select_seeds_device(ref, k, method="flat")
    ws, wg, wf = (np.asarray(x) for x in want)
    for method in ("flat", "bitset", "auto"):
        got = port.select(k, method=method)
        np.testing.assert_array_equal(got.seeds.numpy(), ws)
        np.testing.assert_array_equal(got.gains.numpy(), wg)
        assert got.seeds.dtype == torch.int32 and got.gains.dtype == torch.int32
        assert got.frac.dtype == torch.float32
        assert got.frac.numpy().tobytes() == wf.tobytes(), (method, got.frac, wf)


def test_auto_rule_matches_reference_choice():
    """``auto`` reads the same capacity and row bound as the reference, so
    it picks bitset on a small dense pool and flat on a sparse one."""
    rng = np.random.default_rng(4)
    for n, count, max_len in ((64, 40, 30), (3000, 600, 4)):
        _, port = _both_stores(n, [_random_batch(rng, n, count, max_len)])
        words = port.row_capacity() * ((n + 31) // 32)
        picks_bitset = words <= port.capacity
        assert picks_bitset == (n == 64)
        got = port.select(5, method="auto")
        other = port.select(5, method="flat" if picks_bitset else "bitset")
        assert torch.equal(got.seeds, other.seeds)
        assert torch.equal(got.gains, other.gains)


def test_selection_ties_go_to_lowest_id():
    """Equal Occur counts: both scans pick the lowest node id, like the
    reference's argmax."""
    n = 70
    nodes = np.array([[65, 3], [3, 65], [40, 65], [40, 3]])
    lens = np.array([2, 2, 2, 2])
    _, port = _both_stores(n, [(nodes, lens)])
    for method in ("flat", "bitset"):
        res = port.select(2, method=method)
        assert res.seeds.tolist() == [3, 40], method
        assert res.gains.tolist() == [3, 1], method


def test_append_rejects_bad_shapes():
    port = tcov.DeviceRRStore(10, device=CPU)
    with pytest.raises(ValueError):
        port.append_batch((np.zeros(5, np.int64), np.ones(5, np.int64)))
    with pytest.raises(ValueError):
        port.select(1, method="bogus")
