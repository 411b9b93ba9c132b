"""The padded-store greedy of the torch port against the JAX reference.

``build_padded_store`` and ``select_seeds_padded`` must give the
reference's arrays and its seeds, gains and ``frac`` bytes exactly, and the
membership scan (the plain version on the CPU) must equal the reference's
Pallas kernel in interpret mode and its jnp oracle on every sweep case.
On a JAX-sampled queue pool the padded greedy must also equal the port's
``flat`` and ``bitset`` selections.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import coverage as jcov
from repro.core.engine import make_engine
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro.kernels import ops as jops, ref as jref
from repro_torch import convert
from repro_torch.core import coverage as tcov
from repro_torch.kernels import membership as tmem
from repro_torch.kernels import ops as tops, ref as tref

CPU = "cpu"


def _random_lists(seed, n, count, lo=1, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.choice(n, size=int(rng.integers(lo, hi)),
                       replace=False).tolist() for _ in range(count)]


def _assert_store_equal(port, ref):
    np.testing.assert_array_equal(port.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(port.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert port.rows.dtype == torch.int32 and port.lengths.dtype == torch.int32
    assert port.n_nodes == ref.n_nodes


def _assert_result_equal(port, ref):
    np.testing.assert_array_equal(port.seeds.numpy(), np.asarray(ref.seeds))
    np.testing.assert_array_equal(port.gains.numpy(), np.asarray(ref.gains))
    assert port.seeds.dtype == port.gains.dtype == torch.int32
    assert port.frac.dtype == torch.float32
    assert port.frac.numpy().tobytes() == np.asarray(ref.frac).tobytes()


@pytest.mark.parametrize("lists,n,kw", [
    (_random_lists(0, 60, 400), 60, {}),
    # empty lists, a count off the row padding, ids past 32 (bit 31 of a
    # packed word elsewhere)
    ([[], [3, 1], [], [59, 0, 33]] + _random_lists(1, 60, 17, lo=0), 60,
     {"pad_rows_to": 16}),
    (_random_lists(2, 300, 50, hi=140), 300, {}),
    (_random_lists(3, 50, 9), 50, {"row_len": 200}),
    ([[]], 5, {}),
], ids=["lists", "empty-lists", "long-rows", "row-len", "one-empty"])
def test_build_padded_store_equals_reference(lists, n, kw):
    _assert_store_equal(tcov.build_padded_store(lists, n, device=CPU, **kw),
                        jcov.build_padded_store(lists, n, **kw))


def test_build_padded_store_row_len_too_small():
    lists = [[0, 1, 2], list(range(130))]
    with pytest.raises(ValueError, match="row_len too small"):
        jcov.build_padded_store(lists, 200, row_len=100)
    with pytest.raises(ValueError, match="row_len too small"):
        tcov.build_padded_store(lists, 200, row_len=100, device=CPU)


@pytest.mark.parametrize("r,l", [(16, 128), (100, 128), (257, 256),
                                 (1024, 512), (7, 384)])
def test_membership_equals_reference(r, l):
    """The reference's sweep (rows in [0, 50), lengths 0..L), then the same
    rows padded with n = 50 past each length and u = n, which no valid lane
    holds: every answer is False."""
    rng = np.random.default_rng(r * 1000 + l)
    rows = rng.integers(0, 50, size=(r, l)).astype(np.int32)
    lens = rng.integers(0, l + 1, size=r).astype(np.int32)
    lens[:2] = [0, l]
    padded = np.where(np.arange(l)[None, :] < lens[:, None], rows, 50)
    for mat, us in ((rows, (0, 7, 49, 1000)), (padded, (0, 7, 49, 50))):
        jr, jl = jnp.asarray(mat), jnp.asarray(lens)
        tr, tl = torch.tensor(mat), torch.tensor(lens)
        for u in us:
            want = np.asarray(jops.membership_rows(jr, jl, u))
            np.testing.assert_array_equal(
                want, np.asarray(jref.membership_rows_ref(jr, jl, u)))
            for tu in (u, torch.tensor(u, dtype=torch.int32),
                       torch.tensor([u])):
                got = tops.membership_rows(tr, tl, tu)
                assert got.dtype == torch.bool and got.shape == (r,)
                np.testing.assert_array_equal(got.numpy(), want)
    got = tops.membership_rows(torch.tensor(padded), torch.tensor(lens), 50)
    assert not got.any()


def test_membership_wrapper_rejects_cpu_tensors_before_building():
    rows = torch.zeros(4, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tmem.membership_rows(rows, torch.zeros(4, dtype=torch.int32), 0)


@pytest.mark.parametrize("seed,n,count,k", [(0, 60, 400, 5), (4, 60, 400, 30),
                                            (5, 500, 300, 12)])
def test_select_seeds_padded_equals_reference(seed, n, count, k):
    """The random lists of the reference's integration test (seed 0), more
    seeds than distinct useful nodes (k = 30: late gains are 0 and the
    argmax ties go to the lowest id), and a wider node space."""
    lists = _random_lists(seed, n, count)
    want = jcov.select_seeds_padded(jcov.build_padded_store(lists, n), k)
    tops.reset_launch_counts()
    got = tcov.select_seeds_padded(
        tcov.build_padded_store(lists, n, device=CPU), k)
    _assert_result_equal(got, want)
    assert not any(tops.launch_counts().values())     # plain version on CPU


def _jax_pool_batches(n=400, batch=128, rounds=3):
    """RR batches of the reference's queue engine on a BA graph."""
    src, dst = jgen.barabasi_albert(n, 3, seed=2)
    g_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(src, dst, n)))
    eng = make_engine("queue", g_rev, batch=batch)
    out, key = [], jax.random.key(7)
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        b = eng.sample(sub)
        out.append((np.asarray(b.nodes), np.asarray(b.lengths)))
    return out


def test_padded_selection_on_jax_pool_equals_reference_and_port_scans():
    n, k = 400, 15
    batches = _jax_pool_batches(n)
    lists = [row[:ln].tolist() for nodes, lens in batches
             for row, ln in zip(nodes, lens) if ln > 0]
    ref_store = jcov.build_padded_store(lists, n)
    store = convert.padded_store_from_arrays(
        np.asarray(ref_store.rows), np.asarray(ref_store.lengths), n,
        device=CPU)
    _assert_store_equal(store, ref_store)
    got = tcov.select_seeds_padded(store, k)
    _assert_result_equal(got, jcov.select_seeds_padded(ref_store, k))
    pool = tcov.DeviceRRStore(n, device=CPU)
    for nodes, lens in batches:
        pool.append_batch(convert.batch_from_arrays(
            nodes, lens, np.zeros(len(lens), bool), 0, device=CPU))
    assert pool.n_rr == len(lists)
    for method in ("flat", "bitset"):
        other = pool.select(k, method=method)
        assert torch.equal(got.seeds, other.seeds), method
        assert torch.equal(got.gains, other.gains), method
        assert got.frac.numpy().tobytes() == other.frac.numpy().tobytes()


@pytest.mark.parametrize("rows,lengths,match", [
    (np.zeros((3, 4), np.int32), np.zeros(2, np.int32), "padded store"),
    (np.full((2, 4), -1, np.int32), np.zeros(2, np.int32), "node ids"),
    (np.full((2, 4), 11, np.int32), np.zeros(2, np.int32), "node ids"),
    (np.zeros((2, 4), np.int32), np.array([1, 5], np.int32), "lengths"),
])
def test_padded_store_from_arrays_rejects_bad_arrays(rows, lengths, match):
    with pytest.raises(ValueError, match=match):
        convert.padded_store_from_arrays(rows, lengths, 10, device=CPU)
