"""The padded-store greedy of the torch port against the JAX reference.

``build_padded_store`` and ``select_seeds_padded`` must give the
reference's arrays and its seeds, gains and ``frac`` bytes exactly, and the
membership scan (the plain version on the CPU) must equal the reference's
Pallas kernel in interpret mode and its jnp oracle on every sweep case.
On a JAX-sampled queue pool the padded greedy must also equal the port's
``flat`` and ``bitset`` selections.

The greedy's plain loop (``ref.padded_greedy_ref``, ``ops.padded_greedy``
on CPU tensors) must equal the reference's ``select_seeds_padded`` exactly,
with repeated nodes in a row, k past the distinct nodes, and valid lanes
outside [0, n) (dropped, or wrapped when negative, as the reference's
scatter-add does).  The CUDA kernel (``csrc/membership.cu``) cannot run
here, so a numpy replay of its design (a shared Occur, rows and nodes
split over 1, 3 or 132 blocks, every lane of a new row taken off at its
node) is held against the plain loop exactly.
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

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

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


# ------------------------------------------- the padded greedy as one call

def _repeat_lists(seed, n, count, hi=9):
    """Lists that may hold a node more than once (Occur counts lanes, a
    step's gain counts rows)."""
    rng = np.random.default_rng(seed)
    lists = [rng.integers(0, n, int(rng.integers(0, hi))).tolist()
             for _ in range(count)]
    lists[1] = [3, 3, 3, 1]
    return lists


PADDED_CASES = [
    (_random_lists(0, 60, 400), 60, 5),
    (_random_lists(4, 60, 400), 60, 30),
    (_random_lists(5, 500, 300), 500, 12),
    (_repeat_lists(6, 12, 500), 12, 20),         # k above the 12 nodes
    (_repeat_lists(7, 40, 300, hi=30), 40, 45),
    ([[0, 1], [], [1, 2, 5], [3], []] * 30, 6, 8),
]


@pytest.mark.parametrize("case", range(len(PADDED_CASES)))
def test_padded_greedy_plain_equals_reference(case):
    """``ref.padded_greedy_ref`` and ``ops.padded_greedy`` on CPU tensors
    against the reference's ``select_seeds_padded`` (seeds and gains
    exactly); the port's selection also in the float32 bytes of frac."""
    lists, n, k = PADDED_CASES[case]
    jstore = jcov.build_padded_store(lists, n)
    want = jcov.select_seeds_padded(jstore, k)
    store = tcov.build_padded_store(lists, n, device=CPU)
    tops.reset_launch_counts()
    for seeds, gains in (
            tref.padded_greedy_ref(store.rows, store.lengths, n=n, k=k),
            tops.padded_greedy(store.rows, store.lengths, n=n, k=k)):
        np.testing.assert_array_equal(seeds.numpy(), np.asarray(want.seeds))
        np.testing.assert_array_equal(gains.numpy(), np.asarray(want.gains))
        assert seeds.dtype == gains.dtype == torch.int32
    _assert_result_equal(tcov.select_seeds_padded(store, k), want)
    assert not any(tops.launch_counts().values())


# a lane outside the nodes at n = 6: -1 wraps to slot n (the padding) and
# is dropped, n + 1 and 1 << 20 are dropped, -2 and -(n + 1) wrap to nodes
# n - 1 and 0, and -(n + 2) is dropped
OUTSIDE_N = 6
OUTSIDE_LANES = [-1, OUTSIDE_N + 1, 1 << 20, -2, -(OUTSIDE_N + 1),
                 -(OUTSIDE_N + 2)]


def outside_rows(lane):
    """Rows of :data:`OUTSIDE_N` nodes with ``lane`` in three of them, and
    two sets of lengths: the lane inside each of those rows' length, and
    past it."""
    rows = [[0, 1, lane, 2], [2, 5, lane, 6], [1, 2, 6, 6], [5, lane, 3, 6],
            [4, 5, 6, 6]]
    return rows, ([3, 3, 2, 3, 2], [2, 2, 2, 1, 2])


@pytest.mark.parametrize("lane", OUTSIDE_LANES)
def test_padded_selection_raises_on_a_lane_outside_the_nodes(lane):
    """The selection no longer raises on a valid lane outside [0, n): the
    lane counts as the reference's dropping scatter-add counts it (wrapped
    when negative, else for no node) and never matches a seed.  The plain
    loop, ``ops.padded_greedy`` and the selection equal the reference's
    ``select_seeds_padded`` on the same rows (seeds, gains, ``frac``
    bytes), the lane inside and past a row's length."""
    rows, lengths = outside_rows(lane)
    n, k = OUTSIDE_N, 4
    for lens in lengths:
        jstore = jcov.PaddedStore(rows=jnp.asarray(rows, jnp.int32),
                                  lengths=jnp.asarray(lens, jnp.int32),
                                  n_nodes=n)
        want = jcov.select_seeds_padded(jstore, k)
        store = tcov.PaddedStore(
            rows=torch.tensor(rows, dtype=torch.int32),
            lengths=torch.tensor(lens, dtype=torch.int32), n_nodes=n)
        for seeds, gains in (
                tref.padded_greedy_ref(store.rows, store.lengths, n=n, k=k),
                tops.padded_greedy(store.rows, store.lengths, n=n, k=k)):
            np.testing.assert_array_equal(seeds.numpy(),
                                          np.asarray(want.seeds))
            np.testing.assert_array_equal(gains.numpy(),
                                          np.asarray(want.gains))
        _assert_result_equal(tcov.select_seeds_padded(store, k), want)


def _greedy_replay(rows, lengths, n, k, blocks):
    """csrc/membership.cu's padded_greedy_kernel in numpy: Occur shared,
    block b owning the rows [b * rpb, (b + 1) * rpb) and the nodes [b *
    slots, (b + 1) * slots).  A step: each block's first maximum of its
    slice as the key (occur << 32) | (0xFFFFFFFF - v), the maximum of the
    keys; each block scans its uncovered rows for u (the lanes as they
    are), covers the rows that hold it, counts them into the gain, and
    takes all their lanes off Occur, each at its ``lane_node``."""
    r, l = rows.shape
    lens = np.clip(lengths.astype(np.int64), 0, l)
    slots, rpb = -(-n // blocks), -(-r // blocks)

    def lane_node(x):
        v = int(x) + n + 1 if x < 0 else int(x)
        return v if 0 <= v < n else -1

    occur = np.zeros(n, np.int64)
    for i in range(r):
        for x in rows[i, :lens[i]]:
            if lane_node(x) >= 0:
                occur[lane_node(x)] += 1
    covered = np.zeros(r, bool)
    seeds, gains = [], []
    for _ in range(k):
        keys = []
        for blk in range(blocks):
            lo, hi = min(blk * slots, n), min((blk + 1) * slots, n)
            key = 0
            for v in range(lo, hi):
                key = max(key, (int(occur[v]) << 32) | (0xFFFFFFFF - v))
            keys.append(key)
        u = 0xFFFFFFFF - (max(keys) & 0xFFFFFFFF)
        gain = 0
        for blk in range(blocks):
            for i in range(min(blk * rpb, r), min((blk + 1) * rpb, r)):
                row = rows[i, :lens[i]]
                if covered[i] or not (row == u).any():
                    continue
                covered[i] = True
                gain += 1
                for x in row:
                    if lane_node(x) >= 0:
                        occur[lane_node(x)] -= 1
        seeds.append(u)
        gains.append(gain)
    return seeds, gains


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("case", [0, 3, 5])
def test_padded_greedy_replay_equals_plain(case, blocks):
    """The kernel's design (a shared Occur, a block's rows and node slice,
    every lane of a new row taken off at its node) gives the plain loop's
    seeds and gains, with repeated nodes and once Occur is zero."""
    lists, n, k = PADDED_CASES[case]
    store = tcov.build_padded_store(lists, n, device=CPU)
    want = tref.padded_greedy_ref(store.rows, store.lengths, n=n, k=k)
    got = _greedy_replay(store.rows.numpy(), store.lengths.numpy(), n, k,
                         blocks)
    assert got == (want[0].tolist(), want[1].tolist())


@pytest.mark.parametrize("lane", OUTSIDE_LANES)
def test_padded_greedy_replay_with_lanes_outside_the_nodes(lane):
    """The kernel's replay at 1 and 3 blocks gives the plain loop's seeds
    and gains on rows with a lane outside the nodes, inside and past the
    rows' lengths."""
    rows, lengths = outside_rows(lane)
    rows = np.asarray(rows, np.int32)
    for lens in lengths:
        lens = np.asarray(lens, np.int32)
        want = tref.padded_greedy_ref(torch.from_numpy(rows),
                                      torch.from_numpy(lens), n=OUTSIDE_N,
                                      k=4)
        for blocks in (1, 3):
            assert _greedy_replay(rows, lens, OUTSIDE_N, 4, blocks) == (
                want[0].tolist(), want[1].tolist())
