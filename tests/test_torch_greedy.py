"""The fused greedy max-coverage of the flat pool (``kernels/greedy.py``,
``csrc/greedy.cu``) on the CPU, against the JAX reference.

Both stores receive the same batches (the reference's RRBatches, or random
ones, carried over as numpy).  ``ref.greedy_flat_ref``,
``ops.greedy_flat`` on CPU tensors and the port's ``flat`` selection must
equal the reference's fused scan (``select_seeds_device`` with
``method="flat"``, which runs ``fused``) in seeds, gains and the float32
bytes of ``frac``.  The kernel cannot run here, so its pieces are held
against numpy and the plain version: the plain index (``ref.flat_index``),
the index the launch builds (row starts by a binary search, counts, each
block's scan, the scatter in a drawn order), the argmax by 64-bit keys as
the kernel reduces them (threads, warps, each block's slice, then the
exchange of the blocks' records), the warp's walk of new rows' elements,
and a numpy replay of the kernel's steps.
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
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import greedy as tgreedy

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
THREADS = tgreedy.THREADS
KWALK = 4             # csrc/greedy.cu's kWalk: positions a lane a pass


def _random_batch(rng, n, count, max_len=12):
    """Padded batch with empty rows and bit-31 ids (n > 32)."""
    lens = rng.integers(0, max_len, count)
    nodes = np.full((count, max(int(lens.max()), 1)), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    return nodes, lens


def _jax_batches(n=400, rounds=((64, 3), (160, 2), (32, 4))):
    """Batches sampled by the reference's queue engine, at a width that
    takes the plain append and one that takes the packed append."""
    src, dst = jgen.barabasi_albert(n, 3, seed=2)
    g_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(src, dst, n)))
    out, key = [], jax.random.key(11)
    for batch, count in rounds:
        eng = make_engine("queue", g_rev, batch=batch)
        for _ in range(count):
            key, sub = jax.random.split(key)
            b = eng.sample(sub)
            out.append((np.asarray(b.nodes), np.asarray(b.lengths)))
    return out


def _pool(name):
    """(n, batches): ``jax`` the reference's sampled pool (n = 400, the
    buffers grow past 4,096); ``ragged`` random batches with empty rows
    that grow the buffers, n = 97; ``small`` one batch of 45 rows, n = 70
    (neither n nor the row count a multiple of 32)."""
    if name == "jax":
        return 400, _jax_batches()
    rng = np.random.default_rng(3)
    if name == "ragged":
        return 97, [_random_batch(rng, 97, int(rng.integers(1, 900)))
                    for _ in range(12)]
    return 70, [_random_batch(rng, 70, 45, max_len=9)]


@pytest.fixture(scope="module")
def stores():
    """name -> (reference store, port store on the CPU), built once."""
    out = {}
    for name in ("jax", "ragged", "small"):
        n, batches = _pool(name)
        jref = jcov.ShardedDeviceRRStore(n)
        port = tcov.DeviceRRStore(n, device=CPU)
        for nodes, lens in batches:
            jref.append_batch((nodes, lens))
            port.append_batch(convert.batch_from_arrays(
                nodes, lens, np.zeros(len(lens), bool), 0, device=CPU))
        out[name] = (jref, port)
    return out


def _pool_args(port):
    t = port.n_elems
    return (port.flat[:t], port.ids[:t], port.valid[:t]), dict(
        n=port.n_nodes, num_rows=port.row_capacity())


def _k(port, which):
    """k = 1, 50, or past the last positive gain (seeds repeat at 0)."""
    return {"1": 1, "50": 50, "past": port.n_nodes + 3}[which]


def test_pools_cover_the_cases(stores):
    jref, port = stores["jax"]
    assert port.capacity > 4096                              # grown
    _, port = stores["ragged"]
    assert port.capacity > 4096
    empties = sum(int((l == 0).sum()) for _, l in _pool("ragged")[1])
    assert empties > 0
    for name in ("ragged", "small"):
        _, port = stores[name]
        assert port.n_nodes % 32 and port.n_rr % 32, name


@pytest.mark.parametrize("which", ["1", "50", "past"])
@pytest.mark.parametrize("name", ["jax", "ragged", "small"])
def test_greedy_flat_equals_reference_fused(stores, name, which):
    jref, port = stores[name]
    k = _k(port, which)
    ws, wg, wf = (np.asarray(x) for x in
                  jcov.select_seeds_device(jref, k, method="flat"))
    args, kw = _pool_args(port)
    ops.reset_launch_counts()
    for seeds, gains in (ref.greedy_flat_ref(*args, **kw, k=k),
                         ops.greedy_flat(*args, **kw, k=k)):
        assert seeds.dtype == gains.dtype == torch.int32
        np.testing.assert_array_equal(seeds.numpy(), ws)
        np.testing.assert_array_equal(gains.numpy(), wg)
    got = port.select(k, method="flat")
    np.testing.assert_array_equal(got.seeds.numpy(), ws)
    np.testing.assert_array_equal(got.gains.numpy(), wg)
    assert got.frac.dtype == torch.float32
    assert got.frac.numpy().tobytes() == wf.tobytes()
    assert not any(ops.launch_counts().values())      # plain version on CPU
    if which == "past":                               # Occur ran out
        assert wg[-1] == 0 and ws[-1] == 0
        assert len(set(ws.tolist())) < k


def _numpy_index(flat, ids, valid, n, num_rows):
    flat, ids, valid = (x.numpy() for x in (flat, ids, valid))
    row_start = np.searchsorted(ids, np.arange(num_rows + 1), side="left")
    node = np.where(valid, flat, n)
    order = np.argsort(node, kind="stable")
    inv_start = np.searchsorted(node[order], np.arange(n + 1), side="left")
    return node, row_start, inv_start, ids[order]


def _with_invalid(port, seed=5):
    """The pool with about a tenth of its elements marked invalid."""
    (flat, ids, valid), kw = _pool_args(port)
    rng = np.random.default_rng(seed)
    drop = torch.from_numpy(rng.random(flat.shape[0]) < 0.1)
    return (flat, ids, valid & ~drop), kw


@pytest.mark.parametrize("invalid", [False, True], ids=["valid", "invalid"])
@pytest.mark.parametrize("name", ["jax", "ragged", "small"])
def test_flat_index_equals_numpy(stores, name, invalid):
    _, port = stores[name]
    args, kw = _with_invalid(port) if invalid else _pool_args(port)
    idx = ref.flat_index(*args, **kw)
    want = _numpy_index(*args, kw["n"], kw["num_rows"])
    for got, w, what in zip(idx, want, ref.FlatIndex._fields):
        assert got.dtype == torch.int32, what
        np.testing.assert_array_equal(got.numpy(), w, err_msg=what)
    flat, _, valid = args
    occur0 = torch.zeros(kw["n"] + 1, dtype=torch.int32).index_add_(
        0, flat.long(), valid.to(torch.int32))[:kw["n"]]
    assert torch.equal(idx.inv_start[1:] - idx.inv_start[:-1], occur0)
    assert int(idx.inv_start[-1]) == int(valid.sum())


def _redux_max_key(occ, low):
    """Two redux.sync maxima over the last axis (the largest occ, then the
    largest low among the entries that hold it) -> key."""
    best = occ.max(axis=-1)
    first = np.where(occ == best[..., None], low, 0).max(axis=-1)
    return (best << 32) | first


def _slices(n, blocks):
    """The kernel's node slices: block b owns [lo[b], lo[b] + held[b]) of
    ceil(n / blocks) nodes (none past n).  Returns (slots, lo, held)."""
    slots = -(-n // blocks)
    lo = np.minimum(np.arange(blocks, dtype=np.int64) * slots, n)
    return slots, lo, np.minimum(lo + slots, n) - lo


def block_occur(occur, blocks):
    """Each block's Occur as the kernel holds it: (blocks, slots), block
    b's node lo[b] + j at (b, j), zero past its slice."""
    slots, lo, held = _slices(occur.shape[0], blocks)
    occ = np.zeros((blocks, slots), np.int64)
    for b in range(blocks):
        occ[b, :held[b]] = occur[lo[b]:lo[b] + held[b]]
    return occ


def block_keys(occ, lo, held):
    """Each block's key from its (blocks, slots) Occur, as the kernel's
    slice_argmax reduces it: thread i folds j = i, i + THREADS, ... below
    held keeping the first maximum, then warps and the block reduce (occ,
    low = 0xFFFFFFFF - v) pairs by two maxima (0 for no node)."""
    blocks, slots = occ.shape
    width = max(1, -(-slots // THREADS)) * THREADS
    o = np.zeros((blocks, width), np.int64)
    o[:, :slots] = occ
    j = np.arange(width)[None, :]
    low = np.where(j < held[:, None], 0xFFFFFFFF - (lo[:, None] + j), 0)
    o = o.reshape(blocks, -1, THREADS)
    low = low.reshape(blocks, -1, THREADS)
    t_occ, t_low = o[:, 0].copy(), low[:, 0].copy()
    for p in range(1, o.shape[1]):
        take = (low[:, p] != 0) & ((t_low == 0) | (o[:, p] > t_occ))
        t_occ = np.where(take, o[:, p], t_occ)
        t_low = np.where(take, low[:, p], t_low)
    warp = _redux_max_key(t_occ.reshape(blocks, THREADS // 32, 32),
                          t_low.reshape(blocks, THREADS // 32, 32))
    return _redux_max_key(warp >> 32, warp & 0xFFFFFFFF)


def _exchange(keys):
    """The step's exchange: every block's record read, reduced by the same
    two maxima over the keys (records with key 0 take no part) -> (the
    winning block, u, gain)."""
    best = _redux_max_key(keys >> 32, keys & 0xFFFFFFFF)[()]
    assert best != 0 and (keys == best).sum() == 1
    return int(np.argmax(keys == best)), 0xFFFFFFFF - (best & 0xFFFFFFFF), \
        best >> 32


def kernel_argmax(occur, blocks):
    """The kernel's argmax of ``occur`` on ``blocks`` blocks of THREADS:
    each block reduces its own slice (:func:`block_keys`), then the
    exchange of the blocks' records (:func:`_exchange`).  Returns (u,
    occur[u])."""
    _, lo, held = _slices(occur.shape[0], blocks)
    _, u, gain = _exchange(block_keys(block_occur(occur, blocks), lo, held))
    return u, gain


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("case", ["ties", "zeros", "last", "int32_max",
                                  "tiny"])
def test_key_argmax_is_torch_first_maximum(case, blocks):
    rng = np.random.default_rng(len(case) * 7 + blocks)
    n = {"tiny": 5}.get(case, 75_879 if blocks == 132 else 3_001)
    occur = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    if case == "zeros":
        occur.zero_()
    elif case == "last":
        occur[-1] = 7
    elif case == "int32_max":
        occur[rng.choice(n, 3, replace=False)] = 2 ** 31 - 1
    u, occ = kernel_argmax(occur.numpy(), blocks)
    assert u == int(torch.argmax(occur)) and occ == int(occur[u])
    if case == "ties":
        assert int((occur == occur.max()).sum()) > 1
    if case == "last":
        assert u == n - 1
    if case == "zeros":
        assert u == 0 and occ == 0


def search_rows(ids, num_rows):
    """Phase A's binary search for every row at once: row_start[r] is the
    first index of ids whose value is >= r (t when none)."""
    r = np.arange(num_rows + 1, dtype=np.int64)
    lo, hi = np.zeros_like(r), np.full_like(r, ids.shape[0])
    while (lo < hi).any():
        live = lo < hi
        mid = (lo + hi) >> 1
        below = ids[np.minimum(mid, ids.shape[0] - 1)] < r
        lo = np.where(live & below, mid + 1, lo)
        hi = np.where(live & ~below, mid, hi)
    return lo


def warp_run(lens):
    """The cover's walk of one warp's new rows: lens (..., 32) -> for each
    position p of the run (0 <= p < total; the kernel takes them KWALK x
    32 a pass, which changes no result) the lane j that holds it, found as
    the kernel does (five halvings over the lanes' inclusive sums), and
    its offset p - excl[j] in lane j's row.  Returns (j, offset, live),
    each (..., P) with P the run's passes times 32."""
    incl = np.cumsum(lens, axis=-1)
    total = incl[..., -1:]
    width = max(32, -(-int(total.max()) // 32) * 32)
    p = np.broadcast_to(np.arange(width), lens.shape[:-1] + (width,))
    j = np.zeros(p.shape, np.int64)
    for half in (16, 8, 4, 2, 1):
        c = np.take_along_axis(incl, j + half - 1, axis=-1)
        j = j + np.where(c <= p, half, 0)
    excl = np.take_along_axis(incl - lens, j, axis=-1)
    return j, p - excl, p < total


@pytest.mark.parametrize("case", ["random", "zeros", "one_long", "ends"])
def test_warp_run_finds_each_elements_row(case):
    rng = np.random.default_rng(len(case))
    lens = rng.integers(0, 9, (64, 32))
    if case == "zeros":
        lens[:] = 0
    elif case == "one_long":
        lens[:] = 0
        lens[np.arange(64), rng.integers(0, 32, 64)] = rng.integers(
            1, 300, 64)
    elif case == "ends":
        lens[:, 1:-1] = 0
    j, off, live = warp_run(lens)
    for w in range(lens.shape[0]):
        want = [(lane, o) for lane in range(32) for o in range(lens[w, lane])]
        got = list(zip(j[w][live[w]].tolist(), off[w][live[w]].tolist()))
        assert got == want


def kernel_index(flat, ids, valid, *, n, num_rows, blocks, seed):
    """Phases A-D of the kernel: row_start by the binary search; nodes
    (the counted node or -1) and count by node; each block's slice scanned
    in THREADS shares (a thread's run of ``per`` nodes, an exclusive sum
    over the threads) into its list starts (and cursor) and the block's
    sum; every block's base summed from the block sums; the counted
    elements' entries (the row and its span of elements) scattered to
    base + cursor[v]++ in an order drawn from ``seed`` (the atomics' order
    is the card's).  Returns (nodes, count, base, starts, inv_rows,
    inv_span), starts (blocks, slots + 1) each block's list starts and its
    total after its last node."""
    flat, ids, valid = (x.numpy().astype(np.int64) for x in (flat, ids,
                                                              valid))
    row_start = search_rows(ids, num_rows)
    counted = (valid != 0) & (flat < n)
    nodes = np.where(counted, flat, -1)
    count = np.bincount(flat[counted], minlength=n).astype(np.int64)
    slots, lo, held = _slices(n, blocks)
    starts = np.zeros((blocks, slots + 1), np.int64)
    cursor = np.zeros(n, np.int64)
    block_sum = np.zeros(blocks, np.int64)
    for b in range(blocks):
        seg = count[lo[b]:lo[b] + held[b]]
        per = -(-seg.shape[0] // THREADS)
        shares = np.zeros(THREADS * max(per, 1), np.int64)
        shares[:seg.shape[0]] = seg
        shares = shares.reshape(THREADS, -1)
        thread_sum = shares.sum(axis=1)
        run = np.cumsum(thread_sum) - thread_sum
        within = np.cumsum(shares, axis=1) - shares + run[:, None]
        starts[b, :held[b]] = within.reshape(-1)[:seg.shape[0]]
        starts[b, held[b]] = block_sum[b] = thread_sum.sum()
        cursor[lo[b]:lo[b] + held[b]] = starts[b, :held[b]]
    base = np.cumsum(block_sum) - block_sum
    rng = np.random.default_rng(seed)
    elems = np.flatnonzero(counted)[rng.permutation(int(counted.sum()))]
    v = flat[elems]
    order = np.argsort(v, kind="stable")
    rank = np.empty_like(v)
    rank[order] = np.arange(v.shape[0]) - np.searchsorted(v[order],
                                                          v[order])
    pos = base[v // slots] + cursor[v] + rank
    assert np.array_equal(np.sort(pos), np.arange(v.shape[0]))
    inv_rows = np.zeros(flat.shape[0], np.int64)
    inv_span = np.zeros((flat.shape[0], 2), np.int64)
    inv_rows[pos] = ids[elems]
    inv_span[pos, 0] = row_start[ids[elems]]
    inv_span[pos, 1] = row_start[ids[elems] + 1]
    return nodes, count, base, starts, inv_rows, inv_span


def kernel_replay(flat, ids, valid, *, n, num_rows, k, blocks, seed=0):
    """The kernel's steps in numpy, from its own index
    (:func:`kernel_index`): each block keeps its slice of Occur and its
    own Covered; each step every block publishes its key and its node's
    list span (base + its list starts), and the exchange of those records
    (:func:`_exchange`) gives every block u, its gain and its span; then,
    but at the last step, every block walks all of u's entries 32 a warp,
    tests and sets each row in its own Covered, lays the new rows'
    elements end to end by the entries' spans (:func:`warp_run`) and
    takes one off its Occur at the nodes in its slice but u, whose count
    u's block sets to 0.  The copies of Covered must stay equal."""
    nodes, count, base, starts, inv_rows, inv_span = kernel_index(
        flat, ids, valid, n=n, num_rows=num_rows, blocks=blocks, seed=seed)
    slots, lo, held = _slices(n, blocks)
    occ = block_occur(count, blocks)
    cov = np.zeros((blocks, -(-num_rows // 32) * 32), bool)
    b_idx = np.arange(blocks)[:, None]
    seeds, gains = [], []
    for s in range(k):
        keys = block_keys(occ, lo, held)
        j = np.where(keys != 0, 0xFFFFFFFF - (keys & 0xFFFFFFFF) - lo, 0)
        begin = base + starts[np.arange(blocks), j]
        end = base + starts[np.arange(blocks), j + 1]
        win, u, gain = _exchange(keys)
        seeds.append(u)
        gains.append(gain)
        if s + 1 == k:
            break
        assert end[win] - begin[win] == count[u]
        for i0 in range(begin[win], end[win], 32):
            at = slice(i0, min(i0 + 32, end[win]))
            rows, span = inv_rows[at], inv_span[at]
            fresh = ~cov[:, rows]
            cov[:, rows] = True
            lens = np.zeros((blocks, 32), np.int64)
            lens[:, :rows.shape[0]] = np.where(fresh, span[:, 1] - span[:, 0],
                                               0)
            e0 = np.zeros(32, np.int64)
            e0[:rows.shape[0]] = span[:, 0]
            jj, off, live = warp_run(lens)
            v = np.where(live, nodes[np.where(live, e0[jj] + off, 0)], -1)
            ours = (v >= lo[:, None]) & (v < (lo + held)[:, None]) & (v != u)
            bb = np.broadcast_to(b_idx, v.shape)
            np.subtract.at(occ, (bb[ours], (v - lo[:, None])[ours]), 1)
        occ[u // slots, u - lo[u // slots]] = 0
        assert occ.min() >= 0
    assert (cov == cov[:1]).all()
    return (torch.tensor(seeds, dtype=torch.int32),
            torch.tensor(gains, dtype=torch.int32))


@pytest.mark.parametrize("invalid", [False, True], ids=["valid", "invalid"])
@pytest.mark.parametrize("width", ["capacity", "wider"])
@pytest.mark.parametrize("name", ["jax", "ragged", "small"])
def test_row_start_search_equals_flat_index(stores, name, width, invalid):
    """Phase A's binary search gives ``ref.flat_index``'s row starts, also
    past the pool's rows (num_rows four times the row capacity)."""
    _, port = stores[name]
    args, kw = _with_invalid(port) if invalid else _pool_args(port)
    if width == "wider":
        kw = dict(kw, num_rows=4 * kw["num_rows"])
    want = ref.flat_index(*args, **kw).row_start.numpy()
    got = search_rows(args[1].numpy().astype(np.int64), kw["num_rows"])
    np.testing.assert_array_equal(got, want)
    assert got[-1] == args[0].shape[0]


@pytest.mark.parametrize("blocks", [1, 132, 1000])
@pytest.mark.parametrize("name,invalid", [("jax", False), ("ragged", True)])
def test_kernel_index_lists_flat_indexs_rows(stores, name, invalid, blocks):
    """The index built in the launch holds each node's rows, as
    ``ref.flat_index`` does, in an order that the scatter's atomics set,
    each entry with its row's span; a node's span is its block's base plus
    its list starts; nodes holds the counted nodes."""
    _, port = stores[name]
    args, kw = _with_invalid(port) if invalid else _pool_args(port)
    want = ref.flat_index(*args, **kw)
    nodes, count, base, starts, inv_rows, inv_span = kernel_index(
        *args, **kw, blocks=blocks, seed=blocks)
    flat, _, valid = args
    np.testing.assert_array_equal(
        nodes, np.where(valid.numpy(), flat.numpy(), -1))
    np.testing.assert_array_equal(
        count, (want.inv_start[1:] - want.inv_start[:-1]).numpy())
    slots, lo, _ = _slices(kw["n"], blocks)
    for v in range(kw["n"]):
        b, j = v // slots, v - lo[v // slots]
        at = slice(base[b] + starts[b, j], base[b] + starts[b, j + 1])
        order = np.argsort(inv_rows[at])
        a, e = int(want.inv_start[v]), int(want.inv_start[v + 1])
        rows = want.inv_rows[a:e].numpy()
        np.testing.assert_array_equal(inv_rows[at][order], rows)
        spans = inv_span[at][order]
        np.testing.assert_array_equal(spans[:, 0], want.row_start[rows])
        np.testing.assert_array_equal(spans[:, 1], want.row_start[rows + 1])


@pytest.mark.parametrize("which", ["50", "past"])
@pytest.mark.parametrize("blocks", [1, 132, 1000])
@pytest.mark.parametrize("name,invalid", [("jax", False), ("ragged", False),
                                          ("small", False), ("ragged", True)])
def test_kernel_replay_equals_plain(stores, name, invalid, blocks, which):
    """The replay equals the plain version on every pool, at one block, a
    block an SM of the H100, and 1,000 blocks (more than n on every pool:
    blocks with no node), at k = 50 (or n + 3 on the small pool) and past
    the last positive gain, where seed 0 repeats."""
    _, port = stores[name]
    args, kw = _with_invalid(port) if invalid else _pool_args(port)
    k = port.n_nodes + 3 if which == "past" or name == "small" \
        else min(50, port.n_nodes + 3)
    want = ref.greedy_flat_ref(*args, **kw, k=k)
    got = kernel_replay(*args, **kw, k=k, blocks=blocks, seed=blocks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if which == "past":
        assert int(got[1][-1]) == 0 and int(got[0][-1]) == 0


@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_replay_ignores_row_order(stores, seed):
    """Two other scatter orders give the same seeds and gains."""
    _, port = stores["jax"]
    args, kw = _pool_args(port)
    want = ref.greedy_flat_ref(*args, **kw, k=50)
    got = kernel_replay(*args, **kw, k=50, blocks=7, seed=seed)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_flat_layout_and_scratch():
    """The state's place and the scratch size at the shapes the card tests
    use (227 KB of dynamic shared memory less a little static): the
    default solve's pool keeps its state in shared memory, 8,000,000 nodes
    (60,607 a block, 485 KB of starts and Occur) and 2^23 rows (1 MB of
    Covered) do not."""
    shared_bytes = (232_448 - 256) & ~15
    lay = tgreedy.flat_layout(75_879, 16_384, 132, shared_bytes)
    assert lay == (575, 512, True)
    assert tgreedy.flat_scratch_bytes(75_879, 16_384, 35_538, 50, 132,
                                      shared_bytes) == \
        16 * 50 * 132 + 8 * 35_538 + 4 * (2 * 75_879 + 16_385
                                          + 2 * 35_538 + 132)
    big = tgreedy.flat_layout(8_000_000, 64, 132, shared_bytes)
    assert big == (60_607, 2, False)
    assert tgreedy.flat_scratch_bytes(8_000_000, 64, 10, 5, 132,
                                      shared_bytes) == \
        16 * 5 * 132 + 8 * 10 + 4 * (2 * 8_000_000 + 65 + 2 * 10 + 132) \
        + 4 * 132 * (2 * 60_607 + 1 + 2)
    assert not tgreedy.flat_layout(70, 1 << 23, 132, shared_bytes).shared
    edge = 4 * (132 + 2 * 575 + 1 + 512)
    assert tgreedy.flat_layout(75_879, 16_384, 132, edge).shared
    assert not tgreedy.flat_layout(75_879, 16_384, 132, edge - 4).shared


def test_greedy_wrapper_rejects_cpu_tensors_before_building():
    """The CUDA wrapper refuses a CPU pool before it builds anything."""
    flat = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tgreedy.greedy_flat(flat, flat, torch.ones(8, dtype=torch.bool),
                            n=4, num_rows=32, k=2)
    assert tgreedy._GREEDY._fn is None and "greedy" not in _build.PTXAS_REPORT
