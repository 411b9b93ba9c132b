"""The batch fold of the coverage sketch (``ops.sketch_fold_rows``, the
plain version ``ref.sketch_fold_rows_ref`` on CPU tensors) against the JAX
reference's ``fold_frontier_packed`` and ``fold_batch_packed``.

Inputs come from numpy seeds.  Every comparison is exact: the sketch words
bit for bit (the reference's uint32 words viewed as int32), the counts as
integers.  The cases cover a bucket count off a power of two (96, three
words a row), empty rows in the middle of a batch, lengths below 0 and past
W, node ids at and past R in valid lanes (dropped), a strided view of a
wider queue (the sampler's layout), and row ids that cross 2^32.

The kernel (``csrc/sketch.cu``) cannot run here, so a numpy replay of its
block walk is held against the plain version: blocks of 128 rows, each
block's rank base from the lengths before it, the block's scans of its
rows' flags and lengths, a lane's row by a binary search over the block's
offsets, and the last block's counts.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import coverage as jcov
from repro.core import sketch as jsketch
from repro_torch.core import coverage as tcov
from repro_torch.core import sketch as tsketch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
FOLD_THREADS = 128          # csrc/sketch.cu: kFoldThreads, rows of a block


def _batch(seed, b, w, n, *, extra=5, empty_mid=True):
    """A (B, W) strided view of a (B, W + extra) queue of node ids in [0,
    n + 3) (some at and past R = n + 1), lengths in [-2, W + 2], five empty
    rows mid-batch; as numpy and as the port's view."""
    rng = np.random.default_rng(seed)
    queue = rng.integers(0, n + 3, (b, w + extra)).astype(np.int32)
    lens = rng.integers(-2, w + 3, b).astype(np.int32)
    if empty_mid:
        lens[b // 2: b // 2 + 5] = 0
    view = torch.tensor(queue)[:, :w]
    return np.ascontiguousarray(queue[:, :w]), lens, view


def _words(rng, rows, k):
    return rng.integers(0, 1 << 32, (rows, k // 32),
                        dtype=np.int64).astype(np.uint32)


def _as_int32(base):
    """The reference's int32 row base with the bits of ``base`` mod 2^32
    (its int32 ids wrap, and its bucket casts them to uint32)."""
    return jnp.asarray(np.array(base & 0xFFFFFFFF, np.uint32).view(np.int32))


CASES = [
    # (seed, B, W, n, k, row_base)
    (0, 61, 9, 70, 96, 0),
    (1, 61, 9, 70, 96, 37),
    (2, 300, 12, 500, 256, 2 ** 32 - 90),
    (3, 130, 4, 40, 32, 2 ** 31 - 64),
    (4, 257, 21, 900, 4096, 2 ** 32 - 1),
]


@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_fold_rows_equals_reference(case, mode):
    seed, b, w, n, k, base = case
    nodes, lens, view = _batch(seed, b, w, n)
    words = _words(np.random.default_rng(seed + 50), n + 1, k)
    args = (jnp.asarray(words), jnp.asarray(nodes), jnp.asarray(lens),
            _as_int32(base))
    want = np.asarray(jsketch.fold_frontier_packed(*args, k=k, mode=mode,
                                                   interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jsketch.fold_batch_packed(*args, k=k, mode=mode)))
    port = torch.tensor(words.view(np.int32))
    counts = torch.full((2,), -1, dtype=torch.int64)
    ops.reset_launch_counts()
    out = ops.sketch_fold_rows(port, view, torch.tensor(lens), base, k=k,
                               mode=mode, counts=counts)
    assert out is port and not any(ops.launch_counts().values())
    np.testing.assert_array_equal(port.numpy(), want.view(np.int32))
    clamped = np.clip(lens.astype(np.int64), 0, w)
    assert counts.tolist() == [int(clamped.sum()), int((clamped > 0).sum())]
    # the core entry, int64 inputs and no counts: the same words
    again = torch.tensor(words.view(np.int32))
    tsketch.fold_frontier_packed(again, view.to(torch.int64),
                                 torch.tensor(lens).to(torch.int64), base,
                                 k=k, mode=mode)
    assert torch.equal(again, port)


def test_fold_rows_checks_its_arguments():
    words = torch.zeros(5, 3, dtype=torch.int32)
    nodes = torch.zeros(4, 2, dtype=torch.int32)
    lens = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="k must"):
        ops.sketch_fold_rows(words, nodes, lens, 0, k=97, mode="mod")
    with pytest.raises(ValueError, match="k must"):
        ops.sketch_fold_rows(words, nodes, lens, 0, k=0, mode="mod")
    with pytest.raises(ValueError, match="mode"):
        ops.sketch_fold_rows(words, nodes, lens, 0, k=96, mode="hash")
    with pytest.raises(ValueError, match="padded"):
        ops.sketch_fold_rows(words, nodes, lens[:3], 0, k=96, mode="mod")
    assert not words.any()
    counts = torch.full((2,), 9, dtype=torch.int64)
    ops.sketch_fold_rows(words, nodes[:0], lens[:0], 0, k=96, mode="mod",
                         counts=counts)
    assert counts.tolist() == [0, 0] and not words.any()


# ----------------------------------------------------------- the stores

def _store_batches(seed, n, count=4, b=70, w=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        queue = rng.integers(0, n, (b, w + 3)).astype(np.int32)
        lens = rng.integers(-1, w + 2, b).astype(np.int32)
        lens[10:13] = 0
        out.append((np.ascontiguousarray(queue[:, :w]), lens,
                    torch.tensor(queue)[:, :w]))
    return out


@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("sketch_k", [96, 1024])
def test_sketch_store_folds_equal_reference(sketch_k, mode):
    """The approximate store's append (one fold and one read of its
    counts) against the reference's store: words, rows and elements after
    every batch."""
    n = 60
    jref = jcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode)
    port = tcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode,
                              device=CPU)
    for nodes, lens, view in _store_batches(sketch_k, n):
        jref.append_batch((nodes, lens))
        port.append_batch((view, torch.tensor(lens)))
        assert (port.n_rr, port.n_elems) == (jref.n_rr, jref.n_elems)
        np.testing.assert_array_equal(
            port.words.numpy(), np.asarray(jref.sketch_words()).view(np.int32))
    assert port.fold_error.tolist() == [0]


@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("sketch_k", [96, 1024])
def test_exact_store_folds_equal_reference(sketch_k, mode):
    """The exact store's incremental sketch (its fold under the ids the
    append writes) against the reference's store, after every batch, and
    against the approximate store's words on the same batches."""
    n = 60
    jref = jcov.DeviceRRStore(n, capacity=8, sketch_k=sketch_k,
                              sketch_mode=mode)
    port = tcov.DeviceRRStore(n, capacity=8, sketch_k=sketch_k,
                              sketch_mode=mode, device=CPU)
    pool_free = tcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode,
                                   device=CPU)
    for nodes, lens, view in _store_batches(sketch_k + 1, n):
        jref.append_batch((nodes, lens))
        port.append_batch((view, torch.tensor(lens)))
        pool_free.append_batch((view, torch.tensor(lens)))
        assert (port.n_rr, port.n_elems) == (jref.n_rr, jref.n_elems)
        np.testing.assert_array_equal(
            port.sketch_words().numpy(),
            np.asarray(jref.sketch_words()).view(np.int32))
    assert torch.equal(port.sketch_words(), pool_free.words)


def test_fold_counts_equal_the_store_counts():
    """The counts the fold writes are the rows and elements the stores
    add: the approximate store's append reads them back; the exact store
    counts its own."""
    n = 40
    for nodes, lens, view in _store_batches(9, n, count=3, b=150):
        store = tcov.DeviceRRStore(n, device=CPU)
        store.append_batch((view, torch.tensor(lens)))
        words = torch.zeros(n + 1, 4, dtype=torch.int32)
        counts = torch.zeros(2, dtype=torch.int64)
        ops.sketch_fold_rows(words, view, torch.tensor(lens), 0, k=128,
                             mode="mod", counts=counts)
        assert counts.tolist() == [store.n_elems, store.n_rr]


def test_sketch_store_raises_on_its_flag_before_counting():
    """A set flag raises at the next append's read; the store's counters do
    not move."""
    store = tcov.SketchRRStore(10, sketch_k=64, device=CPU)
    store.append_batch((torch.tensor([[1, 2]]), torch.tensor([2])))
    store.fold_error[0] = 1
    with pytest.raises(ValueError, match="outside"):
        store.append_batch((torch.tensor([[3]]), torch.tensor([1])))
    assert (store.n_rr, store.n_elems) == (1, 2)


# ------------------------------------------------ a replay of the kernel

def _kernel_replay(words, nodes, lens, row_base, *, k, mode):
    """csrc/sketch.cu's fold_rows_kernel in numpy: blocks of FOLD_THREADS
    rows; each block counts the non-empty rows and valid lanes before it
    from the lengths, scans its own rows' flags and lengths, buckets each
    row, then walks its valid lanes end to end, a lane's row by a binary
    search over the block's offsets.  Returns the words and the last
    block's counts."""
    words = words.copy().view(np.uint32)
    b, w = nodes.shape
    r = words.shape[0]
    clamped = np.clip(lens.astype(np.int64), 0, w)
    counts = None
    blocks = -(-b // FOLD_THREADS)
    for blk in range(blocks):
        r0 = blk * FOLD_THREADS
        rows_before = int((clamped[:r0] > 0).sum())
        lanes_before = int(clamped[:r0].sum())
        mine = np.zeros(FOLD_THREADS, np.int64)
        mine[:max(0, min(b - r0, FOLD_THREADS))] = clamped[r0:r0 + FOLD_THREADS]
        flags = (mine > 0).astype(np.int64)
        off = np.concatenate([[0], np.cumsum(mine)])
        rank = np.cumsum(flags) - flags
        h = (np.uint64(row_base & 0xFFFFFFFF) + np.uint64(rows_before)
             + rank.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
        if mode == "mix":
            h = (h * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
        bucket = (h % np.uint64(k)).astype(np.int64)
        total = int(off[-1])
        if blk == blocks - 1:
            counts = [lanes_before + total, rows_before + int(flags.sum())]
        for p in range(total):
            row = 0
            half = FOLD_THREADS // 2
            while half:
                if off[row + half] <= p:
                    row += half
                half //= 2
            v = int(nodes[r0 + row, p - off[row]]) & 0xFFFFFFFF
            if v < r:
                bk = bucket[row]
                words[v, bk >> 5] |= np.uint32(1 << (bk & 31))
    return words.view(np.int32), counts


@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("b", [1, 127, 128, 129, 300])
def test_kernel_replay_equals_plain(b, mode):
    """The kernel's block walk gives the plain fold's words and counts on
    batches of one block, one block exactly and past it."""
    nodes, lens, view = _batch(b, b, 7, 90, empty_mid=b > 10)
    words = _words(np.random.default_rng(b), 91, 96)
    want = torch.tensor(words.view(np.int32))
    counts = torch.zeros(2, dtype=torch.int64)
    tref.sketch_fold_rows_ref(want, view, torch.tensor(lens), 2 ** 32 - 7,
                              k=96, mode=mode, counts=counts)
    got, got_counts = _kernel_replay(words.view(np.int32), nodes, lens,
                                     2 ** 32 - 7, k=96, mode=mode)
    np.testing.assert_array_equal(got, want.numpy())
    assert got_counts == counts.tolist()
