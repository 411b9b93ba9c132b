"""CELF selection, the exact store's coverage sketch and the θ early exit
of the torch port against the JAX reference.

Every comparison is exact (tolerance 0).  ``select_seeds_celf`` gives the
reference's seeds, gains, float32 bytes of ``frac`` and ``stats_out`` on
the reference suite's random pools (``tests/test_selection_backends.py``)
at every sketch size, exact-evaluation batch and bucketing; the exact
store's incremental and on-demand sketch words equal the reference's after
every append (packed words are uint32 there and int32 here, compared bit
for bit); the plain versions of the CELF kernels equal the reference's
``eval_batch`` and ``apply_seed`` (a row may repeat a node).  Solves run
on the batches that the reference's own queue engine samples (recorded,
then replayed to the port's solver), so the two pools are equal and a
``celf-sketch`` or ``early_exit`` solve must give the reference's θ, LB,
seeds, gains, ``frac``, skips and history.  The CUDA kernels are held to
the plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import coverage as jcov
from repro.core.engine import make_engine as jmake_engine
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.core import coverage as tcov
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr as tcsr, weights as tw
from repro_torch.kernels import ops as tops, ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"


def _batches(rng, n, batches=4, count=60, max_len=8):
    """The reference suite's ``_random_pool`` batches: rows of 1 to
    max_len - 1 distinct nodes, padded with zeros."""
    out = []
    for _ in range(batches):
        lens = rng.integers(1, max_len, count)
        nodes = np.zeros((count, int(lens.max())), np.int64)
        for i, ln in enumerate(lens):
            nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
        out.append((nodes, lens))
    return out


def _both_stores(n, batches, sketch_k=None, mode="mod", check=None):
    """The reference's store and the port's on the same appends
    (capacity 8, so they double); ``check(ref, port)`` after each."""
    ref = jcov.DeviceRRStore(n, capacity=8, sketch_k=sketch_k,
                             sketch_mode=mode)
    port = tcov.DeviceRRStore(n, capacity=8, sketch_k=sketch_k,
                              sketch_mode=mode, device=CPU)
    for nodes, lens in batches:
        ref.append_batch((nodes, lens))
        port.append_batch((nodes, lens))
        if check is not None:
            check(ref, port)
    return ref, port


def _bits(x):
    return np.asarray(x).view(np.int32)


def _same_result(got, want):
    np.testing.assert_array_equal(got.seeds.numpy(), np.asarray(want.seeds))
    np.testing.assert_array_equal(got.gains.numpy(), np.asarray(want.gains))
    assert got.seeds.dtype == got.gains.dtype == torch.int32
    assert got.frac.dtype == torch.float32
    assert got.frac.numpy().tobytes() == np.asarray(want.frac).tobytes()


# ------------------------------------------------------- select_seeds_celf

@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("eval_batch", [1, 4, 32])
@pytest.mark.parametrize("sketch_k", [32, 64, 256, None])
def test_select_seeds_celf_equals_reference(sketch_k, eval_batch, mode):
    """At every sketch size (None: the on-demand sketch of 1,024 buckets),
    batch and bucketing: the reference's seeds, gains, frac bytes and
    stats (the exact evaluations and their calls count the same)."""
    n, k = 45, 5
    ref, port = _both_stores(n, _batches(np.random.default_rng(7), n),
                             sketch_k, mode)
    st_ref, st_port = {}, {}
    want = jcov.select_seeds_celf(ref, k, eval_batch=eval_batch,
                                  stats_out=st_ref)
    got = tcov.select_seeds_celf(port, k, eval_batch=eval_batch,
                                 stats_out=st_port)
    _same_result(got, want)
    assert st_port == st_ref
    assert st_port["sketch_k"] == (sketch_k or 1024)
    flat = port.select(k, method="flat")
    assert torch.equal(got.seeds, flat.seeds)
    assert torch.equal(got.gains, flat.gains)
    assert got.frac.numpy().tobytes() == flat.frac.numpy().tobytes()


@pytest.mark.parametrize("eval_batch", [1, 4, 32])
def test_select_seeds_celf_without_sketch_equals_reference(eval_batch):
    n, k = 50, 6
    ref, port = _both_stores(n, _batches(np.random.default_rng(3), n),
                             256)
    st_ref, st_port = {}, {}
    want = jcov.select_seeds_celf(ref, k, eval_batch=eval_batch,
                                  use_sketch=False, stats_out=st_ref)
    got = tcov.select_seeds_celf(port, k, eval_batch=eval_batch,
                                 use_sketch=False, stats_out=st_port)
    _same_result(got, want)
    assert st_port == st_ref and st_port["sketch_k"] == 0


@pytest.mark.parametrize("method", ["celf", "celf-sketch"])
def test_store_select_takes_celf(method):
    n, k = 45, 5
    ref, port = _both_stores(n, _batches(np.random.default_rng(9), n), 64)
    _same_result(port.select(k, method=method),
                 ref.select(k, method=method))
    _same_result(port.select(k, method=method, eval_batch=3),
                 ref.select(k, method=method, eval_batch=3))


def test_celf_at_n_and_past_the_last_gain():
    """eval_batch above n is cut to n; past the last positive gain every
    bound is 0 and the reference takes node 0 again and again."""
    n = 6
    batches = [(np.array([[1, 4], [4, 0], [4, 0]]), np.array([2, 2, 1]))]
    ref, port = _both_stores(n, batches, 32)
    st_ref, st_port = {}, {}
    want = jcov.select_seeds_celf(ref, 5, eval_batch=50, stats_out=st_ref)
    got = tcov.select_seeds_celf(port, 5, eval_batch=50, stats_out=st_port)
    _same_result(got, want)
    assert st_port == st_ref
    assert got.seeds.tolist() == [4, 0, 0, 0, 0]
    assert got.gains.tolist() == [3, 0, 0, 0, 0]


def _tie_batches(n=40):
    """Every node in exactly two rows of two: Occur ties everywhere, and
    the exact gains tie after each commit."""
    rng = np.random.default_rng(5)
    order = np.concatenate([rng.permutation(n), rng.permutation(n)])
    nodes = order.reshape(-1, 2)
    nodes[nodes[:, 0] == nodes[:, 1], 1] = (nodes[nodes[:, 0] == nodes[:, 1],
                                                  1] + 1) % n
    return [(nodes, np.full(len(nodes), 2))]


# (n, batches, k, eval_batch, sketch_k) of each edge case
_CELF_CASES = {
    "ties": lambda: (40, _tie_batches(), 6, 4, 64),
    "batch_at_n": lambda: (45, _batches(np.random.default_rng(8), 45), 5,
                           45, 64),
    "batch_past_n": lambda: (45, _batches(np.random.default_rng(8), 45), 5,
                             100, 256),
    "k_past_n": lambda: (20, _batches(np.random.default_rng(6), 20, 2, 30,
                                      5), 24, 3, 32),
    "repeats": lambda: (40, _pool_with_repeats(), 6, 4, 64),
    "chunked": lambda: (2500, _batches(np.random.default_rng(12), 2500, 2,
                                       400, 12), 3, 2100, 1024),
}


@pytest.mark.parametrize("use_sketch", [True, False])
@pytest.mark.parametrize("case", sorted(_CELF_CASES))
def test_select_seeds_celf_edge_cases_equal_reference(case, use_sketch):
    """Ties in ub, a batch of n and past n, k past n (seeds repeat: node 0
    at gain 0), rows that repeat a node, and a batch past one 2,048-slot
    chunk of the kernel on 2,500 nodes: the reference's seeds, gains, frac
    bytes and stats."""
    n, batches, k, eval_batch, sketch_k = _CELF_CASES[case]()
    ref, port = _both_stores(n, batches, sketch_k)
    st_ref, st_port = {}, {}
    want = jcov.select_seeds_celf(ref, k, eval_batch=eval_batch,
                                  use_sketch=use_sketch, stats_out=st_ref)
    got = tcov.select_seeds_celf(port, k, eval_batch=eval_batch,
                                 use_sketch=use_sketch, stats_out=st_port)
    _same_result(got, want)
    assert st_port == st_ref
    if case == "k_past_n":
        assert got.gains[-3:].tolist() == [0, 0, 0]


def test_celf_select_ref_is_the_routed_selection():
    """``ops.celf_select`` on CPU tensors is ``ref.celf_select_ref`` (no
    launch), and ``select_seeds_celf`` is a thin caller of it: the same
    seeds, gains and counts; the trace holds each eval call's batch."""
    n = 45
    _, port = _both_stores(n, _batches(np.random.default_rng(7), n), 64)
    t = port.n_elems
    pool = (port.flat[:t], port.ids[:t], port.valid[:t])
    kw = dict(n=n, num_rows=port.row_capacity(), k=5, c=4,
              sketch=port.sketch_words())
    tops.reset_launch_counts()
    routed = tops.celf_select(*pool, **kw)
    calls = []
    plain = tref.celf_select_ref(*pool, **kw, calls_out=calls)
    assert not any(tops.launch_counts().values())
    for a, b in zip(routed, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert routed[2].dtype == torch.int64 and routed[2].shape == (2,)
    assert len(calls) == int(plain[2][1])
    assert sum(len(c) for c in calls) == int(plain[2][0])
    assert all(len(c) == 4 and len(set(c.tolist())) == 4 for c in calls)
    stats = {}
    res = tcov.select_seeds_celf(port, 5, eval_batch=4, stats_out=stats)
    assert torch.equal(res.seeds, plain[0])
    assert (stats["n_exact_evals"], stats["n_eval_calls"]) == \
        tuple(plain[2].tolist())


# ------------------------------------- a replay of celf_select's batch pick

_DIGIT, _BINS = 11, 2048


def _kernel_pick(sel: np.ndarray, cc: int, blocks: int) -> np.ndarray:
    """csrc/celf.cu's batch pick, replayed: the cc nodes of largest (sel,
    -id) among sel >= 1.  The cc-th largest sel T digit by digit (11 bits
    a digit, from the digit that holds the largest sel's top bit, the two
    lowest from the sweep's own histograms), then every node of sel > T
    and, of sel == T, all of them when the count at T is what is needed,
    else each block's own ties in id order from the rank that the blocks
    below it leave (block b owns the nodes [b*slots, (b+1)*slots))."""
    x = sel.astype(np.uint64)
    inc = x >= 1
    m = int(x.max())

    def hist(shift, prefix):
        keep = inc & ((x >> np.uint64(shift + _DIGIT)) == prefix)
        return np.bincount(((x[keep] >> np.uint64(shift)) & (_BINS - 1))
                           .astype(np.int64), minlength=_BINS)

    def find(h, rem):
        # the largest bin d with (count of bins >= d) >= rem
        from_top = np.cumsum(h[::-1])
        i = int(np.searchsorted(from_top, rem))
        d = _BINS - 1 - i
        return d, int(from_top[i] - h[d]), int(h[d])

    rem, prefix = cc, 0
    if m < 1 << _DIGIT:
        shift = 0
    elif m < 1 << (2 * _DIGIT):
        shift = _DIGIT
    else:
        shift = None
    if shift is not None:
        d, above, at = find(hist(shift, 0), rem)
        prefix, rem = d, rem - above
        shifts = [0] if shift else []
    else:
        shifts = [2 * _DIGIT, _DIGIT, 0]
    for sh in shifts:
        d, above, at = find(hist(sh, prefix), rem)
        prefix, rem = (prefix << _DIGIT) | d, rem - above
    thr = np.uint64(prefix)
    if rem == at:
        return np.flatnonzero(x >= thr)
    taken = list(np.flatnonzero(x > thr))
    n = len(sel)
    slots = -(-n // blocks)
    tie = x == thr
    counts = [int(tie[b * slots:(b + 1) * slots].sum()) for b in range(blocks)]
    for b in range(blocks):
        quota = rem - sum(counts[:b])
        ids = b * slots + np.flatnonzero(tie[b * slots:(b + 1) * slots])
        taken += list(ids[:max(quota, 0)])
    return np.sort(np.asarray(taken, np.int64))


def _sel_values(kind: str, n: int, rng) -> np.ndarray:
    if kind == "small":                       # M < 2^11, many ties
        return rng.integers(0, 40, n)
    if kind == "mid":                         # 2^11 <= M < 2^22
        return rng.integers(0, 1 << 21, n) >> rng.integers(0, 12, n)
    if kind == "top":                         # up to 2^31, ub = t - 1
        out = rng.integers(0, 1 << 31, n) >> rng.integers(0, 25, n)
        out[rng.integers(n)] = 1 << 31
        return out
    if kind == "equal":                       # every included sel equal
        return np.where(rng.random(n) < 0.8, 7, 0)
    return np.where(rng.random(n) < 0.3, 0, 1)   # "fresh": sel 0 or ub 0


_MASK32 = 0xFFFFFFFF
_WARPS = 16                 # csrc/celf.cu: kSelWarps


def _bitonic_step(x, k, j):
    """One compare-exchange step of csrc/celf.cu's warp networks over the
    32 keys x (key i in lane i): keys i and i ^ j swap unless the lower
    index holds the larger where i & k == 0."""
    i = np.arange(len(x))
    y = x[i ^ j]
    keep_max = ((i & j) == 0) == ((i & k) == 0)
    return np.where(keep_max, np.maximum(x, y), np.minimum(x, y))


def _warp_sort(x):
    for k in (2 ** e for e in range(1, len(x).bit_length())):
        j = k // 2
        while j:
            x = _bitonic_step(x, k, j)
            j //= 2
    return x


def _warp_merge(a, b):
    """The len(a) largest keys of a and b, both sorted descending."""
    x = np.maximum(a, b[::-1])
    j = len(x) // 2
    while j:
        x = _bitonic_step(x, len(x), j)
        j //= 2
    return x


def _list_pick(sel: np.ndarray, cc: int, blocks: int):
    """csrc/celf.cu's top-list pick, replayed: keys (sel << 32) | ~id of sel
    >= 1 (0 for none); in each block (the nodes [b*slots, (b+1)*slots)),
    warp w sorts the chunks of 32 keys at q = w, w + 16, ... and merges
    each into its running list, then the 16 warps'
    lists merge pairwise; every block then keeps the lists whose head is
    among the cc largest heads and merges those pairwise in rounds (an odd
    last list with zeros), and the batch is the first cc keys of the last
    list.  Also checks that every list is sorted
    and holds its keys' largest."""
    n = len(sel)
    x = sel.astype(np.uint64)
    ids = np.arange(n, dtype=np.uint64)
    keys = np.where(x >= 1, (x << np.uint64(32)) | (np.uint64(_MASK32) - ids),
                    np.uint64(0))
    slots, lst = -(-n // blocks), 32
    zero = np.zeros(lst, np.uint64)
    lists = []
    for b in range(blocks):
        mine = keys[b * slots:(b + 1) * slots]
        chunks = -(-len(mine) // 32)
        runs = []
        for w in range(_WARPS):
            run = zero
            for q in range(w, chunks, _WARPS):
                chunk = np.zeros(lst, np.uint64)
                part = mine[q * 32:(q + 1) * 32]
                chunk[:len(part)] = part
                run = _warp_merge(run, _warp_sort(chunk))
            runs.append(run)
        while len(runs) > 1:
            runs = [_warp_merge(runs[2 * i], runs[2 * i + 1])
                    for i in range(len(runs) // 2)]
        want = np.sort(mine)[::-1][:lst]
        np.testing.assert_array_equal(runs[0][:len(want)], want)
        lists.append(runs[0])
    heads = np.array([lst_b[0] for lst_b in lists])
    kept = [lists[b] for b in range(blocks)
            if heads[b] and int((heads > heads[b]).sum()) < cc] or [zero]
    assert len(kept) <= cc
    lists = kept
    while True:
        half = -(-len(lists) // 2)
        lists = [_warp_merge(lists[2 * m], lists[2 * m + 1]
                             if 2 * m + 1 < len(lists) else zero)
                 for m in range(half)]
        if len(lists) == 1:
            break
    top = lists[0][:cc]
    assert (top > 0).all() and (np.diff(top.astype(np.float64)) < 0).all()
    return np.sort((np.uint64(_MASK32) - (top & np.uint64(_MASK32)))
                   .astype(np.int64))


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("kind", ["small", "mid", "top", "equal", "fresh"])
def test_kernel_batch_pick_replay_equals_argpartition(kind, blocks):
    """The replayed pick gives the reference's batch (``argpartition`` of
    the unique keys sel*(n+1) - id over the included nodes): the merge of
    the blocks' top lists of 32 keys at c = 1 and 32, the radix pick at c =
    64, 65 and 2,048 (and 2,100, past one chunk), each
    at a batch of min(c, included) and of the included nodes that are
    left, with fewer nodes than blocks too and equal sel across the
    blocks' boundaries."""
    rng = np.random.default_rng(
        ["small", "mid", "top", "equal", "fresh"].index(kind) * 1000 + blocks)
    for n in (5, 3000):
        sel = _sel_values(kind, n, rng).astype(np.int64)
        sel[0] = max(sel[0], 1)                 # at least one included
        inc = np.flatnonzero(sel >= 1)
        key = sel[inc] * (n + 1) - inc
        for c in (1, 32, 64, 65, 2048, 2100):
            for cc in {min(c, len(inc)), max(1, min(c, len(inc)) // 3)}:
                want = np.sort(inc[np.argpartition(-key, cc - 1)[:cc]])
                got = _list_pick(sel, cc, blocks) if c <= 32 \
                    else _kernel_pick(sel, cc, blocks)
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,t,lst,shared,on_chip", [
    (32, 35_538, 32, True, True), (1, 35_538, 32, True, True),
    (33, 35_538, 0, True, False), (64, 35_538, 0, True, False),
    (65, 35_538, 0, True, False),
    (2048, 35_538, 0, True, False), (32, 40_000_000, 32, True, False)])
def test_select_layout_takes_the_list_path_at_small_batches(c, t, lst, shared,
                                                            on_chip):
    """celf_select's form on the H100's grid (132 blocks, 58,080 words of
    dynamic shared memory) at the CELF cell's sketch of 32 words: top
    lists of 32 keys up to c = 32, the radix pick past it; the pool's pairs
    on chip while a block's share fits."""
    from repro_torch.kernels import celf as tcelf
    lay = tcelf.select_layout(75_879, 16_384, c, 32, 132, 58_080, t)
    assert (lay.list, lay.shared, lay.pool_on_chip) == (lst, shared, on_chip)
    merge = 8 * lst * (132 + 66)
    sel = 4 * 576 if lst else 0                 # 575 nodes a block, to 16
    pool = 8 * -(-t // 132) if on_chip else 0
    rows = 4 * 575 * 32 if lst else 0            # the slice's sketch rows
    assert lay.rows_on_chip == bool(lst)
    assert lay.dynamic_bytes == 4 * 32 + merge + sel + pool + rows


def test_select_seeds_celf_variants_not_ported():
    """The CELF variant is ported (tests/test_torch_variants.py), the
    weighted spec too (tests/test_torch_row_weighted.py), which a store
    without row weights refuses, as the reference's."""
    port = tcov.DeviceRRStore(4, device=CPU)
    port.append_batch((np.array([[0, 1]]), np.array([2])))
    with pytest.raises(ValueError, match="row_weighted store"):
        tcov.select_seeds_celf(port, 1, spec=tcov.SelectionSpec(
            k_steps=1, n_group=4, weighted=True))
    res = tcov.select_seeds_celf(port, 1, spec=tcov.SelectionSpec(
        k_steps=1, n_group=4, cand=np.array([0, 1, 0, 0], bool)))
    assert res.seeds.tolist() == [1] and res.gains.tolist() == [1]


# ------------------------------------------------ the exact store's sketch

@pytest.mark.parametrize("sketch_k,mode", [(32, "mod"), (64, "mix"),
                                           (1024, "mod"), (1024, "mix")])
def test_incremental_sketch_equals_reference_after_every_append(sketch_k,
                                                                mode):
    """Batches with empty rows, doublings from capacity 8 and a wide
    (packed) batch: after every append the pool buffers and the sketch
    words equal the reference's."""
    rng = np.random.default_rng(sketch_k)
    n = 70
    batches = []
    for count in (61, 30, 200):
        lens = rng.integers(0, 9, count)
        nodes = np.full((count, 8), n, np.int64)
        for i, ln in enumerate(lens):
            nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
        batches.append((nodes, lens))
    wide = np.full((64, 600), n, np.int64)     # 38,400 slots, few elements
    wlens = rng.integers(0, 6, 64)
    for i, ln in enumerate(wlens):
        wide[i, :ln] = rng.choice(n, size=ln, replace=False)
    batches.append((wide, wlens))
    seen = []

    def check(ref, port):
        t = port.n_elems
        assert (port.n_rr, t, port.capacity) == (ref.n_rr, ref.n_elems,
                                                 ref.capacity)
        np.testing.assert_array_equal(port.flat.numpy(),
                                      np.asarray(ref._flat)[0])
        np.testing.assert_array_equal(port.ids.numpy(),
                                      np.asarray(ref._ids)[0])
        want = _bits(ref.sketch_words())
        assert want.shape == (n + 1, sketch_k // 32)
        np.testing.assert_array_equal(port.sketch_words().numpy(), want)
        seen.append(port.capacity)

    ref, port = _both_stores(n, batches, sketch_k, mode, check)
    assert len(set(seen)) > 2                       # it doubled
    assert port.sketch_bytes() == ref.sketch_bytes() == \
        (n + 1) * (sketch_k // 32) * 4
    assert (port.sketch_words() < 0).any()          # bit 31 present
    assert port.sketch_words(sketch_k - 5) is port.sketch_words()
    with pytest.raises(ValueError, match="incremental sketch"):
        port.sketch_words(2 * sketch_k)
    assert int(port.fold_error[0]) == 0


@pytest.mark.parametrize("mode", ["mod", "mix"])
def test_on_demand_sketch_equals_reference_after_every_append(mode):
    """No incremental sketch: the words are built from the pool on demand
    (1,024 buckets, or any k asked), cached until the next append."""
    n = 60

    def check(ref, port):
        for k in (None, 64, 100):
            np.testing.assert_array_equal(port.sketch_words(k).numpy(),
                                          _bits(ref.sketch_words(k)))
        words = port.sketch_words(100)
        assert words.shape == (n + 1, 4)
        assert port.sketch_words(100) is words      # cached

    ref, port = _both_stores(n, _batches(np.random.default_rng(2), n, 3),
                             None, mode, check)
    assert port.sketch_bytes() == ref.sketch_bytes() == 0
    cached = port.sketch_words()
    port.append_batch((np.array([[1, 2]]), np.array([2])))
    assert port.sketch_words() is not cached


def test_a_bad_fold_raises_at_the_next_read():
    """The fold's flag is read with the next append's counts and by the
    CELF selection's one read of Occur, so no new host read checks it."""
    port = tcov.DeviceRRStore(5, sketch_k=32, device=CPU)
    port.append_batch((np.array([[0, 1]]), np.array([2])))
    port.fold_error[0] = 1
    with pytest.raises(ValueError, match="outside"):
        tcov.select_seeds_celf(port, 1)
    with pytest.raises(ValueError, match="outside"):
        port.append_batch((np.array([[2]]), np.array([1])))


# -------------------------------------------- the CELF kernels' plain forms

def _pool_with_repeats(n=40, seed=4):
    """Rows that repeat a node (the reference counts such a row once)."""
    rng = np.random.default_rng(seed)
    count, width = 90, 7
    lens = rng.integers(0, width + 1, count)
    nodes = rng.integers(0, n, (count, width))
    nodes[:10, :3] = 5                          # node 5 three times a row
    lens[:10] = np.maximum(lens[:10], 3)
    return [(nodes, lens)]


@pytest.mark.parametrize("cover", [0.0, 0.3, 1.0])
def test_celf_plain_versions_equal_reference(cover):
    n = 40
    ref, port = _both_stores(n, _pool_with_repeats(n), None)
    fns = jcov._mesh_select_fns(ref.mesh)
    nw = port.row_capacity() // 32
    rng = np.random.default_rng(int(cover * 10))
    cov = np.zeros(nw * 32, bool)
    cov[rng.random(nw * 32) < cover] = True
    cov[31] = cover > 0                         # bit 31 of a word
    cov_u32 = (cov.reshape(nw, 32).astype(np.uint64)
               << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    cands = np.array([5, -1, 0, 39, 5, 12, 7, -1], np.int32)
    want = np.asarray(fns.eval_batch(
        ref._flat, ref._ids, ref._valid,
        jax.device_put(cov_u32[None], ref._sh_buf), jnp.asarray(cands)))
    t = port.n_elems
    pool = (port.flat[:t], port.ids[:t], port.valid[:t])
    cov_port = torch.tensor(cov_u32.view(np.int32))
    got = tref.celf_eval_ref(*pool, cov_port, torch.tensor(cands))
    before = tops.launch_counts()
    routed = tops.celf_eval(*pool, cov_port, torch.tensor(cands))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(routed, got)
    hit = (pool[0] == 5) & pool[2]
    rows = set(pool[1][hit].tolist()) - set(np.flatnonzero(cov).tolist())
    assert int(got[0]) == len(rows) < int(hit.sum())  # a row counts once
    for u in (5, 0, 39):
        new_cov, gain = fns.apply_seed(
            ref._flat, ref._ids, ref._valid,
            jax.device_put(cov_u32[None], ref._sh_buf),
            jnp.int32(u))
        mine = cov_port.clone()
        g = tref.celf_apply_ref(*pool, mine, u)
        routed_cov = cov_port.clone()
        g2 = tops.celf_apply(*pool, routed_cov, u)
        assert g.dtype == torch.int32 and g.dim() == 0
        assert int(g) == int(gain) == int(g2)
        np.testing.assert_array_equal(mine.numpy(), _bits(new_cov)[0])
        assert torch.equal(routed_cov, mine)
    assert tops.launch_counts() == before        # no launch on the CPU


def test_celf_eval_counts_a_row_once():
    flat = torch.tensor([3, 3, 1, 3, 2, 3], dtype=torch.int32)
    ids = torch.tensor([0, 0, 0, 1, 1, 40], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, True, True])
    cov = torch.zeros(1, dtype=torch.int32)      # 32 rows: row 40 dropped
    got = tref.celf_eval_ref(flat, ids, valid, cov, torch.tensor([3, 1, 9]))
    assert got.tolist() == [2, 1, 0]
    cov[0] = 1 << 1
    assert tref.celf_eval_ref(flat, ids, valid, cov,
                              torch.tensor([3])).tolist() == [1]
    assert int(tref.celf_apply_ref(flat, ids, valid, cov, 3)) == 1
    assert cov.tolist() == [3]
    assert int(tref.celf_apply_ref(flat, ids, valid, cov, 3)) == 0
    assert tref.celf_eval_ref(flat, ids, valid, cov,
                              torch.zeros(0, dtype=torch.int32)).numel() == 0


# ------------------------------------------------------------ the solves

class _Recorder:
    """A reference engine instance that keeps every batch it samples."""

    name = "recorder"
    root_weights = None

    def __init__(self, inner):
        self.inner, self.g_rev = inner, inner.g_rev
        self.batches = []

    @property
    def item_space(self):
        return self.inner.item_space

    def sample(self, key):
        b = self.inner.sample(key)
        self.batches.append(tuple(np.asarray(x) for x in (
            b.nodes, b.lengths, b.overflowed)) + (int(b.steps),))
        return b


class _Replay:
    """The port's side: the recorded batches, in order."""

    def __init__(self, batches):
        self._it = iter(batches)

    def sample(self, seed32):
        nodes, lens, ovf, steps = next(self._it)
        return convert.batch_from_arrays(nodes, lens, ovf, steps, device=CPU)


def _er(n=60, m=180, seed=1):
    src, dst = jgen.erdos_renyi(n, m, seed=seed)
    return (tw.wc_weights(tcsr.from_edges(src, dst, n, device=CPU)),
            jw.wc_weights(jcsr.from_edges(src, dst, n)))


def _solve_both(prob: dict, batch=64, seed=5, graph=None, **solver):
    tg, jg = graph if graph is not None else _er()
    rec = _Recorder(jmake_engine("queue", jcsr.reverse(jg), batch=batch))
    jres = JSolver(jg, engine=rec, seed=seed, **solver).solve(
        JProblem(**prob))
    port = IMMSolver(tg, batch=batch, seed=seed, device=CPU, **solver)
    problem = IMProblem(**prob)
    port.prepare(problem)
    port.engine = _Replay(rec.batches)
    return port.solve(problem), jres, port


def _same_solve(got, want):
    a, b = got.stats, want.stats
    assert (a.theta, a.lb, a.lb_iters, a.rounds, a.n_rr_sampled) == \
        (b.theta, b.lb, b.lb_iters, b.rounds, b.n_rr_sampled)
    assert a.early_exit_skips == b.early_exit_skips
    assert a.history == [tuple(h) for h in b.history]
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    np.testing.assert_array_equal(got.gains, np.asarray(want.gains))
    assert np.float32(got.frac).tobytes() == np.float32(want.frac).tobytes()
    assert got.spread == want.spread


@pytest.mark.parametrize("sketch_k,eval_batch", [(None, None), (64, 1),
                                                 (256, 8)])
def test_celf_sketch_solve_equals_reference(sketch_k, eval_batch):
    got, want, port = _solve_both(dict(k=4, eps=0.5),
                                  selection="celf-sketch",
                                  sketch_k=sketch_k, eval_batch=eval_batch)
    _same_solve(got, want)
    assert port.store.sketch_k == (sketch_k or 1024)
    assert port.eval_batch == eval_batch


@pytest.mark.parametrize("selection", ["fused", "celf-sketch"])
def test_early_exit_solve_equals_reference(selection):
    """The reference's skip on this graph (one, at LB iteration 1), the same
    θ and seeds, and the solve without the early exit agrees on all but the
    skipped iteration's selection."""
    prob = dict(k=3, eps=0.5, early_exit=True)
    got, want, port = _solve_both(prob, selection=selection)
    _same_solve(got, want)
    assert got.stats.early_exit_skips == 1
    assert got.stats.history[0] == ("lb_skip", 1, 169)
    assert port.store.sketch_k == 1024
    plain, _, _ = _solve_both(dict(prob, early_exit=False),
                              selection=selection)
    assert plain.stats.theta == got.stats.theta
    np.testing.assert_array_equal(plain.seeds, got.seeds)
    assert plain.stats.early_exit_skips == 0
    assert [h[:3] for h in plain.stats.history if h[0] == "lb_iter"][1:] \
        == [h[:3] for h in got.stats.history if h[0] == "lb_iter"]


def test_early_exit_gate_stays_off_past_the_exact_regime():
    """sketch_k below the pool's rows (or "mix" bucketing): the gate never
    skips, and the solve equals the reference's."""
    got, want, _ = _solve_both(dict(k=3, eps=0.5, early_exit=True),
                               selection="fused", sketch_k=32)
    _same_solve(got, want)
    assert got.stats.early_exit_skips == 0


def test_approximate_early_exit_equals_reference():
    got, want, _ = _solve_both(
        dict(k=3, eps=0.5, early_exit=True, mode="approximate",
             max_theta=2048), sketch_k=1024)
    _same_solve(got, want)
    assert got.spread_bounds == tuple(want.spread_bounds)
