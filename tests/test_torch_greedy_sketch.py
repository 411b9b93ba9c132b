"""The approximate mode's sketch greedy (``kernels/greedy.py::greedy_sketch``,
``csrc/greedy.cu``) on the CPU, against the JAX reference.

Both stores fold the same batches (the reference's queue engine samples
them; they are carried over as numpy).  ``ref.greedy_sketch_ref``,
``ops.greedy_sketch`` on CPU tensors and the port's ``select_seeds_sketch``
must equal the reference's ``select_seeds_sketch`` in seeds, gains, the
float32 bytes of ``frac`` and the whole certificate (``info_out``), at
sketch sizes from a saturated 32 buckets to the exact regime's 16,384,
under ``"mod"`` and ``"mix"`` bucketing.  Every comparison is exact.

The kernel cannot run here, so a torch replay of its steps is held against
``torch.argmax`` at each step and against the plain version: each block's
slice of rows and each thread's rows in that slice (``sketch_layout``'s
form and lane groups), each thread's first maximum over its rows, the warp
and block maxima of the 64-bit keys with the score shifted by one, the
blocks' records (0 for a block without a candidate) reduced a warp of
records at a time, picked nodes left out (read only at a delta of 0),
the running popcount of cov, and the stop when no node is left; with equal
best rows on both sides of block boundaries.
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
MASK32 = 0xFFFFFFFF


def _jax_batches(n=300, rounds=((64, 4), (128, 3)), seed=21):
    """Batches sampled by the reference's queue engine, as numpy."""
    src, dst = jgen.barabasi_albert(n, 3, seed=seed)
    g_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(src, dst, n)))
    out, key = [], jax.random.key(seed)
    for batch, count in rounds:
        eng = make_engine("queue", g_rev, batch=batch)
        for _ in range(count):
            key, sub = jax.random.split(key)
            b = eng.sample(sub)
            out.append((np.array(b.nodes), np.array(b.lengths)))
    return out


@pytest.fixture(scope="module")
def jax_batches():
    return _jax_batches()


def _both_stores(n, batches, sketch_k, mode):
    jref = jcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode)
    port = tcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode,
                              device=CPU)
    for nodes, lens in batches:
        jref.append_batch((nodes, lens))
        port.append_batch(convert.batch_from_arrays(
            nodes, lens, np.zeros(len(lens), bool), 0, device=CPU))
    return jref, port


def _assert_selection_equal(jref, port, k):
    info_ref, info_port = {}, {}
    want = jcov.select_seeds_sketch(jref, k, info_out=info_ref)
    ws, wg = np.asarray(want.seeds), np.asarray(want.gains)
    ops.reset_launch_counts()
    got = port.select(k, info_out=info_port)
    np.testing.assert_array_equal(got.seeds.numpy(), ws)
    np.testing.assert_array_equal(got.gains.numpy(), wg)
    assert got.seeds.dtype == got.gains.dtype == torch.int32
    assert got.frac.dtype == torch.float32
    assert got.frac.numpy().tobytes() == np.asarray(want.frac).tobytes()
    assert info_port == info_ref
    n = port.n_nodes
    for seeds, gains, steps in (
            ref.greedy_sketch_ref(port.words, n=n, k=k),
            ops.greedy_sketch(port.words, n=n, k=k)):
        np.testing.assert_array_equal(seeds.numpy(), ws)
        np.testing.assert_array_equal(gains.numpy(), wg)
        assert steps.tolist() == [int((ws < n).sum())]
    assert not any(ops.launch_counts().values())      # plain version on CPU
    return ws, wg, info_port


@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("sketch_k", [32, 128, 4096, 16384])
def test_sketch_greedy_equals_reference(jax_batches, sketch_k, mode):
    jref, port = _both_stores(300, jax_batches, sketch_k, mode)
    assert port.words.shape == (301, sketch_k // 32)
    assert (port.words < 0).any()                    # bit 31 present
    ws, wg, info = _assert_selection_equal(jref, port, 50)
    assert len(set(ws.tolist())) == 50
    assert info["exact_regime"] == (mode == "mod" and sketch_k >= 640)
    if sketch_k == 32:                               # the union saturates
        assert info["saturated"] and (wg[-10:] == 0).all()


@pytest.mark.parametrize("mode", ["mod", "mix"])
def test_sketch_greedy_past_the_last_node_equals_reference(mode):
    """k > n: every node is picked, then the greedy stops and pads."""
    rng = np.random.default_rng(4)
    n = 20
    lens = rng.integers(0, 6, 90)
    nodes = np.full((90, 6), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    jref, port = _both_stores(n, [(nodes, lens)], 64, mode)
    ws, wg, _ = _assert_selection_equal(jref, port, n + 5)
    assert sorted(ws[:n].tolist()) == list(range(n))
    assert (ws[n:] == n).all() and (wg[n:] == 0).all()


# ------------------------------------------------------- the kernel's pieces

# an H100 block's dynamic shared memory beside greedy_sketch's static, in
# words, as sketch_grid reports it on the card
SHARED_WORDS = 58_080


@pytest.mark.parametrize("cols,aligned,lanes,vector", [
    (1, True, 1, False), (3, True, 1, False), (4, True, 1, True),
    (4, False, 1, False), (5, True, 8, False), (8, True, 2, True),
    (8, False, 8, False), (32, True, 8, True), (128, True, 32, True),
    (512, True, 32, True), (60_000, True, 32, True), (97, True, 32, False)])
def test_sketch_layout(cols, aligned, lanes, vector):
    """The rows' lane groups: the same in ``sketch_layout`` as in
    ``row_lanes`` (``celf_select``'s sweep), whatever the form."""
    assert tgreedy.row_lanes(cols, aligned) == (lanes, vector)
    lay = tgreedy.sketch_layout(cols, aligned, n=75_879, blocks=132,
                                shared_words=SHARED_WORDS)
    assert (lay.lanes, lay.vector) == (lanes, vector)


@pytest.mark.parametrize("n,cols,blocks,form,rows", [
    (75_879, 4, 132, "registers", 2),        # the approximate cell
    (75_879, 1, 132, "registers", 2),
    (67_584, 3, 132, "registers", 1),        # 512 rows a block
    (67_585, 3, 132, "registers", 2),
    (135_168, 4, 132, "registers", 2),       # REG_ROWS rows a thread
    (135_169, 4, 132, "shared", 1),
    (75_879, 32, 132, "shared", 1),          # phase 8's W = 32
    (75_879, 128, 132, "global", 1),         # W = 128: 294 KB a block
    (75_879, 512, 132, "global", 1),
    (3_001, 512, 132, "shared", 1),
    (5, 60_000, 1, "global", 1)])
def test_sketch_layout_form(n, cols, blocks, form, rows):
    """Where a block's slice of rows lives: registers at W <= 4 while a
    thread holds at most REG_ROWS rows, else shared memory while cov and
    the slice fit, else global memory."""
    lay = tgreedy.sketch_layout(cols, True, n=n, blocks=blocks,
                                shared_words=SHARED_WORDS)
    assert (lay.form, lay.rows) == (form, rows)


def test_sketch_scratch_bytes():
    """Two steps' records (32 bytes a block each) and each block's picked
    bits (a word for 32 of its rows); in the global form past the shared
    memory, each block's copy of cov (rounded to 4 words) from a 16-byte
    boundary."""
    assert tgreedy.sketch_scratch_bytes(75_879, 4, 132, SHARED_WORDS,
                                        "registers") == \
        64 * 132 + 4 * 132 * 18                     # 575 rows a block
    fixed = 64 * 132 + 4 * 132 * 1
    assert tgreedy.sketch_scratch_bytes(7, 58_080, 132, 58_080,
                                        "global") == fixed
    wide = tgreedy.sketch_scratch_bytes(7, 58_081, 132, 58_080, "global")
    assert wide == -(-fixed // 16) * 16 + 4 * 132 * 58_084
    assert tgreedy.sketch_scratch_bytes(7, 58_081, 132, 58_080,
                                        "shared") == fixed


def test_sketch_barriers():
    """A grid barrier after the prologue and one a step run: the steps
    taken and, below k, the one that found no node."""
    assert tgreedy.sketch_barriers(50, 50) == 51
    assert tgreedy.sketch_barriers(7, 10) == 9


def _popcounts(words, cov):
    """popcount(words[v] | cov) summed over a row, as int64."""
    return ref.sketch_union_popcount_ref(words, cov).to(torch.int64)


def _redux_max_key(occ, low):
    """Two redux.sync maxima over the last axis (the largest occ, then the
    largest low among the entries that hold it) -> key."""
    best = occ.max(dim=-1).values
    first = torch.where(occ == best[..., None], low, 0).max(dim=-1).values
    return (best << 32) | first


def row_owner(held, lay):
    """For each row j < held of a block's slice: the thread that folds it
    and its place in that thread's order.  Registers: thread j % THREADS,
    the (j // THREADS)-th.  Lane groups: warp w's passes start at rows (w
    + m * warps) * span, span = (32 // lanes) * SKETCH_ROWS, and the group
    of lane l takes rows l // lanes + i * (32 // lanes) past that."""
    j = torch.arange(held, dtype=torch.int64)
    if lay.form == "registers":
        return j % THREADS, j // THREADS
    warps, rpw = THREADS // 32, 32 // lay.lanes
    span = rpw * SKETCH_ROWS
    owner = ((j // span) % warps) * 32 + (j % rpw) * lay.lanes
    order = (j // (span * warps)) * SKETCH_ROWS + (j % span) // rpw
    return owner, order


SKETCH_ROWS = 4        # csrc/greedy.cu: kSketchRows


def kernel_step_key(score, picked, blocks, lay):
    """One step's key as the kernel makes it on ``blocks`` blocks of
    THREADS: block b owns the rows [b * slots, (b + 1) * slots); each
    thread folds its rows (:func:`row_owner`) in order, a later row
    winning only on a larger score and a picked row (whose delta must be 0:
    the kernel reads the flag only then) taking no part; warps and then the
    block reduce by two maxima into the block's record (0 with no
    candidate).  After the step's barrier every block reduces the records:
    a warp each 32 of them, then the largest of the warps' keys.  ``score`` is shifted by
    one.  Returns the key."""
    n = score.shape[0]
    assert bool((score[picked] == 1).all())       # picked: delta 0
    slots = -(-n // blocks)
    v = torch.arange(n, dtype=torch.int64)
    owner, order = row_owner(slots, lay)
    b, j = v // slots, v % slots
    thread = b * THREADS + owner[j]
    t_occ = torch.zeros(blocks * THREADS, dtype=torch.int64)
    t_low = torch.zeros(blocks * THREADS, dtype=torch.int64)
    live = ~picked
    for m in range(int(order.max()) + 1):
        at = (order[j] == m) & live                # each thread's m-th row
        th, sc, lw = thread[at], score[at], MASK32 - v[at]
        take = (t_low[th] == 0) | (sc > t_occ[th])
        t_occ[th[take]] = sc[take]
        t_low[th[take]] = lw[take]
    warp = _redux_max_key(t_occ.view(blocks, THREADS // 32, 32),
                          t_low.view(blocks, THREADS // 32, 32))
    block = _redux_max_key(warp >> 32, warp & MASK32)
    rec = torch.cat([block, block.new_zeros(-blocks % 32)]).view(-1, 32)
    per_warp = _redux_max_key(rec >> 32, rec & MASK32)
    return int(per_warp.max())


def kernel_replay(words, *, n, k, blocks):
    """The kernel's steps in torch: each step's key (:func:`kernel_step_key`)
    over the scores popcount(words[v] | cov) - base + 1, base the running
    sum of the gains; a step whose key has a high word of 0 stops the
    greedy; else u and its gain come off the key (checked against
    ``torch.argmax`` of the plain score) and cov takes u's row (the
    register form's record carries it).  The steps not taken hold n and
    0."""
    lay = tgreedy.sketch_layout(words.shape[1], True, n=n, blocks=blocks,
                                shared_words=SHARED_WORDS)
    cov = torch.zeros(words.shape[1], dtype=torch.int32)
    picked = torch.zeros(n, dtype=torch.bool)
    seeds = torch.full((k,), n, dtype=torch.int32)
    gains = torch.zeros(k, dtype=torch.int32)
    base = steps = 0
    for s in range(k):
        cnt = _popcounts(words[:n], cov)
        assert int(cnt.min()) >= base                # base = popcount(cov)
        key = kernel_step_key(cnt - base + 1, picked, blocks, lay)
        plain = torch.where(picked, -1, cnt - base)
        want = int(torch.argmax(plain))
        if key >> 32 == 0:
            assert int(plain[want]) < 0              # every node is picked
            break
        u, gain = MASK32 - (key & MASK32), (key >> 32) - 1
        assert (u, gain) == (want, int(plain[want]))
        seeds[s], gains[s] = u, gain
        picked[u] = True
        cov |= words[u]
        base += gain
        steps = s + 1
    return seeds, gains, torch.tensor([steps], dtype=torch.int32)


def _case_words(case, n, cols, rng, blocks=1):
    """(n + 1, cols) int32 sketch words: ``bit31`` random words (bit 31 in
    about half), ``ties`` one bit a row among few buckets (many equal
    scores), ``saturated`` a few rows of all ones among sparse ones (every
    delta is 0 once one of them is picked), ``boundary`` sparse rows with
    the best rows in equal pairs on each side of the blocks' boundaries
    (the last row of a block and the first of the next)."""
    if case == "bit31":
        u = rng.integers(0, 1 << 32, size=(n + 1, cols), dtype=np.int64)
        return torch.from_numpy(u.astype(np.uint32).view(np.int32))
    words = np.zeros((n + 1, cols), np.uint32)
    bucket = rng.integers(0, min(8, 32 * cols), n + 1)
    words[np.arange(n + 1), bucket >> 5] = np.uint32(1) << (bucket & 31)
    if case == "saturated":
        words[rng.choice(n, 3, replace=False)] = MASK32
    if case == "boundary":
        slots = -(-n // blocks)
        for b, v in enumerate(range(slots, n, slots)):
            pattern = rng.integers(0, 1 << 32, size=cols, dtype=np.int64)
            pattern |= 0xFFFF                      # above every sparse row
            words[v - 1] = words[v] = pattern.astype(np.uint32)
            if b >= 3:
                break
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("cols", [1, 3, 4, 5, 32, 128, 512])
@pytest.mark.parametrize("case", ["ties", "saturated", "bit31", "past_n",
                                  "boundary"])
def test_kernel_replay_equals_plain_and_argmax(case, cols, blocks):
    rng = np.random.default_rng(len(case) * 31 + cols + blocks)
    if case == "past_n":
        n, k = 7, 10
        words = _case_words("bit31", n, cols, rng)
    else:
        n = 3_001 if cols >= 128 else (70_001 if blocks == 132 and cols < 32
                                       else 5_003)
        k = 8
        words = _case_words(case, n, cols, rng, blocks)
    got = kernel_replay(words, n=n, k=k, blocks=blocks)
    want = ref.greedy_sketch_ref(words, n=n, k=k)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.int32
        assert torch.equal(x, y)
    seeds, gains, steps = want
    if case == "past_n":
        assert int(steps) == n and (seeds[n:] == n).all() \
            and (gains[n:] == 0).all()
    else:
        assert int(steps) == k
    if case == "saturated":
        assert int(gains[0]) == 32 * cols and (gains[1:] == 0).all()
        assert seeds[1:].tolist() == sorted(seeds[1:].tolist())
    if case == "ties":
        assert len(set(gains.tolist())) < k


def test_greedy_sketch_wrapper_rejects_cpu_tensors_before_building():
    """The CUDA wrapper refuses a CPU sketch before it builds anything."""
    words = torch.zeros(5, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tgreedy.greedy_sketch(words, n=4, k=2)
    assert tgreedy._SKETCH._fn is None and tgreedy._SKETCH_GRID._fn is None
    assert "greedy" not in _build.PTXAS_REPORT


# ------------------------------------------------------------ the fold flag

def test_fold_flag_defers_the_raise_to_the_next_read():
    """A fold that meets a bucket outside the sketch sets the store's flag
    instead of raising; the next append and the next selection raise, and
    the words keep the pairs whose buckets were in range.  Without the
    flag the scatter raises at once."""
    store = tcov.SketchRRStore(10, sketch_k=64, device=CPU)
    words = store.words.clone()
    v = torch.tensor([1, 2, 3], dtype=torch.int32)
    b = torch.tensor([5, 64, 63], dtype=torch.int32)
    with pytest.raises(ValueError, match="bucket outside"):
        ops.sketch_scatter_or(words, v, b)
    assert not words.any()
    ops.sketch_scatter_or(store.words, v, b, bad=store.fold_error)
    assert store.fold_error.tolist() == [1]
    assert store.words[1, 0] == 1 << 5 and store.words[3, 1] == -(1 << 31)
    assert not store.words[2].any()
    with pytest.raises(ValueError, match="outside"):
        store.select(3)
    with pytest.raises(ValueError, match="outside"):
        store.append_batch((np.array([[1, 2]]), np.array([2])))
    clean = tcov.SketchRRStore(10, sketch_k=64, device=CPU)
    clean.append_batch((np.array([[1, 2]]), np.array([2])))
    assert clean.fold_error.tolist() == [0]
    assert clean.select(2).seeds.tolist() == [1, 0]     # 2 adds no bucket
