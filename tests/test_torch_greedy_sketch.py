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
``torch.argmax`` at each step and against the plain version: the rows'
lane groups (``sketch_layout``), each group's first maximum over its rows,
the warp and block maxima of the 64-bit keys with the score shifted by one,
the atomicMax over the blocks, picked nodes left out, the running popcount
of cov, and the stop when no node is left.
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

@pytest.mark.parametrize("cols,aligned,lanes,vector", [
    (1, True, 1, False), (3, True, 1, False), (4, True, 1, True),
    (4, False, 1, False), (5, True, 8, False), (8, True, 2, True),
    (8, False, 8, False), (32, True, 8, True), (128, True, 32, True),
    (512, True, 32, True), (60_000, True, 32, True), (97, True, 32, False)])
def test_sketch_layout(cols, aligned, lanes, vector):
    assert tgreedy.sketch_layout(cols, aligned) == (lanes, vector)


def test_sketch_scratch_bytes():
    """Keys and flags alone while cov fits in shared memory; past it, each
    block's copy of cov (rounded to 4 words) from a 16-byte boundary."""
    assert tgreedy.sketch_scratch_bytes(75_879, 4, 50, 132, 58_080) == \
        8 * 50 + 75_879
    assert tgreedy.sketch_scratch_bytes(7, 58_080, 3, 132, 58_080) == 31
    wide = tgreedy.sketch_scratch_bytes(7, 58_081, 3, 132, 58_080)
    assert wide == 32 + 4 * 132 * 58_084


def _popcounts(words, cov):
    """popcount(words[v] | cov) summed over a row, as int64."""
    return ref.sketch_union_popcount_ref(words, cov).to(torch.int64)


def _redux_max_key(occ, low):
    """Two redux.sync maxima over the last axis (the largest occ, then the
    largest low among the entries that hold it) -> key."""
    best = occ.max(dim=-1).values
    first = torch.where(occ == best[..., None], low, 0).max(dim=-1).values
    return (best << 32) | first


def kernel_step_key(score, picked, blocks, lanes):
    """One step's argmax as the kernel makes it on ``blocks`` blocks of
    THREADS: group g of ``lanes`` lanes folds rows v = g, g + G, ... (G the
    grid's groups) in order, a picked row taking no part and a later row
    winning only on a larger score; the group's first lane holds its
    (score, low = 0xFFFFFFFF - v) pair, the others (0, 0); warps and then
    blocks reduce by two maxima, and an atomicMax over the blocks' keys.
    ``score`` is already shifted by one.  Returns the key."""
    n = score.shape[0]
    gsize = blocks * THREADS
    groups = gsize // lanes
    slots = -(-n // groups) * groups
    occ = torch.zeros(slots, dtype=torch.int64)
    low = torch.zeros(slots, dtype=torch.int64)
    live = ~picked
    occ[:n] = torch.where(live, score, 0)
    low[:n] = torch.where(live, MASK32 - torch.arange(n, dtype=torch.int64),
                          0)
    occ, low = occ.view(-1, groups), low.view(-1, groups)   # (pass, group)
    g_occ, g_low = occ[0].clone(), low[0].clone()
    for p in range(1, occ.shape[0]):
        take = (low[p] != 0) & ((g_low == 0) | (occ[p] > g_occ))
        g_occ = torch.where(take, occ[p], g_occ)
        g_low = torch.where(take, low[p], g_low)
    t_occ = torch.zeros(gsize, dtype=torch.int64)
    t_low = torch.zeros(gsize, dtype=torch.int64)
    t_occ[::lanes], t_low[::lanes] = g_occ, g_low
    warp = _redux_max_key(t_occ.view(blocks, THREADS // 32, 32),
                          t_low.view(blocks, THREADS // 32, 32))
    block = _redux_max_key(warp >> 32, warp & MASK32)
    return int(block.max())


def kernel_replay(words, *, n, k, blocks):
    """The kernel's steps in torch: each step's key (:func:`kernel_step_key`)
    over the scores popcount(words[v] | cov) - base + 1, base the running
    sum of the gains; a step whose key has a high word of 0 stops the
    greedy; else u and its gain come off the key (checked against
    ``torch.argmax`` of the plain score), u's owner group is the one whose
    rows hold it, and cov takes u's row.  The steps not taken hold n and
    0."""
    lanes, _ = tgreedy.sketch_layout(words.shape[1], True)
    groups = blocks * THREADS // lanes
    cov = torch.zeros(words.shape[1], dtype=torch.int32)
    picked = torch.zeros(n, dtype=torch.bool)
    seeds = torch.full((k,), n, dtype=torch.int32)
    gains = torch.zeros(k, dtype=torch.int32)
    base = steps = 0
    for s in range(k):
        cnt = _popcounts(words[:n], cov)
        assert int(cnt.min()) >= base                # base = popcount(cov)
        key = kernel_step_key(cnt - base + 1, picked, blocks, lanes)
        plain = torch.where(picked, -1, cnt - base)
        want = int(torch.argmax(plain))
        if key >> 32 == 0:
            assert int(plain[want]) < 0              # every node is picked
            break
        u, gain = MASK32 - (key & MASK32), (key >> 32) - 1
        assert (u, gain) == (want, int(plain[want]))
        assert u in range(u % groups, n, groups)     # its owner's rows
        seeds[s], gains[s] = u, gain
        picked[u] = True
        cov |= words[u]
        base += gain
        steps = s + 1
    return seeds, gains, torch.tensor([steps], dtype=torch.int32)


def _case_words(case, n, cols, rng):
    """(n + 1, cols) int32 sketch words: ``bit31`` random words (bit 31 in
    about half), ``ties`` one bit a row among few buckets (many equal
    scores), ``saturated`` a few rows of all ones among sparse ones (every
    delta is 0 once one of them is picked)."""
    if case == "bit31":
        u = rng.integers(0, 1 << 32, size=(n + 1, cols), dtype=np.int64)
        return torch.from_numpy(u.astype(np.uint32).view(np.int32))
    words = np.zeros((n + 1, cols), np.uint32)
    bucket = rng.integers(0, min(8, 32 * cols), n + 1)
    words[np.arange(n + 1), bucket >> 5] = np.uint32(1) << (bucket & 31)
    if case == "saturated":
        words[rng.choice(n, 3, replace=False)] = MASK32
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("cols", [1, 4, 5, 512])
@pytest.mark.parametrize("case", ["ties", "saturated", "bit31", "past_n"])
def test_kernel_replay_equals_plain_and_argmax(case, cols, blocks):
    rng = np.random.default_rng(len(case) * 31 + cols + blocks)
    if case == "past_n":
        n, k = 7, 10
        words = _case_words("bit31", n, cols, rng)
    else:
        n = 3_001 if cols == 512 else (70_001 if blocks == 132 else 5_003)
        k = 8
        words = _case_words(case, n, cols, rng)
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
