"""Coverage sketches of the torch port against the JAX reference.

Every comparison is exact (tolerance 0): the plain union popcount against
the reference's Pallas kernel in interpret mode (called directly, outside
``shard_map``); the plain scatter-OR against the reference's sort-based
``scatter_or_bits`` and against the Pallas kernel's body replayed in numpy,
because under jax 0.9 that kernel no longer traces (``pl.load`` is gone;
ROADMAP Queue 3 item 3); ``core/sketch.py`` against
``repro.core.sketch``, the pool-free ``SketchRRStore`` against the
reference's on the same JAX-sampled batches, and ``select_seeds_sketch``
against the reference's (seeds, gains, float32 ``frac`` and the whole
certificate) in the exact, estimate and saturated regimes.  Packed words
are uint32 in the reference and int32 in the port; they are compared bit
for bit.  The CUDA kernels are held to the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import coverage as jcov, sketch as jsketch
from repro.core.engine import make_engine
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro.kernels import sketch as jks
from repro_torch import convert
from repro_torch.core import coverage as tcov, sketch as tsketch
from repro_torch.kernels import ops as tops, ref as tref, sketch as tks

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
RNG = np.random.default_rng(12)


def _u32_words(shape, rng=RNG):
    """Random uint32 words with bit 31 set in about half of them."""
    return rng.integers(0, 1 << 32, size=shape, dtype=np.int64).astype(
        np.uint32)


def _t(words_u32):
    return torch.tensor(words_u32.view(np.int32))


def _bits(x):
    """int32 view of reference uint32 words."""
    return np.asarray(x).view(np.int32)


def _pairs(rng, r, w, e):
    """(v, bucket) pairs with every edge case the kernel meets: bit 31
    (``b & 31 == 31``), duplicates, and rows -1 and R (both dropped)."""
    v = rng.integers(-1, r + 1, e)
    b = rng.integers(0, 32 * w, e)
    v[:4] = [-1, r, 0, r - 1]
    b[2:4] = [31, 32 * w - 1]
    dup = rng.integers(0, e, e // 4)
    v[-len(dup):], b[-len(dup):] = v[dup], b[dup]
    return v.astype(np.int32), b.astype(np.int32)


# ------------------------------------------------------------ plain kernels

def _pallas_scatter_or(words, v, b):
    """``repro.kernels.sketch._scatter_or`` and its kernel body, replayed in
    numpy: invalid pairs become bit 0 at (0, 0), then a serial
    read-modify-write loop over the pairs."""
    r = words.shape[0]
    valid = (v >= 0) & (v < r)
    v_safe = np.where(valid, v, 0)
    wi = np.where(valid, b >> 5, 0)
    bit = np.where(valid, np.uint32(1) << (b & 31).astype(np.uint32),
                   np.uint32(0)).astype(np.uint32)
    out = words.copy()
    for e in range(v.shape[0]):
        out[v_safe[e], wi[e]] |= bit[e]
    return out


@pytest.mark.parametrize("r,w,e", [(1, 1, 8), (5, 1, 40), (8, 2, 64),
                                   (13, 4, 64), (3, 16, 48)])
def test_scatter_or_plain_equals_reference(r, w, e):
    rng = np.random.default_rng(r * 100 + w)
    words = _u32_words((r, w), rng)
    words[0, 0] &= 0x7FFFFFFF                 # leave bit 31 unset somewhere
    v, b = _pairs(rng, r, w, e)
    for start in (words, np.zeros_like(words)):
        want = _pallas_scatter_or(start, v, b).view(np.int32)
        port = _t(start)
        got = tref.sketch_scatter_or_ref(port, torch.tensor(v),
                                         torch.tensor(b))
        assert got is port                     # in place
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tops.sketch_scatter_or(_t(start), torch.tensor(v),
                                   torch.tensor(b.astype(np.int64))).numpy(),
            want)
        # the sort-based fold of the reference agrees where it drops the
        # same pairs (it wraps v = -1 to row R-1, as JAX indexing does)
        keep = v >= 0
        np.testing.assert_array_equal(
            _bits(jsketch.scatter_or_bits(jnp.asarray(start),
                                          jnp.asarray(v[keep]),
                                          jnp.asarray(b[keep]))),
            tref.sketch_scatter_or_ref(_t(start), torch.tensor(v[keep]),
                                       torch.tensor(b[keep])).numpy())
    assert (want < 0).any()                    # bit 31 set from zeros


def test_scatter_or_plain_edge_cases():
    words = torch.zeros(3, 2, dtype=torch.int32)
    same = tref.sketch_scatter_or_ref(words, torch.tensor([], dtype=torch.int32),
                                      torch.tensor([], dtype=torch.int32))
    assert same is words and not words.any()
    tref.sketch_scatter_or_ref(words, torch.tensor([-1, 3, 7]),
                               torch.tensor([1, 2, 3]))
    assert not words.any()                     # every row out of range
    for bad in ([-1], [64]):
        with pytest.raises(ValueError, match="bucket outside"):
            tref.sketch_scatter_or_ref(words, torch.tensor([0]),
                                       torch.tensor(bad))


@pytest.mark.parametrize("r,w", [(1, 1), (37, 4), (64, 7), (300, 16),
                                 (9, 33)])
def test_union_popcount_plain_equals_pallas(r, w):
    rng = np.random.default_rng(r + w)
    words = _u32_words((r, w), rng)
    cov = _u32_words((w,), rng)
    cov[0] |= 0x80000000
    want = np.asarray(jks.sketch_union_popcount(
        jnp.asarray(words), jnp.asarray(cov), interpret=True))
    got = tref.sketch_union_popcount_ref(_t(words), _t(cov))
    assert got.dtype == torch.int32 and got.shape == (r,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.sketch_union_popcount(_t(words), _t(cov)).numpy(), want)
    # Δocc of core/sketch.py against the reference's union_gains
    np.testing.assert_array_equal(
        tsketch.union_gains(_t(words), _t(cov)).numpy(),
        np.asarray(jsketch.union_gains(jnp.asarray(words), jnp.asarray(cov),
                                       interpret=True)))


def test_ops_dispatch_counts_no_cpu_launch_and_wrappers_need_card():
    tops.reset_launch_counts()
    words = _t(_u32_words((6, 2)))
    tops.sketch_scatter_or(words, torch.tensor([1]), torch.tensor([3]))
    tops.sketch_union_popcount(words, words[0].clone())
    assert tops.launch_counts() == {
        "occur_from_bitset": 0, "occur_from_bitset_masked": 0,
        "pack_bits": 0, "bitset_or": 0, "bitset_andnot": 0,
        "popcount_words": 0, "sketch_scatter_or": 0,
        "sketch_union_popcount": 0, "bernoulli_edges": 0,
        "membership_rows": 0, "flash_attention": 0, "queue_bfs": 0,
        "greedy_flat": 0, "greedy_flat_variant": 0, "greedy_sketch": 0,
        "greedy_flat_variant[weighted]": 0, "celf_eval": 0,
        "celf_apply": 0, "celf_eval[weighted]": 0,
        "celf_apply[weighted]": 0, "celf_select": 0, "frontier_update": 0,
        "sketch_fold_rows": 0, "padded_greedy": 0, "lt_walk": 0,
        "refill_bfs": 0, "greedy_stacked": 0, "occur_flat": 0,
        "shard_flat_step": 0}
    with pytest.raises(ValueError, match="CUDA kernel"):
        tks.sketch_scatter_or(words, torch.tensor([1]), torch.tensor([3]))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tks.sketch_union_popcount(words, words[0].clone())


# ------------------------------------------------------------ core/sketch.py

@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("k", [32, 128, 4096, 96])
def test_bucket_of_equal(mode, k):
    ids = np.concatenate([np.arange(0, 5000), RNG.integers(0, 2 ** 31 - 1,
                                                           5000),
                          [2 ** 31 - 1, 2 ** 31 - 2, 1 << 30]]).astype(
        np.int32)
    want = np.asarray(jsketch.bucket_of(jnp.asarray(ids), k, mode))
    got = tsketch.bucket_of(torch.tensor(ids), k, mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "mix":       # the product wraps past 2^32 for these ids
        assert (ids.astype(np.int64) * 2654435761 >= 2 ** 32).any()
    with pytest.raises(ValueError):
        tsketch.bucket_of(torch.tensor(ids), k, "bogus")


def test_sizes_and_linear_counting_equal():
    for k in (1, 31, 32, 33, 100, 1024, 1025):
        assert tsketch.resolve_sketch_k(k) == jsketch.resolve_sketch_k(k)
    with pytest.raises(ValueError):
        tsketch.resolve_sketch_k(0)
    for eps in (0.05, 0.1, 0.3, 0.5, 0.9):
        for n in (10, 100, 600, 75879, 10 ** 7):
            assert tsketch.auto_sketch_k(eps, n) == \
                jsketch.auto_sketch_k(eps, n)
    assert tsketch.auto_sketch_k(0.5, 75879) == 128
    with pytest.raises(ValueError):
        tsketch.auto_sketch_k(1.0, 10)
    for k in (64, 128, 4096):
        occ = np.concatenate([np.arange(0, k + 3), RNG.integers(0, k, 50)])
        np.testing.assert_array_equal(tsketch.linear_count(occ, k),
                                      jsketch.linear_count(occ, k))
        for a, b in zip(tsketch.linear_count_saturated(occ, k),
                        jsketch.linear_count_saturated(occ, k)):
            np.testing.assert_array_equal(a, b)
        est = tsketch.linear_count(occ, k)
        for z in (1.0, 3.0):
            np.testing.assert_array_equal(
                tsketch.linear_count_rel_error(est, k, z=z),
                jsketch.linear_count_rel_error(est, k, z=z))


def _random_batch(rng, n, count, max_len=9):
    """Padded batch with empty rows; node ids past 31 set bit 31 words."""
    lens = rng.integers(0, max_len, count)
    nodes = np.full((count, max(int(lens.max()), 1)), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    return nodes, lens


@pytest.mark.parametrize("mode", ["mod", "mix"])
@pytest.mark.parametrize("k,base", [(64, 0), (128, 37), (256, 2 ** 31 - 90)])
def test_fold_frontier_packed_equal(mode, k, base):
    rng = np.random.default_rng(k)
    n = 70
    nodes, lens = _random_batch(rng, n, 61)
    words = _u32_words((n + 1, k // 32), rng)
    want = np.asarray(jsketch.fold_frontier_packed(
        jnp.asarray(words), jnp.asarray(nodes), jnp.asarray(lens),
        jnp.int32(base), k=k, mode=mode, interpret=True))
    batch_want = np.asarray(jsketch.fold_batch_packed(
        jnp.asarray(words), jnp.asarray(nodes), jnp.asarray(lens),
        jnp.int32(base), k=k, mode=mode))
    port = _t(words)
    got = tsketch.fold_frontier_packed(port, torch.tensor(nodes),
                                       torch.tensor(lens), base, k=k,
                                       mode=mode)
    assert got is port
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    np.testing.assert_array_equal(want, batch_want)


def test_scatter_or_bits_copies_and_equals_reference():
    rng = np.random.default_rng(5)
    words = _u32_words((9, 3), rng)
    v = rng.integers(0, 10, 60).astype(np.int32)      # row 9 = sentinel
    b = rng.integers(0, 96, 60).astype(np.int32)
    want = _bits(jsketch.scatter_or_bits(jnp.asarray(words), jnp.asarray(v),
                                         jnp.asarray(b)))
    src = _t(words)
    got = tsketch.scatter_or_bits(src, torch.tensor(v), torch.tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), words.view(np.int32))


# ------------------------------------------------------------ the store

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


def _both_sketch_stores(n, batches, sketch_k, mode="mod"):
    ref = jcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode)
    port = tcov.SketchRRStore(n, sketch_k=sketch_k, sketch_mode=mode,
                              device=CPU)
    for nodes, lens in batches:
        ref.append_batch((nodes, lens))
        port.append_batch(convert.batch_from_arrays(
            nodes, lens, np.zeros(len(lens), bool), 0, device=CPU))
    return ref, port


@pytest.mark.parametrize("sketch_k,mode", [(32, "mod"), (256, "mod"),
                                           (1024, "mod"), (256, "mix")])
def test_sketch_store_equals_reference(jax_batches, sketch_k, mode):
    ref, port = _both_sketch_stores(300, jax_batches, sketch_k, mode)
    assert port.n_rr == ref.n_rr and port.n_elems == ref.n_elems
    assert port.sketch_bytes() == ref.sketch_bytes()
    assert port.per_device_pool_bytes() == 0
    want = np.asarray(ref.sketch_words())
    assert want.shape == (301, sketch_k // 32)
    np.testing.assert_array_equal(port.words.numpy(), want.view(np.int32))
    assert (port.words < 0).any()                    # bit 31 present
    # the reference's state, carried over, rebuilds the same store
    st, cfg = ref.state(), ref.config()
    again = tcov.SketchRRStore.from_state(
        {"sk_words": convert.sketch_words_from_arrays(st["sk_words"][0],
                                                      device=CPU),
         "t_loc": st["t_loc"], "nrr_loc": st["nrr_loc"]}, cfg, device=CPU)
    assert torch.equal(again.words, port.words)
    assert (again.n_rr, again.n_elems) == (port.n_rr, port.n_elems)
    assert again.config() == cfg


def test_sketch_store_pads_empty_rows_and_rejects_bad_input():
    rng = np.random.default_rng(8)
    n = 50
    batches = [_random_batch(rng, n, 61) for _ in range(4)]
    ref, port = _both_sketch_stores(n, batches, 256)
    np.testing.assert_array_equal(port.words.numpy(),
                                  _bits(ref.sketch_words()))
    assert port.n_rr < sum(len(l) for _, l in batches)   # empties dropped
    with pytest.raises(ValueError):
        port.append_batch((np.zeros(5, np.int64), np.ones(5, np.int64)))
    state = {"sk_words": port.words, "t_loc": [port.n_elems],
             "nrr_loc": [port.n_rr]}
    with pytest.raises(ValueError, match="shards"):
        tcov.SketchRRStore.from_state(state, dict(port.config(), n_shards=8),
                                      device=CPU)
    with pytest.raises(ValueError, match="int32"):
        tcov.SketchRRStore.from_state(dict(state, sk_words=port.words[1:]),
                                      port.config(), device=CPU)


def test_sketch_packed_from_flat_equals_reference(jax_batches):
    n = 300
    exact = tcov.DeviceRRStore(n, device=CPU)
    for nodes, lens in jax_batches:
        exact.append_batch((nodes, lens))
    t = exact.n_elems
    for k, mode in ((1024, "mod"), (64, "mix")):
        want = _bits(jsketch.sketch_packed_from_flat(
            jnp.asarray(exact.flat[:t].numpy()),
            jnp.asarray(exact.ids[:t].numpy()),
            jnp.asarray(exact.valid[:t].numpy()), n_rows=n + 1, k=k,
            mode=mode))
        got = tsketch.sketch_packed_from_flat(
            exact.flat[:t], exact.ids[:t], exact.valid[:t], n_rows=n + 1,
            k=k, mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ selection

@pytest.mark.parametrize("sketch_k,k,regime", [
    (1024, 6, "exact"), (512, 3, "estimate"), (256, 4, "estimate"),
    (32, 5, "saturated")])
def test_select_seeds_sketch_equals_reference(jax_batches, sketch_k, k,
                                              regime):
    ref, port = _both_sketch_stores(300, jax_batches, sketch_k)
    info_ref, info_port = {}, {}
    want = jcov.select_seeds_sketch(ref, k, info_out=info_ref)
    got = port.select(k, info_out=info_port)
    np.testing.assert_array_equal(got.seeds.numpy(), np.asarray(want.seeds))
    np.testing.assert_array_equal(got.gains.numpy(), np.asarray(want.gains))
    assert got.frac.dtype == torch.float32
    assert got.frac.numpy().tobytes() == np.asarray(want.frac).tobytes()
    assert info_port == info_ref
    assert info_port["exact_regime"] == (regime == "exact")
    assert info_port["saturated"] == (regime == "saturated")


def test_exact_regime_sketch_selection_equals_flat(jax_batches):
    """n_rr <= sketch_k under "mod": Δocc is the exact marginal, so the
    sketch greedy gives the flat scan's seeds, gains and frac."""
    n = 300
    exact = tcov.DeviceRRStore(n, device=CPU)
    _, port = _both_sketch_stores(n, jax_batches, 1024)
    for nodes, lens in jax_batches:
        exact.append_batch((nodes, lens))
    assert port.n_rr == exact.n_rr <= 1024
    flat = exact.select(8, method="flat")
    info = {}
    sk = port.select(8, info_out=info)
    assert (flat.gains > 0).all()
    assert torch.equal(sk.seeds, flat.seeds)
    assert torch.equal(sk.gains, flat.gains)
    assert sk.frac.numpy().tobytes() == flat.frac.numpy().tobytes()
    assert info["lo_rows"] == info["hi_rows"] == info["occ_union"]


def test_sketch_selection_ties_and_padding():
    """Equal Δocc picks the lowest id; past the last candidate the seeds
    pad with the sentinel n and gain 0."""
    n = 4
    store = tcov.SketchRRStore(n, sketch_k=32, device=CPU)
    store.append_batch((np.array([[3, 2], [2, 3], [1, 3]]),
                        np.array([2, 2, 2])))
    res = store.select(6)
    assert res.seeds.tolist() == [3, 0, 1, 2, 4, 4]
    assert res.gains.tolist() == [3, 0, 0, 0, 0, 0]
