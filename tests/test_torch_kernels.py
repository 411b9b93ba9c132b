"""Kernels of the torch port against the JAX reference.

The hash and the plain Occur versions are integer functions, so every
comparison here is exact.  The reference's Pallas kernels run in interpret
mode on the CPU (``repro.kernels.ops`` picks it), called directly, outside
``shard_map``.  The CUDA kernels are held to the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bernoulli as jbern, ops as jops, ref as jref
from repro_torch.kernels import bernoulli as tbern, bitset as tbitset
from repro_torch.kernels import ops as tops, ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def _u32_words(shape, rng=RNG):
    """Random uint32 words with bit 31 set in about half of them."""
    return rng.integers(0, 1 << 32, size=shape, dtype=np.int64).astype(
        np.uint32)


def _t(words_u32):
    return torch.tensor(words_u32.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789])
def test_counter_uniform_bit_exact(seed):
    counters = np.concatenate([
        np.arange(0, 4096), (1 << 31) + np.arange(-64, 64),
        [0xFFFFFFFE, 0xFFFFFFFF],
        RNG.integers(0, 1 << 32, size=4096)]).astype(np.uint32)
    want = np.asarray(jref.counter_uniform_u32_ref(
        seed, jnp.asarray(counters))).astype(np.int64)
    got = tbern.counter_uniform_u32(seed, torch.tensor(
        counters.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tref.counter_uniform_u32_ref(
        seed, torch.tensor(counters.astype(np.int64))).numpy(), want)
    # tensor seeds broadcast the same way
    got2 = tbern.counter_uniform_u32(
        torch.full((counters.size,), seed, dtype=torch.int64),
        torch.tensor(counters.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got2, want)


def test_hash_mix_bit_exact():
    x = _u32_words(8192)
    want = np.asarray(jbern.hash_mix(jnp.asarray(x))).astype(np.int64)
    got = tbern.hash_mix(torch.tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF])
def test_edge_trial_matches_reference_bernoulli(seed):
    """The sampler's edge trial, float32(hash) * 2^-32 < w, equals the
    reference's bernoulli_edges_ref bit for bit (same float rounding)."""
    w = RNG.uniform(size=20000).astype(np.float32)
    want = np.asarray(jref.bernoulli_edges_ref(jnp.asarray(w), seed))
    bits = tbern.counter_uniform_u32(seed, torch.arange(w.size))
    got = (bits.to(torch.float32) * 2.0 ** -32 < torch.tensor(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_popcount_words_equal():
    x = _u32_words((37, 19))
    want = np.asarray(jref.popcount_words_ref(jnp.asarray(x)))
    np.testing.assert_array_equal(tref.popcount_words_ref(_t(x)).numpy(),
                                  want)


@pytest.mark.parametrize("b,w", [(8, 1), (64, 4), (37, 7), (256, 3)])
def test_occur_plain_equals_reference(b, w):
    x = _u32_words((b, w))
    assert (x >> 31).any()
    got = tref.occur_from_bitset_ref(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.occur_from_bitset(jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, np.asarray(jref.occur_from_bitset_ref(jnp.asarray(x))))
    assert got.dtype == np.int32 and got.shape == (w * 32,)


@pytest.mark.parametrize("b,w", [(8, 1), (64, 4), (37, 7)])
def test_occur_masked_plain_equals_reference(b, w):
    x = _u32_words((b, w))
    mask = RNG.integers(0, 2, size=b).astype(np.int32)
    want = np.asarray(jops.occur_from_bitset_masked(jnp.asarray(x),
                                                    jnp.asarray(mask)))
    for m in (torch.tensor(mask), torch.tensor(mask.astype(bool))):
        np.testing.assert_array_equal(
            tref.occur_from_bitset_masked_ref(_t(x), m).numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jref.occur_from_bitset_ref(
            jnp.asarray(x[mask.astype(bool)]))))


def test_occur_plain_blocks_rows():
    """A matrix larger than one row block sums across blocks exactly."""
    x = _u32_words((300, 2))
    old = tref._OCCUR_ELEMS
    try:
        tref._OCCUR_ELEMS = 64 * 2 * 32           # blocks of 64 rows
        got = tref.occur_from_bitset_ref(_t(x)).numpy()
    finally:
        tref._OCCUR_ELEMS = old
    np.testing.assert_array_equal(got, tref.occur_from_bitset_ref(_t(x)).numpy())


def test_ops_dispatch_cpu_and_unknown_device():
    x = _u32_words((16, 3))
    tops.reset_launch_counts()
    np.testing.assert_array_equal(
        tops.occur_from_bitset(_t(x)).numpy(),
        tref.occur_from_bitset_ref(_t(x)).numpy())
    m = torch.ones(16, dtype=torch.bool)
    np.testing.assert_array_equal(
        tops.occur_from_bitset_masked(_t(x), m).numpy(),
        tref.occur_from_bitset_ref(_t(x)).numpy())
    assert tops.launch_counts() == {"occur_from_bitset": 0,
                                    "occur_from_bitset_masked": 0,
                                    "pack_bits": 0, "bitset_or": 0,
                                    "bitset_andnot": 0, "popcount_words": 0,
                                    "sketch_scatter_or": 0,
                                    "sketch_union_popcount": 0,
                                    "bernoulli_edges": 0,
                                    "membership_rows": 0,
                                    "flash_attention": 0, "queue_bfs": 0,
                                    "greedy_flat": 0,
                                    "greedy_flat_variant": 0,
                                    "greedy_flat_variant[weighted]": 0,
                                    "greedy_sketch": 0,
                                    "celf_eval": 0, "celf_apply": 0,
                                    "celf_eval[weighted]": 0,
                                    "celf_apply[weighted]": 0,
                                    "celf_select": 0, "frontier_update": 0,
                                    "sketch_fold_rows": 0,
                                    "padded_greedy": 0, "lt_walk": 0,
                                    "refill_bfs": 0, "greedy_stacked": 0,
                                    "occur_flat": 0, "shard_flat_step": 0}
    with pytest.raises(ValueError, match="no kernel"):
        tops.occur_from_bitset(torch.zeros(4, 1, dtype=torch.int32,
                                           device="meta"))


def test_cuda_wrapper_rejects_cpu_tensors_before_building():
    x = _t(_u32_words((4, 2)))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbitset.occur_from_bitset(x)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbitset.occur_from_bitset_masked(x, torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda x: tbitset.pack_bits(torch.zeros(4, 64, dtype=torch.bool)),
    lambda x: tbitset.bitset_or(x, x),
    lambda x: tbitset.bitset_andnot(x, x),
    lambda x: tbitset.popcount_words(x),
    lambda x: tbern.bernoulli_edges(torch.ones(8), 3)],
    ids=["pack_bits", "bitset_or", "bitset_andnot", "popcount_words",
         "bernoulli_edges"])
def test_dense_kernel_wrappers_reject_cpu_tensors(call):
    """The new wrappers raise on a CPU tensor before building anything;
    ``ops`` sends such tensors to the plain versions instead."""
    with pytest.raises(ValueError, match="CUDA kernel"):
        call(_t(_u32_words((4, 2))))


def test_ops_dispatch_of_dense_kernels_on_cpu_and_unknown_device():
    x = _t(_u32_words((16, 3)))
    bits = torch.tensor(RNG.integers(0, 2, (16, 96)).astype(bool))
    w = torch.tensor(RNG.uniform(size=50).astype(np.float32))
    tops.reset_launch_counts()
    assert torch.equal(tops.pack_bits(bits), tref.pack_bits_ref(bits))
    assert torch.equal(tops.bitset_or(x, x.flip(0)), x | x.flip(0))
    assert torch.equal(tops.bitset_andnot(x, x.flip(0)), x & ~x.flip(0))
    assert torch.equal(tops.popcount_words(x), tref.popcount_words_ref(x))
    assert torch.equal(tops.bernoulli_edges(w, 5),
                       tref.bernoulli_edges_ref(w, 5))
    assert not any(tops.launch_counts().values())
    meta = torch.zeros(4, 1, dtype=torch.int32, device="meta")
    for call in (lambda: tops.bitset_or(meta, meta),
                 lambda: tops.popcount_words(meta),
                 lambda: tops.bernoulli_edges(meta.float()[:, 0], 1)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def test_rows_per_chunk_respects_grid_limits():
    for rows, cols in [(1, 1), (131072, 2372), (10 ** 7, 1), (5, 10 ** 5)]:
        per = tbitset.rows_per_chunk(rows, cols)
        assert per >= 1 and -(-rows // per) <= 65535
