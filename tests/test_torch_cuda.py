"""Tests of the torch port that need a CUDA card: the hand-written kernels
against their plain versions, and the main path on the card against the
same path on the CPU.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the decision is made in the ``card``
fixture, never at import).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import coverage as cov
from repro_torch.core import dense
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.core.engine import QueueEngine
from repro_torch.core.rrset import round_seed, sample_rrsets_queue, to_lists
from repro_torch.core.sketch import bucket_of
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import bernoulli as tbern, bitset as tbitset
from repro_torch.kernels import flashattn as tflash
from repro_torch.kernels import greedy as tgreedy
from repro_torch.kernels import membership as tmem
from repro_torch.kernels import queue as tqueue
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import sketch as tsketch

RNG = np.random.default_rng(0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `PYTHONPATH=src python -m pytest "
                    "-m cuda tests/test_torch_cuda.py` on the H100")
    return torch.device("cuda")


def _words(b, w):
    """Random int32 words with bit 31 set in about half of them."""
    u = RNG.integers(0, 1 << 32, size=(b, w), dtype=np.int64)
    return torch.tensor(u.astype(np.uint32).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", [(1, 1), (33, 5), (1000, 130), (4096, 75),
                                 (70000, 3)])
def test_occur_kernels_equal_plain(card, b, w):
    x = _words(b, w).to(card)
    mask = torch.tensor(RNG.integers(0, 2, size=b).astype(np.int32),
                        device=card)
    before = ops.launch_counts()
    got = ops.occur_from_bitset(x)
    gotm = ops.occur_from_bitset_masked(x, mask)
    gotb = ops.occur_from_bitset_masked(x, mask.bool())
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["occur_from_bitset"] == before["occur_from_bitset"] + 1
    assert after["occur_from_bitset_masked"] == \
        before["occur_from_bitset_masked"] + 2
    assert torch.equal(got, ref.occur_from_bitset_ref(x))
    assert torch.equal(got.cpu(), ref.occur_from_bitset_ref(x.cpu()))
    want = ref.occur_from_bitset_masked_ref(x, mask)
    assert torch.equal(gotm, want) and torch.equal(gotb, want)


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(card):
    x = torch.zeros(8, 4, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        tbitset.occur_from_bitset(x.to(torch.int64))
    with pytest.raises(ValueError):
        tbitset.occur_from_bitset(x.t())
    with pytest.raises(ValueError):
        tbitset.occur_from_bitset(x.reshape(-1))
    with pytest.raises(TypeError):
        tbitset.occur_from_bitset_masked(
            x, torch.ones(7, dtype=torch.int32, device=card))


def _graph(device):
    src, dst = generators.barabasi_albert(1500, 4, seed=3)
    return weights.wc_weights(csr.from_edges(src, dst, 1500, device=device))


@pytest.mark.cuda
def test_sampler_on_card_equals_cpu(card):
    """The counter hash makes the RR sets a function of the seed alone:
    the card and the CPU sample the same sets in the same order."""
    g_rev = {d: csr.coalesce_ic(csr.reverse(_graph(d))) for d in ("cpu", card)}
    a = sample_rrsets_queue(g_rev["cpu"], 256, 77, dedup="none")
    b = sample_rrsets_queue(g_rev[card], 256, 77, dedup="none")
    assert to_lists(a) == to_lists(b)
    assert a.steps == b.steps


@pytest.mark.cuda
def test_bitset_solve_on_card_equals_cpu_fused(card):
    cpu = IMMSolver(_graph("cpu"), batch=256, selection="fused", seed=4,
                    device="cpu").solve(IMProblem(k=10, eps=0.4))
    ops.reset_launch_counts()
    gpu = IMMSolver(_graph(card), batch=256, selection="bitset", seed=4,
                    device=card).solve(IMProblem(k=10, eps=0.4))
    counts = ops.launch_counts()
    assert counts["occur_from_bitset"] > 0
    assert counts["occur_from_bitset_masked"] > 0
    np.testing.assert_array_equal(gpu.seeds, cpu.seeds)
    np.testing.assert_array_equal(gpu.gains, cpu.gains)
    assert gpu.frac == cpu.frac and gpu.stats.theta == cpu.stats.theta


def _pairs(r, w, e):
    """(v, bucket) int32 pairs with rows -1 and R (dropped), bit 31
    (b & 31 == 31) and duplicates."""
    v = RNG.integers(-1, r + 1, e)
    b = RNG.integers(0, 32 * w, e)
    v[:4] = [-1, r, 0, r - 1]
    b[2:4] = [31, 32 * w - 1]
    dup = RNG.integers(0, e, e // 4)
    v[-len(dup):], b[-len(dup):] = v[dup], b[dup]
    return (torch.tensor(v.astype(np.int32)),
            torch.tensor(b.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("r,w,e", [(1, 1, 16), (33, 4, 1000),
                                   (1000, 130, 50000), (4096, 512, 1 << 20),
                                   (75880, 4, 1 << 18), (5, 13000, 4000)])
def test_sketch_kernels_equal_plain(card, r, w, e):
    words = _words(r, w).to(card)
    cov_words = _words(1, w)[0].to(card)
    v, b = (x.to(card) for x in _pairs(r, w, e))
    before = ops.launch_counts()
    got = ops.sketch_scatter_or(words.clone(), v, b)
    want = ref.sketch_scatter_or_ref(words.clone(), v, b)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), ref.sketch_scatter_or_ref(
        words.cpu(), v.cpu(), b.cpu()))
    zero = torch.zeros_like(words)
    got0 = ops.sketch_scatter_or(zero, v, b)
    assert got0 is zero
    assert torch.equal(got0, ref.sketch_scatter_or_ref(
        torch.zeros_like(words), v, b))
    pop = ops.sketch_union_popcount(got, cov_words)
    assert torch.equal(pop, ref.sketch_union_popcount_ref(got, cov_words))
    assert torch.equal(pop.cpu(), ref.sketch_union_popcount_ref(
        got.cpu(), cov_words.cpu()))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["sketch_scatter_or"] == before["sketch_scatter_or"] + 2
    assert after["sketch_union_popcount"] == \
        before["sketch_union_popcount"] + 1


@pytest.mark.cuda
def test_sketch_wrappers_check_inputs(card):
    x = torch.zeros(8, 4, dtype=torch.int32, device=card)
    one = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="bucket outside"):
        tsketch.sketch_scatter_or(x, one, one + 128)
    with pytest.raises(ValueError, match="bucket outside"):
        tsketch.sketch_scatter_or(x, one + 99, one - 1)
    with pytest.raises(ValueError):
        tsketch.sketch_scatter_or(x, one, torch.zeros(2, dtype=torch.int32,
                                                      device=card))
    with pytest.raises(TypeError):
        tsketch.sketch_scatter_or(x.to(torch.int64), one, one)
    with pytest.raises(ValueError):
        tsketch.sketch_union_popcount(x, torch.zeros(3, dtype=torch.int32,
                                                     device=card))
    with pytest.raises(ValueError):
        tsketch.sketch_union_popcount(x.t(), one)


@pytest.mark.cuda
def test_sketch_selection_on_card_takes_lowest_id_on_ties(card):
    """Equal Δocc everywhere (a saturated 32-bucket sketch) and a planted
    tie: the card's argmax picks the lowest id, as the CPU's does."""
    res = {}
    nodes = torch.tensor(RNG.integers(0, 5000, (4096, 6)))
    for dev in ("cpu", card):
        store = cov.SketchRRStore(5000, sketch_k=32, device=dev)
        store.append_batch((nodes, torch.full((4096,), 6)))
        store.append_batch((torch.tensor([[4321, 17], [17, 4321]]),
                            torch.tensor([2, 2])))
        res[dev] = store.select(40)
    assert torch.equal(res[card].seeds.cpu(), res["cpu"].seeds)
    assert torch.equal(res[card].gains.cpu(), res["cpu"].gains)
    tie = cov.SketchRRStore(100, sketch_k=64, device=card)
    tie.append_batch((torch.tensor([[70, 9], [9, 70], [70, 9]]),
                      torch.tensor([2, 2, 2])))
    assert tie.select(2).seeds.tolist() == [9, 0]


@pytest.mark.cuda
def test_approximate_exact_regime_on_card_equals_bitset(card):
    g = _graph(card)
    bit = IMMSolver(g, batch=256, selection="bitset", seed=6,
                    device=card).solve(IMProblem(k=10, theta=2048))
    ops.reset_launch_counts()
    approx = IMMSolver(g, batch=256, seed=6, sketch_k=2048,
                       device=card).solve(IMProblem(k=10, theta=2048,
                                                    mode="approximate"))
    counts = ops.launch_counts()
    assert counts["sketch_fold_rows"] > 0 and counts["sketch_scatter_or"] == 0
    assert counts["greedy_sketch"] > 0 and counts["popcount_words"] == 0
    np.testing.assert_array_equal(approx.seeds, bit.seeds)
    np.testing.assert_array_equal(approx.gains, bit.gains)
    assert approx.frac == bit.frac
    lo, hi = approx.spread_bounds
    assert lo == hi == pytest.approx(approx.spread, rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", [(1, 1), (33, 5), (7, 2373), (512, 2372)])
def test_bit_kernels_equal_plain(card, b, w):
    """pack_bits, bitset_or/andnot and popcount_words, exact; W odd makes
    the flat word count ragged against the 16-byte loads, and the word
    slice ``[1:]`` of an odd W starts off their alignment."""
    bits = torch.tensor(RNG.integers(0, 2, (b + 1, 32 * w)).astype(bool))
    bits[:, 31::32] = True                        # bit 31 of every word
    x, y = _words(b + 1, w), _words(b + 1, w)
    before = ops.launch_counts()
    for lo in (0, 1):
        bb, xx, yy = (t[lo:].to(card) for t in (bits, x, y))
        got = ops.pack_bits(bb)
        assert torch.equal(got, ref.pack_bits_ref(bb))
        assert torch.equal(got.cpu(), ref.pack_bits_ref(bb.cpu()))
        assert torch.equal(ops.bitset_or(xx, yy), ref.bitset_or_ref(xx, yy))
        assert torch.equal(ops.bitset_andnot(xx, yy),
                           ref.bitset_andnot_ref(xx, yy))
        assert torch.equal(ops.popcount_words(xx).cpu(),
                           ref.popcount_words_ref(xx.cpu()))
    # bits that start one byte past a 16-byte boundary take the scalar form
    odd = torch.empty(bits.numel() + 1, dtype=torch.bool, device=card)[1:]
    odd = odd.view(bits.shape).copy_(bits.to(card))
    assert torch.equal(ops.pack_bits(odd).cpu(), ref.pack_bits_ref(bits))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("pack_bits", "bitset_or", "bitset_andnot", "popcount_words"):
        assert after[name] == before[name] + 2 + (name == "pack_bits")


@pytest.mark.cuda
@pytest.mark.parametrize("b,e", [(1, 1), (3, 1000003), (512, 60001)])
def test_bernoulli_kernel_equals_plain(card, b, e):
    """Exact, with weights of exactly 0 and 1, E ragged against the block,
    seeds holding bit 31, and the one-seed form."""
    w = RNG.uniform(size=e).astype(np.float32)
    w[::17], w[5::19] = 0.0, 1.0
    w = torch.tensor(w, device=card)
    seeds = torch.tensor(RNG.integers(0, 1 << 32, b), device=card)
    before = ops.launch_counts()["bernoulli_edges"]
    got = ops.bernoulli_edges(w, seeds)
    assert got.dtype == torch.bool and got.shape == (b, e)
    assert torch.equal(got, ref.bernoulli_edges_ref(w, seeds))
    one = ops.bernoulli_edges(w, int(seeds[0]))
    assert one.shape == (e,) and torch.equal(one, got[0])
    assert torch.equal(one.cpu(), ref.bernoulli_edges_ref(w.cpu(),
                                                          int(seeds[0])))
    torch.cuda.synchronize()
    assert ops.launch_counts()["bernoulli_edges"] == before + 2


@pytest.mark.cuda
def test_dense_kernel_wrappers_check_inputs(card):
    x = torch.zeros(8, 4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbitset.pack_bits(torch.zeros(2, 64, dtype=torch.bool))
    with pytest.raises(TypeError):
        tbitset.pack_bits(torch.zeros(2, 64, dtype=torch.uint8, device=card))
    with pytest.raises(ValueError, match="multiple of 32"):
        tbitset.pack_bits(torch.zeros(2, 33, dtype=torch.bool, device=card))
    with pytest.raises(TypeError):
        tbitset.bitset_or(x, x.to(torch.int64))
    with pytest.raises(ValueError):
        tbitset.bitset_andnot(x, x[:4])
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbitset.popcount_words(x.cpu())
    with pytest.raises(TypeError):
        tbitset.popcount_words(x.float())
    w = torch.ones(16, device=card)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbern.bernoulli_edges(w.cpu(), 1)
    with pytest.raises(TypeError):
        tbern.bernoulli_edges(w.double(), 1)
    with pytest.raises(TypeError):
        tbern.bernoulli_edges(w, torch.ones(3, device=card))


@pytest.mark.cuda
def test_packed_sampler_on_card_equals_cpu(card):
    g_rev = {d: csr.reverse(_graph(d)) for d in ("cpu", card)}
    ops.reset_launch_counts()
    got = dense.sample_rrsets_dense_packed(g_rev[card], 128, 21, base_seed=5)
    counts = ops.launch_counts()
    for name in ("pack_bits", "frontier_update", "popcount_words",
                 "bernoulli_edges", "occur_from_bitset"):
        assert counts[name] > 0, name
    assert counts["bitset_or"] == counts["bitset_andnot"] == 0
    want = dense.sample_rrsets_dense_packed(g_rev["cpu"], 128, 21,
                                            base_seed=5)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a.cpu(), b)
    assert got.levels == want.levels == counts["frontier_update"]


@pytest.mark.cuda
def test_dense_solve_on_card_equals_queue_solve(card):
    g = _graph(card)
    q = IMMSolver(g, engine="queue", batch=256, selection="bitset", seed=8,
                  device=card).solve(IMProblem(k=10, eps=0.4))
    ops.reset_launch_counts()
    d = IMMSolver(g, engine="dense", batch=256, selection="bitset", seed=8,
                  device=card).solve(IMProblem(k=10, eps=0.4))
    counts = ops.launch_counts()
    assert counts["bernoulli_edges"] == d.stats.rounds > 0
    assert counts["occur_from_bitset"] > 0
    np.testing.assert_array_equal(d.seeds, q.seeds)
    np.testing.assert_array_equal(d.gains, q.gains)
    assert d.frac == q.frac and d.stats.theta == q.stats.theta
    assert d.stats.n_rr_sampled == q.stats.n_rr_sampled


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 3, 130])
@pytest.mark.parametrize("r", [1, 7, 257])
def test_membership_kernel_equals_plain(card, r, l):
    """Rows padded with n = 50 past each length; lengths 0 and L; u = n
    (never found) and ids present or absent, as an int and as a tensor on
    the card (0-d int64 as an argmax gives it, and 1-element int32)."""
    n = 50
    lens = RNG.integers(0, l + 1, r).astype(np.int32)
    lens[0] = l
    if r > 1:
        lens[1] = 0
    rows = RNG.integers(0, n, (r, l)).astype(np.int32)
    rows = np.where(np.arange(l)[None, :] < lens[:, None], rows, n)
    rows_c, lens_c = torch.tensor(rows, device=card), torch.tensor(lens,
                                                                   device=card)
    before = ops.launch_counts()["membership_rows"]
    calls = 0
    for u in (0, int(rows[0, 0]), 49, n):
        want = ref.membership_rows_ref(torch.tensor(rows), torch.tensor(lens),
                                       u)
        for arg in (u, torch.tensor(u, device=card),
                    torch.tensor([u], dtype=torch.int32, device=card)):
            got = ops.membership_rows(rows_c, lens_c, arg)
            calls += 1
            assert got.dtype == torch.bool and got.shape == (r,)
            assert torch.equal(got.cpu(), want)
        if u == n:
            assert not want.any()
    torch.cuda.synchronize()
    assert ops.launch_counts()["membership_rows"] == before + calls


@pytest.mark.cuda
def test_membership_wrapper_checks_inputs(card):
    rows = torch.zeros(8, 128, dtype=torch.int32, device=card)
    lens = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        tmem.membership_rows(rows.to(torch.int64), lens, 0)
    with pytest.raises(ValueError):
        tmem.membership_rows(rows[:, ::2], lens, 0)
    with pytest.raises(ValueError):
        tmem.membership_rows(rows, lens.cpu(), 0)
    with pytest.raises(ValueError):
        tmem.membership_rows(rows, lens[:7], 0)
    with pytest.raises(ValueError, match="device"):
        tmem.membership_rows(rows, lens, torch.tensor(3))
    with pytest.raises(ValueError, match="one value"):
        tmem.membership_rows(rows, lens, torch.tensor([1, 2], device=card))
    with pytest.raises(TypeError):
        tmem.membership_rows(rows, lens, torch.tensor(1.0, device=card))
    with pytest.raises(ValueError, match="fit int32"):
        tmem.membership_rows(rows, lens, 1 << 31)


def _sync_count(fn):
    """``fn()`` under torch's sync debug mode -> (its result, the host
    syncs it made)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [w for w in caught
                 if "called a synchronizing" in str(w.message)]


@pytest.mark.cuda
def test_membership_int_u_goes_by_value(card):
    """An int u needs no tensor of its own: the call makes no host sync and
    gives what a u on the card gives."""
    rows = torch.tensor(RNG.integers(0, 9, (300, 5)).astype(np.int32),
                        device=card)
    lens = torch.tensor(RNG.integers(0, 6, 300).astype(np.int32),
                        device=card)
    ops.membership_rows(rows, lens, 1)                    # builds the kernel
    torch.cuda.synchronize()
    for u in (0, 4, 8, 9, -(1 << 31)):
        got, syncs = _sync_count(lambda: ops.membership_rows(rows, lens, u))
        assert not syncs
        assert torch.equal(got, ops.membership_rows(
            rows, lens, torch.tensor([u], dtype=torch.int32, device=card)))
        assert torch.equal(got.cpu(), ref.membership_rows_ref(
            rows.cpu(), lens.cpu(), u))


def _padded_cases():
    """(rows, lengths, n, k) of test_torch_padded's generators: random
    lists, lists with a node repeated in a row, k above the distinct nodes,
    empty rows, a row length off 128 and a lane holding n."""
    out = []
    for seed, n, count, k, hi in ((0, 60, 400, 5, 12), (4, 60, 400, 30, 12),
                                  (5, 500, 300, 12, 12), (6, 300, 1000, 20,
                                                          15),
                                  (7, 40, 2000, 50, 40)):
        rng = np.random.default_rng(seed)
        lists = [rng.choice(n, size=int(rng.integers(0, hi)),
                            replace=False).tolist() for _ in range(count)]
        out.append((lists, n, k))
    rng = np.random.default_rng(8)
    lists = [rng.integers(0, 12, int(rng.integers(0, 9))).tolist()
             for _ in range(500)]                 # repeats in a row
    lists[3] = [5, 5, 5, 2]
    out.append((lists, 12, 20))                   # k above the 12 nodes
    out.append(([[0, 1], [], [1, 2, 12], [3]] * 40, 12, 6))   # 12 = n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_padded_greedy_kernel_equals_plain(card, case):
    """One padded_greedy launch, no host sync, and the plain loop's seeds
    and gains exactly."""
    lists, n, k = _padded_cases()[case]
    store = cov.build_padded_store(lists, n, device="cpu")
    want = ref.padded_greedy_ref(store.rows, store.lengths, n=n, k=k)
    rows, lens = store.rows.to(card), store.lengths.to(card)
    ops.padded_greedy(rows, lens, n=n, k=k)               # builds the kernel
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got, syncs = _sync_count(lambda: ops.padded_greedy(rows, lens, n=n, k=k))
    assert not syncs
    assert ops.launch_counts()["padded_greedy"] == 1
    assert ops.launch_counts()["membership_rows"] == 0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.int32
        assert torch.equal(x.cpu(), y)
    # int64 lengths past L and below 0 clamp as the plain version's do
    wide = store.lengths.to(torch.int64)
    wide[:3] = torch.tensor([-4, 1 << 40, store.rows.shape[1] + 1])
    got = ops.padded_greedy(rows, wide.to(card), n=n, k=k)
    want = ref.padded_greedy_ref(store.rows, wide, n=n, k=k)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_padded_greedy_flags_lanes_outside_the_nodes(card):
    """A valid lane outside [0, n) no longer flags or raises: on the card
    the kernel and the selection give what the reference's
    ``select_seeds_padded`` gives on the same rows (pinned below; the CPU
    suite holds the plain loop to the reference itself) and the plain
    loop's bytes, the lane inside and past a row's length."""
    n, k = 6, 4
    # lane -> (seeds, gains) with the lane inside the rows' lengths and past
    # them: -7 wraps to node 0 and changes the first seed
    want_by_lane = {
        -1: ([5, 1, 0, 0], [3, 2, 0, 0]), n + 1: ([5, 1, 0, 0], [3, 2, 0, 0]),
        1 << 20: ([5, 1, 0, 0], [3, 2, 0, 0]),
        -2: ([5, 1, 0, 0], [3, 2, 0, 0]),
        -(n + 1): ([0, 5, 1, 0], [1, 3, 1, 0]),
        -(n + 2): ([5, 1, 0, 0], [3, 2, 0, 0])}
    for lane, inside in want_by_lane.items():
        rows = torch.tensor([[0, 1, lane, 2], [2, 5, lane, 6], [1, 2, 6, 6],
                             [5, lane, 3, 6], [4, 5, 6, 6]],
                            dtype=torch.int32)
        for lens, want in (([3, 3, 2, 3, 2], inside),
                           ([2, 2, 2, 1, 2], want_by_lane[-1])):
            lens = torch.tensor(lens, dtype=torch.int32)
            plain = ref.padded_greedy_ref(rows, lens, n=n, k=k)
            got = ops.padded_greedy(rows.to(card), lens.to(card), n=n, k=k)
            assert [x.tolist() for x in plain] == list(want)
            assert all(torch.equal(x.cpu(), y) for x, y in zip(got, plain))
            store = cov.PaddedStore(rows=rows.to(card), lengths=lens.to(card),
                                    n_nodes=n)
            res = cov.select_seeds_padded(store, k)
            assert res.seeds.tolist() == want[0]
            assert res.gains.tolist() == want[1]


@pytest.mark.cuda
def test_padded_greedy_wrapper_checks_inputs(card):
    rows = torch.zeros(8, 128, dtype=torch.int32, device=card)
    lens = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        tmem.padded_greedy(rows.to(torch.int64), lens, n=4, k=2)
    with pytest.raises(ValueError):
        tmem.padded_greedy(rows[:, ::2], lens, n=4, k=2)
    with pytest.raises(ValueError):
        tmem.padded_greedy(rows, lens[:7], n=4, k=2)
    with pytest.raises(ValueError):
        tmem.padded_greedy(rows, lens, n=0, k=2)
    with pytest.raises(ValueError):
        tmem.padded_greedy(rows, lens, n=4, k=0)
    assert tmem.greedy_grid(card) == torch.cuda.get_device_properties(
        card).multi_processor_count


def _fold_case(case):
    """(words, nodes, lens, row_base, k, mode) of one fold case: k off a
    power of two, empty rows in the middle, lengths below 0 and past W,
    nodes at and past R in valid lanes, a strided view of a wider queue,
    row ids across 2^32, a batch past one block of the kernel."""
    rng = np.random.default_rng(100 + case)
    b, w, n, k, base, mode = ((61, 9, 70, 96, 0, "mod"),
                              (61, 9, 70, 96, 37, "mix"),
                              (300, 12, 500, 256, 2 ** 32 - 90, "mix"),
                              (300, 12, 500, 128, 2 ** 32 - 90, "mod"),
                              (1000, 30, 2000, 4096, 2 ** 31 - 5, "mix"),
                              (129, 1, 40, 32, 5, "mod"),
                              (512, 21, 75880, 128, 8190, "mod"))[case]
    queue = rng.integers(0, n + 3, (b, w + 7)).astype(np.int32)
    nodes = torch.tensor(queue)[:, :w]                # row stride w + 7
    lens = torch.tensor(rng.integers(-2, w + 3, b).astype(np.int32))
    lens[b // 2: b // 2 + 5] = 0
    words = torch.tensor(rng.integers(0, 1 << 32, (n + 1, k // 32),
                                      dtype=np.int64).astype(np.uint32)
                         .view(np.int32))
    return words, nodes, lens, base, k, mode


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_sketch_fold_kernel_equals_plain(card, case):
    """One sketch_fold_rows launch a fold, on the strided view as it lies:
    the plain fold's words exactly, and its counts."""
    words, nodes, lens, base, k, mode = _fold_case(case)
    assert not nodes.is_contiguous()
    want = words.clone()
    want_counts = torch.zeros(2, dtype=torch.int64)
    ref.sketch_fold_rows_ref(want, nodes, lens, base, k=k, mode=mode,
                             counts=want_counts)
    got = words.to(card)
    counts = torch.full((2,), -1, dtype=torch.int64, device=card)
    before = ops.launch_counts()
    out = ops.sketch_fold_rows(got, nodes.to(card), lens.to(card), base, k=k,
                               mode=mode, counts=counts)
    after = ops.launch_counts()
    assert out is got
    assert after["sketch_fold_rows"] == before["sketch_fold_rows"] + 1
    assert after["sketch_scatter_or"] == before["sketch_scatter_or"]
    assert torch.equal(got.cpu(), want)
    assert counts.tolist() == want_counts.tolist()
    clamped = lens.to(torch.int64).clamp(0, nodes.shape[1])
    assert counts.tolist() == [int(clamped.sum()), int((clamped > 0).sum())]
    # int64 inputs and no counts give the same words
    again = words.to(card)
    ops.sketch_fold_rows(again, nodes.to(card).to(torch.int64),
                         lens.to(card).to(torch.int64), base, k=k, mode=mode)
    assert torch.equal(again.cpu(), want)


@pytest.mark.cuda
def test_sketch_fold_wrapper_checks_inputs(card):
    words = torch.zeros(8, 2, dtype=torch.int32, device=card)
    nodes = torch.zeros(4, 3, dtype=torch.int32, device=card)
    lens = torch.ones(4, dtype=torch.int32, device=card)
    fold = tsketch.sketch_fold_rows
    with pytest.raises(ValueError, match="k must"):
        fold(words, nodes, lens, 0, k=65, mode="mod")
    with pytest.raises(ValueError, match="mode"):
        fold(words, nodes, lens, 0, k=64, mode="bogus")
    with pytest.raises(ValueError):
        fold(words, nodes, lens[:3], 0, k=64, mode="mod")
    with pytest.raises(ValueError):
        fold(words, nodes.cpu(), lens, 0, k=64, mode="mod")
    with pytest.raises(TypeError):
        fold(words, nodes.float(), lens, 0, k=64, mode="mod")
    with pytest.raises(ValueError, match="counts"):
        fold(words, nodes, lens, 0, k=64, mode="mod",
             counts=torch.zeros(2, dtype=torch.int32, device=card))
    counts = torch.full((2,), 7, dtype=torch.int64, device=card)
    fold(words, nodes[:0], lens[:0], 0, k=64, mode="mod", counts=counts)
    assert counts.tolist() == [0, 0] and not words.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "mix"])
def test_sketch_store_append_is_one_launch_and_one_host_read(card, mode):
    """SketchRRStore.append_batch on the card: one sketch_fold_rows launch,
    no sketch_scatter_or and one host sync, and the CPU store's words and
    counts; the exact store's fold the same."""
    rng = np.random.default_rng(11)
    queue = torch.tensor(rng.integers(0, 3000, (2048, 19)).astype(np.int32))
    batches = [(queue[i:i + 512, :7], torch.tensor(
        rng.integers(-1, 9, 512).astype(np.int32))) for i in (0, 512, 1024)]
    stores = {dev: cov.SketchRRStore(3000, sketch_k=96, sketch_mode=mode,
                                     device=dev) for dev in ("cpu", card)}
    exact = {dev: cov.DeviceRRStore(3000, sketch_k=96, sketch_mode=mode,
                                    device=dev) for dev in ("cpu", card)}
    stores[card].append_batch((batches[0][0].to(card),
                               batches[0][1].to(card)))   # builds it
    stores["cpu"].append_batch(batches[0])
    torch.cuda.synchronize()
    for nodes, lens in batches[1:]:
        stores["cpu"].append_batch((nodes, lens))
        on_card = (nodes.to(card), lens.to(card))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _, syncs = _sync_count(lambda: stores[card].append_batch(on_card))
        counts = ops.launch_counts()
        assert len(syncs) == 1, syncs
        assert counts["sketch_fold_rows"] == 1
        assert sum(counts.values()) == 1, counts
    for nodes, lens in batches:
        for dev, store in exact.items():
            store.append_batch((nodes.to(dev), lens.to(dev)))
    for pair in (stores, exact):
        a, b = pair["cpu"], pair[card]
        assert (a.n_rr, a.n_elems) == (b.n_rr, b.n_elems)
        assert torch.equal(a.sketch_words().cpu(), b.sketch_words().cpu())
    assert torch.equal(stores[card].words.cpu(),
                       exact[card].sketch_words().cpu())


@pytest.mark.cuda
def test_padded_selection_on_card_equals_cpu(card):
    n, k = 300, 20
    lists = [RNG.choice(n, size=int(RNG.integers(0, 15)),
                        replace=False).tolist() for _ in range(1000)]
    cpu = cov.select_seeds_padded(cov.build_padded_store(lists, n,
                                                         device="cpu"), k)
    ops.reset_launch_counts()
    gpu = cov.select_seeds_padded(cov.build_padded_store(lists, n,
                                                         device=card), k)
    counts = ops.launch_counts()
    assert counts["padded_greedy"] == 1 and counts["membership_rows"] == 0
    assert torch.equal(gpu.seeds.cpu(), cpu.seeds)
    assert torch.equal(gpu.gains.cpu(), cpu.gains)
    assert gpu.frac.cpu().numpy().tobytes() == cpu.frac.numpy().tobytes()


# float32 as the reference's test; bfloat16 and float16 one rounding of the
# output (8 and 11 significant bits) on values of magnitude about 1
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2),
             torch.float16: (2e-3, 2e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("s", [16, 48, 130, 320, 1000])
@pytest.mark.parametrize("d", [8, 16, 64, 128, 256])
def test_flash_kernel_equals_plain(card, d, s, dtype):
    """Against the plain version on the CPU (float32 logits), causal and
    not; S = 130 is off every tile of the kernel (bq = bk = S); at S = 320
    and 1000 a causal tile meets the diagonal mid-tile, the tensor-core
    kernel's 2-stage K/V ring wraps several times, and S ends off a
    KV tile."""
    q, k, v = (torch.tensor(RNG.standard_normal((2, s, 3, d)),
                            dtype=torch.float32).to(dtype) for _ in range(3))
    atol, rtol = FLASH_TOL[dtype]
    before = ops.launch_counts()["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q.to(card), k.to(card), v.to(card),
                                  causal=causal, bq=s, bk=s)
        want = ref.flash_attention_ref(q, k, v, causal)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=atol, rtol=rtol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_kernel_unequal_batch_and_heads(card, d, dtype):
    """B = 3, H = 5: a wrong batch or head stride in the tensor maps (or
    in the SIMT kernel's offsets) reads another slice."""
    q, k, v = (torch.tensor(RNG.standard_normal((3, 200, 5, d)),
                            dtype=torch.float32).to(dtype) for _ in range(3))
    atol, rtol = FLASH_TOL[dtype]
    for causal in (True, False):
        got = ops.flash_attention(q.to(card), k.to(card), v.to(card),
                                  causal=causal, bq=200, bk=200)
        want = ref.flash_attention_ref(q, k, v, causal)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_flash_wrapper_rejects_misaligned_tensors(card, dtype):
    """TMA (and the 128-bit loads) need 16-byte aligned bases: a view one
    element in raises rather than being copied; 16 bytes in it runs."""
    n = 1 * 16 * 2 * 64
    flat = torch.randn(n + 16, device=card).to(dtype)
    q = flat[:n].view(1, 16, 2, 64)
    off = flat[1:n + 1].view(1, 16, 2, 64)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(off, q, q)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, q, off)
    step = 16 // flat.element_size()
    ok = flat[step:n + step].view(1, 16, 2, 64)
    torch.testing.assert_close(
        tflash.flash_attention(ok, q, q).cpu().float(),
        ref.flash_attention_ref(ok.cpu(), q.cpu(), q.cpu()).float(),
        atol=FLASH_TOL[dtype][0], rtol=FLASH_TOL[dtype][1])


@pytest.mark.cuda
def test_flash_wrapper_checks_inputs(card):
    q = torch.zeros(1, 16, 2, 64, device=card)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(*(torch.zeros(1, 16, 2, 32, device=card),) * 3)
    with pytest.raises(TypeError):
        tflash.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        tflash.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q, q.transpose(1, 2).contiguous()
                               .transpose(1, 2), q)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tflash.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, q[:, :8], q[:, :8])


def _mask_cases(b):
    """All-false, all-true, sparse (one row in seven) and half masks."""
    sparse = np.zeros(b, np.int32)
    sparse[RNG.choice(b, size=max(1, b // 7), replace=False)] = 1
    return {"none": np.zeros(b, np.int32), "all": np.ones(b, np.int32),
            "sparse": sparse,
            "half": RNG.integers(0, 2, size=b).astype(np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("ones", [False, True], ids=["random", "ones"])
@pytest.mark.parametrize("b,w", [(1, 3), (15, 3), (16, 3), (17, 3),
                                 (300, 130), (1100, 3), (20000, 3),
                                 (16384, 75)])
def test_occur_bit_planes_on_card(card, b, w, ones):
    """The bit-plane kernels, exactly: rows 1, 15, 16, 17 and off the
    16-row group, all-ones rows (every count of a full chunk is
    rows_per_chunk and fills the top plane), several chunks a column, and
    masks all-false, all-true, sparse and half, as bool and int32."""
    x = (torch.full((b, w), -1, dtype=torch.int32) if ones
         else _words(b, w)).to(card)
    assert torch.equal(ops.occur_from_bitset(x), ref.occur_from_bitset_ref(x))
    for kind, mask in _mask_cases(b).items():
        for dtype in (torch.int32, torch.bool):
            m = torch.tensor(mask).to(dtype=dtype, device=card)
            got = ops.occur_from_bitset_masked(x, m)
            assert torch.equal(got, ref.occur_from_bitset_masked_ref(x, m)), \
                (kind, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("per", [1, 15, 16, 17, 48, 512, 4096])
def test_occur_kernels_at_any_chunk_size(card, per):
    """The C entry points at chunk sizes that rows_per_chunk never picks:
    a chunk of one row, chunks off the group, the last chunk ragged."""
    dev = card.index if card.index is not None else torch.cuda.current_device()
    for ones in (False, True):
        x = (torch.full((5000, 130), -1, dtype=torch.int32) if ones
             else _words(5000, 130)).to(card)
        b, w = x.shape
        planes = tbitset.occur_planes(per)
        m = torch.tensor(_mask_cases(b)["half"], device=card).bool()
        out = torch.full((w * 32,), 7, dtype=torch.int32, device=card)
        assert tbitset._OCCUR(x.data_ptr(), b, w, per, planes, out.data_ptr(),
                              dev, _build.raw_stream(dev)) == 0
        assert torch.equal(out, ref.occur_from_bitset_ref(x))
        out.fill_(7)
        assert tbitset._OCCUR_MASKED(
            x.data_ptr(), m.data_ptr(), 1, b, w, per, planes, out.data_ptr(),
            dev, _build.raw_stream(dev)) == 0
        assert torch.equal(out, ref.occur_from_bitset_masked_ref(x, m))
    # a chunk too large for its planes, or too many chunks, is refused
    assert tbitset._OCCUR(x.data_ptr(), b, w, 16, 4, out.data_ptr(), dev,
                          _build.raw_stream(dev)) != 0
    assert tbitset._OCCUR(x.data_ptr(), 70000, w, 1, 1, out.data_ptr(), dev,
                          _build.raw_stream(dev)) != 0


@pytest.mark.cuda
def test_raw_stream_is_pytorchs_current_stream(card):
    idx = torch.cuda.current_device()
    assert _build.raw_stream(idx) == torch.cuda.current_stream(idx).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.raw_stream(idx) == side.cuda_stream
        assert _build.raw_stream(idx) == \
            torch.cuda.current_stream(idx).cuda_stream
    assert _build.raw_stream(idx) == torch.cuda.current_stream(idx).cuda_stream
    assert _build.raw_stream(idx) != side.cuda_stream


@pytest.mark.cuda
def test_bitset_kernels_on_a_side_stream(card):
    """Launched inside ``torch.cuda.stream(s)``, each kernel runs on s and
    is ordered after the work s waits for."""
    a, b = _words(512, 2372).to(card), _words(512, 2372).to(card)
    x = _words(4096, 75).to(card)
    m = torch.tensor(_mask_cases(4096)["half"], device=card).bool()
    bits = torch.tensor(RNG.integers(0, 2, (64, 96)).astype(bool)).to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = {"or": ops.bitset_or(a, b), "andnot": ops.bitset_andnot(a, b),
               "pop": ops.popcount_words(a), "pack": ops.pack_bits(bits),
               "occur": ops.occur_from_bitset(x),
               "masked": ops.occur_from_bitset_masked(x, m)}
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got["or"], ref.bitset_or_ref(a, b))
    assert torch.equal(got["andnot"], ref.bitset_andnot_ref(a, b))
    assert torch.equal(got["pop"], ref.popcount_words_ref(a))
    assert torch.equal(got["pack"], ref.pack_bits_ref(bits))
    assert torch.equal(got["occur"], ref.occur_from_bitset_ref(x))
    assert torch.equal(got["masked"], ref.occur_from_bitset_masked_ref(x, m))


def _close(got, want, dtype):
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("d", [32, 80])
def test_ops_flash_pads_head_dims_the_kernel_lacks(card, d, dtype):
    """D = 32 and 80 run at 64 and 128 with the true D's scale, and come
    back in q's dtype and shape."""
    q, k, v = (torch.tensor(RNG.standard_normal((2, 130, 3, d)),
                            dtype=torch.float32).to(dtype) for _ in range(3))
    before = ops.launch_counts()["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q.to(card), k.to(card), v.to(card),
                                  causal=causal, bq=130, bk=130)
        assert got.dtype == dtype and got.shape == q.shape
        assert got.is_contiguous()
        _close(got.cpu(), ref.flash_attention_ref(q, k, v, causal), dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("d", [64, 80])
def test_ops_flash_takes_unbind_views(card, d, dtype):
    """q, k, v unbound from a packed (B, S, 3, H, D) tensor are strided
    views; they are copied once and run on the kernel."""
    qkv = torch.tensor(RNG.standard_normal((2, 256, 3, 4, d)),
                       dtype=torch.float32).to(dtype).to(card)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = ops.launch_counts()["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        assert got.shape == q.shape and got.dtype == dtype
        _close(got, ref.flash_attention_ref(q, k, v, causal), dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_ops_flash_takes_misaligned_views(card, dtype):
    """A contiguous view one element past a 16-byte boundary, which the
    kernel wrapper refuses, is cloned into a fresh allocation."""
    n = 1 * 16 * 2 * 64
    flat = torch.randn(n + 16, device=card).to(dtype)
    q = flat[:n].view(1, 16, 2, 64)
    off = flat[1:n + 1].view(1, 16, 2, 64)
    assert off.is_contiguous() and off.data_ptr() % 16
    for args in ((off, q, q), (q, off, q), (q, q, off)):
        _close(ops.flash_attention(*args),
               ref.flash_attention_ref(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_ops_flash_beyond_the_grids_y_limit(card, dtype):
    """B*H = 4097 * 16 = 65,552 b*h indices: two launches, the second
    starting at 65,535 (mid-batch, at head 15)."""
    q, k, v = (torch.randn(4097, 16, 16, 64, device=card).to(dtype)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, True)
    _close(got, want, dtype)
    _close(got[4095:], want[4095:], dtype)


@pytest.mark.cuda
def test_ops_flash_refuses_head_dims_past_256(card):
    """Past 256 the kernel wrapper takes only multiples of the split
    kernel's 64-column chunk (``ops`` pads to one); D = 320 runs."""
    q = torch.zeros(1, 16, 2, 300, device=card)
    with pytest.raises(ValueError, match="multiples of 64 above 256"):
        tflash.flash_attention(q, q, q)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, q, q)
    assert got.shape == q.shape and not got.any()
    assert ops.launch_counts()["flash_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("s", [130, 300])
@pytest.mark.parametrize("d", [320, 512, 1000])
def test_flash_split_kernel_equals_plain(card, d, s, dtype):
    """D = 320 and 512 run the column-split kernel (two slices; at 320 the
    second is ragged), D = 1000 runs it at 1024 with the true D's scale;
    S off the 32-row and 64-key tiles; causal and not; within FLASH_TOL of
    the plain version on the CPU."""
    q, k, v = (torch.tensor(RNG.standard_normal((2, s, 3, d)),
                            dtype=torch.float32).to(dtype) for _ in range(3))
    assert tflash.design(dtype, tflash.padded_head_dim(d)) == "simt_split"
    before = ops.launch_counts()["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q.to(card), k.to(card), v.to(card),
                                  causal=causal, bq=s, bk=s)
        assert got.dtype == dtype and got.shape == q.shape
        _close(got.cpu(), ref.flash_attention_ref(q, k, v, causal), dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2


def _u01(h):
    """float32(h) * 2^-32 for integer h (round to nearest even)."""
    return (np.asarray(h, np.uint64).astype(np.float32)
            * np.float32(2.0 ** -32)).astype(np.float32)


def _adversarial_weights(e: int, offset: int) -> torch.Tensor:
    """``e`` weights drawn in turn from u(h) at every rounding boundary of
    the conversion and at seeded random h, one ulp above and below each,
    and 0, -0.0, 1.0, 1 + ulp, 2, +-inf, NaN, the smallest denormal and
    negatives; ``offset`` rotates the pool."""
    hs = set()
    for k in range(33):
        p = 1 << k
        gap = max(1, p >> 23)
        for c in (p, p - gap // 2, p + gap // 2, p + gap):
            hs.update((c - 1, c, c + 1))
    rng = np.random.default_rng(offset)
    rand = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    base = _u01(np.array(sorted(h for h in hs if 0 <= h < 1 << 32) +
                         rand.tolist(), np.uint64))
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    one = np.float32(1.0)
    pool = np.concatenate([
        np.array([0.0, -0.0, 1.0, np.nextafter(one, np.float32(2)), 2.0,
                  np.inf, -np.inf, np.nan, tiny, -tiny, -1.0,
                  np.nextafter(one, np.float32(0))], np.float32),
        base, np.nextafter(base, np.float32(2)),
        np.nextafter(base, np.float32(-1))]).astype(np.float32)
    idx = (np.arange(e) + offset) % len(pool)
    return torch.tensor(pool[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 512, 65537])
@pytest.mark.parametrize("e", [1, 3, 15, 16, 17, 607012])
def test_bernoulli_kernel_exact_on_adversarial_weights(card, e, b):
    """The integer-threshold kernel equals the float compare exactly on
    weights at every rounding boundary and the edges of the range; E = 16
    and 607,012 take the word stores, the others the byte stores; B =
    65,537 runs past the grid's y extent, so blocks stride over rows.
    (65,537 x 607,012 bytes would be 40 GB: that pair runs at 64 rows.)"""
    if e == 607012 and b == 65537:
        b = 64
    w = _adversarial_weights(e, offset=e).to(card)
    seeds = torch.tensor(RNG.integers(0, 1 << 32, b), device=card)
    seeds[0] = 0xFFFFFFFF
    before = ops.launch_counts()["bernoulli_edges"]
    got = ops.bernoulli_edges(w, seeds)
    assert got.shape == (b, e)
    want = ref.bernoulli_edges_ref(w, seeds)
    assert torch.equal(got, want)
    assert torch.equal(got[-1].cpu(), ref.bernoulli_edges_ref(
        w.cpu(), int(seeds[-1])))
    torch.cuda.synchronize()
    assert ops.launch_counts()["bernoulli_edges"] == before + 1


@pytest.mark.cuda
def test_bernoulli_kernel_takes_seeds_as_given(card):
    """A contiguous int64 seed vector on the card is used as it is; int32,
    strided, CPU and 0-d seeds are converted, with the same result."""
    w = _adversarial_weights(1000, offset=5).to(card)
    seeds = torch.tensor(RNG.integers(0, 1 << 31, 8), device=card)
    want = ref.bernoulli_edges_ref(w, seeds)
    for arg in (seeds, seeds.to(torch.int32), seeds.cpu(),
                torch.stack([seeds, seeds], 1)[:, 0]):
        assert torch.equal(ops.bernoulli_edges(w, arg), want)
    assert torch.equal(ops.bernoulli_edges(w, seeds[3].clone()), want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 257, 75881])
@pytest.mark.parametrize("w", [1, 3, 4, 5, 8, 512])
def test_union_popcount_kernel_equals_plain(card, w, r):
    """Every design: one row a thread (W <= 4; 16-byte loads at W = 4), lane
    groups with 16-byte loads (W = 8, 512) and scalar ones (W = 5); ragged
    R; words one word off the 16-byte alignment (scalar loads) and a
    misaligned, a strided and a CPU-made cov."""
    words = _words(r, w).to(card)
    flat = torch.empty(r * w + 1, dtype=torch.int32, device=card)
    shifted = flat[1:].view(r, w)
    shifted.copy_(words)
    assert shifted.data_ptr() % 16
    buf = _words(1, 2 * w + 1)[0].to(card)
    covs = {"plain": buf[:w].clone(), "misaligned": buf[1:w + 1],
            "strided": buf[:2 * w:2]}
    before = ops.launch_counts()["sketch_union_popcount"]
    calls = 0
    for name, cov_words in covs.items():
        want = ref.sketch_union_popcount_ref(words, cov_words)
        for x in (words, shifted):
            got = ops.sketch_union_popcount(x, cov_words)
            calls += 1
            assert got.dtype == torch.int32 and got.shape == (r,)
            assert torch.equal(got, want), name
    assert torch.equal(want[:64].cpu(), ref.sketch_union_popcount_ref(
        words[:64].cpu(), covs["strided"].cpu()))
    torch.cuda.synchronize()
    assert ops.launch_counts()["sketch_union_popcount"] == before + calls


@pytest.mark.cuda
def test_greedy_popcounts_run_on_the_card(card):
    """On the card the flat selection runs each greedy as one greedy_flat
    launch and the approximate selection as one greedy_sketch launch (no
    popcount left in either, no plain popcount on a card tensor); both give
    the CPU's seeds, gains and frac bytes."""
    g = {d: _graph(d) for d in ("cpu", card)}
    flat, approx = {}, {}
    for dev in ("cpu", card):
        ops.reset_launch_counts()
        solver = IMMSolver(g[dev], batch=256, selection="fused", seed=9,
                           device=dev)
        flat[dev] = solver.solve(IMProblem(k=10, eps=0.4))
        flat_counts = ops.launch_counts()
        ops.reset_launch_counts()
        approx[dev] = IMMSolver(g[dev], batch=256, seed=9, sketch_k=256,
                                device=dev).solve(
            IMProblem(k=10, theta=2048, mode="approximate"))
        counts = ops.launch_counts()
        if dev == "cpu":
            assert flat_counts["greedy_flat"] == 0
            assert flat_counts["popcount_words"] == 0
            assert counts["popcount_words"] == 0
        else:
            assert flat_counts["greedy_flat"] >= 1
            assert flat_counts["popcount_words"] == 0
            assert counts["greedy_sketch"] >= 1
            assert counts["popcount_words"] == 0
            assert counts["sketch_union_popcount"] == 0
    for res in (flat, approx):
        np.testing.assert_array_equal(res[card].seeds, res["cpu"].seeds)
        np.testing.assert_array_equal(res[card].gains, res["cpu"].gains)
        assert np.float32(res[card].frac).tobytes() == \
            np.float32(res["cpu"].frac).tobytes()


# the queue sampler's kernel (csrc/queue.cu), at tests/test_torch_queue.py's
# graphs, qcaps and chunk widths, at the stand-in, and at n past the
# shared-memory size of the visited bits (and at its edge)
QUEUE_HUB = 63
SHARED_VISITED_NODES = 1_843_200      # kernels/queue.py::visited_in_shared


def _queue_graph(name, device):
    """The coalesced reverse CSR of a named graph of
    tests/test_torch_queue.py (the same edges and weights), the stand-in,
    or ``wide<n>``: 3n random edges over n nodes with WC weights."""
    if name == "longrow":
        rng = np.random.default_rng(57)
        n = 33_200
        bs, bd = generators.barabasi_albert(200, 2, seed=4)
        leaves = np.arange(200, n)
        others = np.setdiff1d(np.arange(200), [QUEUE_HUB])
        into = np.union1d(rng.choice(others, 35, replace=False),
                          [31, 95, 127, 159, 191])
        out = np.concatenate([rng.choice(others, 100, replace=False),
                              leaves[:32_000]])
        src = np.concatenate([bs, into, leaves, np.full(out.size, QUEUE_HUB)])
        dst = np.concatenate([bd, np.full(into.size + leaves.size, QUEUE_HUB),
                              out])
        w = np.concatenate([np.full(bs.size, 0.1), np.full(into.size, 0.45),
                            np.full(leaves.size, 0.01),
                            np.full(out.size, 0.9)])
        g = csr.from_edges(src, dst, n, weights=w.astype(np.float32),
                           device=device)
    elif name.startswith("wide"):
        n = int(name[4:])
        src, dst = np.random.default_rng(n).integers(0, n, (2, 3 * n))
        g = weights.wc_weights(csr.from_edges(src, dst, n, device=device))
    elif name == "hub":
        rng = np.random.default_rng(31)
        n = 210
        bs, bd = generators.barabasi_albert(200, 2, seed=4)
        others = np.setdiff1d(np.arange(200), [QUEUE_HUB])
        into = np.union1d(rng.choice(others, 135, replace=False),
                          [31, 95, 127, 159, 191])[:140]
        into = np.concatenate([into, np.arange(200, n)])
        out = rng.choice(others, 100, replace=False)
        w_in = np.full(into.size, 0.45)
        w_in[:3], w_in[-3:] = 1.0, 0.0
        src = np.concatenate([bs, into, np.full(out.size, QUEUE_HUB)])
        dst = np.concatenate([bd, np.full(into.size, QUEUE_HUB), out])
        w = np.concatenate([np.full(bs.size, 0.1), w_in,
                            np.full(out.size, 0.9)])
        g = csr.from_edges(src, dst, n, weights=w.astype(np.float32),
                           device=device)
    elif name == "standin":
        src, dst = generators.barabasi_albert(75879, 4, seed=0)
        g = weights.wc_weights(csr.from_edges(src, dst, 75879, device=device))
    else:
        n = int(name[2:])
        src, dst = (generators.erdos_renyi(n, 150, seed=2) if name == "er30"
                    else generators.barabasi_albert(n, 3 if n < 1000 else 4,
                                                    seed=n % 97))
        g = weights.wc_weights(csr.from_edges(src, dst, n, device=device))
    return csr.coalesce_ic(csr.reverse(g))


def _queue_round(g, batch, seed32, qcap, ec, plain=False):
    fn = ref.queue_round_ref if plain else ops.queue_bfs
    return fn(g.offsets, g.indices, g.weights, seed32, batch,
              qcap=g.n_nodes if qcap is None else qcap, ec=ec)


def _assert_same_round(got, want):
    assert len(got) == len(want) == 5
    for x, y, what in zip(got, want, ("queue", "lengths", "overflowed",
                                      "steps", "roots")):
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert torch.equal(x, y), what


@pytest.mark.cuda
@pytest.mark.parametrize("ec", [1, 32, 128])
@pytest.mark.parametrize("qcap", [2, 5, None], ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("name", ["ba40", "er30", "ba200", "ba1500", "hub"])
def test_queue_kernel_equals_plain(card, name, qcap, ec):
    """The kernel against the plain version on the card and on the CPU,
    byte for byte: queue rows, lengths, overflow flags, per-lane steps,
    roots."""
    g = _queue_graph(name, card)
    batch = 128 if name in ("ba1500", "hub") else 64
    ops.reset_launch_counts()
    got = _queue_round(g, batch, 0xC0FFEE, qcap, ec)
    assert ops.launch_counts()["queue_bfs"] == 1
    _assert_same_round(got, _queue_round(g, batch, 0xC0FFEE, qcap, ec,
                                         plain=True))
    cpu = _queue_round(g.to("cpu"), batch, 0xC0FFEE, qcap, ec)
    _assert_same_round(tuple(x.cpu() for x in got), cpu)
    if qcap is not None:
        assert bool(got[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("ec", [32, 128])
@pytest.mark.parametrize("qcap", [2, 5, None], ids=["qcap2", "qcap5", "qcapn"])
def test_queue_kernel_on_a_long_row(card, qcap, ec):
    """A hub row of 33,040 edges, three of the kernel's segments (1,033
    32-edge tiles), walked by most lanes: the kernel against the plain
    version on the card and on the CPU."""
    g = _queue_graph("longrow", card)
    assert int(g.offsets.diff().max()) > 2 * tqueue.SEGMENT_EDGES
    got = _queue_round(g, 64, 0xC0FFEE, qcap, ec)
    _assert_same_round(got, _queue_round(g, 64, 0xC0FFEE, qcap, ec,
                                         plain=True))
    _assert_same_round(tuple(x.cpu() for x in got),
                       _queue_round(g.to("cpu"), 64, 0xC0FFEE, qcap, ec))
    assert int(got[1].max()) > 300 if qcap is None else bool(got[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("qcap", [5, None], ids=["qcap5", "qcapn"])
@pytest.mark.parametrize("n", [SHARED_VISITED_NODES, SHARED_VISITED_NODES + 1,
                               1_900_000])
def test_queue_kernel_visited_in_shared_and_global_memory(card, n, qcap):
    """At the largest n whose visited bits fit in shared memory (230,400
    bytes a block) and past it (a global scratch), on random graphs whose
    RR sets reach across the whole range: the kernel against the plain
    version on the card."""
    assert tqueue.visited_in_shared(n) == (n == SHARED_VISITED_NODES)
    g = _queue_graph(f"wide{n}", card)
    got = _queue_round(g, 64, round_seed(3, 1), qcap, 128)
    _assert_same_round(got, _queue_round(g, 64, round_seed(3, 1), qcap, 128,
                                         plain=True))
    assert int(got[4].max()) > n // 2
    assert int(got[1].max()) > 5 if qcap is None else bool(got[2].any())


@pytest.mark.cuda
def test_queue_kernel_at_the_stand_in(card):
    """B = 512 on the 75,879-node stand-in at the exact path's first round
    (hubs of in-degree above 50,000, seven segments of the kernel), against
    the plain version on the card, at qcap = n, 64 and 8: a lane overflows
    iff its RR set at qcap = n is longer (none at 64, whose longest set is
    21)."""
    g = _queue_graph("standin", card)
    full = None
    for qcap in (None, 64, 8):
        got = _queue_round(g, 512, round_seed(0, 0), qcap, 128)
        _assert_same_round(got, _queue_round(g, 512, round_seed(0, 0), qcap,
                                             128, plain=True))
        full = got if full is None else full
        assert torch.equal(got[2], full[1] > (qcap or g.n_nodes))
    assert bool(got[2].any())


@pytest.mark.cuda
def test_queue_engine_round_is_one_launch_and_one_host_read(card):
    """QueueEngine.sample on a card launches queue_bfs once and makes one
    synchronizing call (the read of the longest set and the most steps)."""
    import warnings
    eng = QueueEngine(_graph(card), QueueEngine.Config(batch=256))
    eng.sample(1)                                 # builds the kernel
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            batch = eng.sample(2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, syncs
    assert ops.launch_counts()["queue_bfs"] == 1
    cpu = QueueEngine(_graph("cpu"), QueueEngine.Config(batch=256)).sample(2)
    assert torch.equal(batch.nodes.cpu(), cpu.nodes)
    assert torch.equal(batch.lengths.cpu(), cpu.lengths)
    assert batch.steps == cpu.steps


@pytest.mark.cuda
def test_queue_wrapper_checks_inputs(card):
    g = _queue_graph("ba40", card)
    args = [g.offsets, g.indices, g.weights]
    for i, bad in ((0, g.offsets.long()), (1, g.indices.long()),
                   (2, g.weights.double())):
        with pytest.raises(TypeError):
            tqueue.queue_bfs(*args[:i], bad, *args[i + 1:], 5, 8, qcap=40,
                             ec=128)
    with pytest.raises(ValueError):
        tqueue.queue_bfs(args[0], args[1].cpu(), args[2], 5, 8, qcap=40,
                         ec=128)
    with pytest.raises(ValueError):
        tqueue.queue_bfs(args[0], torch.stack([args[1], args[1]], 1)[:, 0],
                         args[2], 5, 8, qcap=40, ec=128)
    with pytest.raises(ValueError):
        tqueue.queue_bfs(args[0], args[1], args[2][:-1], 5, 8, qcap=40,
                         ec=128)
    with pytest.raises(ValueError):
        tqueue.queue_bfs(args[0][:1], args[1][:0], args[2][:0], 5, 8,
                         qcap=40, ec=128)
    for batch, qcap, ec in ((-1, 40, 128), (8, 0, 128), (8, 40, 0)):
        with pytest.raises(ValueError):
            tqueue.queue_bfs(*args, 5, batch, qcap=qcap, ec=ec)
    empty = tqueue.queue_bfs(*args, 5, 0, qcap=40, ec=128)
    assert [tuple(x.shape) for x in empty] == [(0, 40), (0,), (0,), (0,),
                                               (0,)]


# the fused greedy (csrc/greedy.cu): pools with empty rows, growth, n and
# the row count off multiples of 32, wide ones, and rows longer than a
# block of the kernel; k = 1, 50 and past the last positive gain


def _greedy_batches(name):
    """(n, [(nodes, lengths), ...]) of a named random pool."""
    rng = np.random.default_rng(len(name))
    n, count, max_len, batches = {"ragged": (97, None, 12, 12),
                                  "small": (70, 45, 9, 1),
                                  "wide": (5_003, 700, 64, 3),
                                  "longrow": (3_001, 300, 8, 2)}[name]
    out = []
    for _ in range(batches):
        c = count or int(rng.integers(1, 900))
        lens = rng.integers(0, max_len, c)
        if name == "longrow":
            lens[::50] = rng.integers(513, n, lens[::50].size)
        nodes = np.full((c, max(int(lens.max()), 1)), n, np.int64)
        for i, ln in enumerate(lens):
            nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
        out.append((nodes, lens))
    return n, out


def _greedy_store(name, device):
    n, batches = _greedy_batches(name)
    store = cov.DeviceRRStore(n, device=device)
    for nodes, lens in batches:
        store.append_batch((torch.as_tensor(nodes), torch.as_tensor(lens)))
    return store


def _store_args(store):
    t = store.n_elems
    return (store.flat[:t], store.ids[:t], store.valid[:t]), dict(
        n=store.n_nodes, num_rows=store.row_capacity())


@pytest.mark.cuda
@pytest.mark.parametrize("k", ["1", "50", "past"])
@pytest.mark.parametrize("name", ["ragged", "small", "wide", "longrow"])
def test_greedy_flat_kernel_equals_plain(card, name, k):
    store = _greedy_store(name, card)
    args, kw = _store_args(store)
    k = {"1": 1, "50": 50, "past": store.n_nodes + 3}[k]
    want = ref.greedy_flat_ref(*args, **kw, k=k)
    before = ops.launch_counts()["greedy_flat"]
    got = tgreedy.greedy_flat(*args, **kw, k=k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["greedy_flat"] == before + 1
    for x, y in zip(got, want):
        assert x.dtype == torch.int32 and x.shape == (k,)
        assert torch.equal(x, y)
    if k > store.n_nodes:
        assert int(got[1][-1]) == 0 and int(got[0][-1]) == 0


def _edge_pool(case, device):
    """(pool, keywords, k, the state's place) of a pool that one of the
    kernel's edges needs: ``invalid`` the ragged pool with a tenth of its
    elements invalid; ``rows`` the wide pool with num_rows 64 times its row
    capacity; ``nodes`` 40 rows over n = 8,000,000 nodes (a block's Occur
    slice, 242 KB, passes the shared memory: the scratch layout), k = 60
    past the covered nodes; ``bits`` 40 rows and num_rows = 2^23 (1 MB of
    Covered: the scratch layout)."""
    rng = np.random.default_rng(len(case))
    if case in ("invalid", "rows"):
        store = _greedy_store("ragged" if case == "invalid" else "wide",
                              device)
        args, kw = _store_args(store)
        if case == "invalid":
            flat, ids, valid = args
            drop = torch.from_numpy(rng.random(flat.shape[0]) < 0.1)
            args = (flat, ids, valid & ~drop.to(device))
        else:
            kw = dict(kw, num_rows=64 * kw["num_rows"])
        return args, kw, 50, "shared"
    n, rows, num_rows, k = {"nodes": (8_000_000, 40, 64, 60),
                            "bits": (5_003, 40, 1 << 23, 50)}[case]
    lens = rng.integers(1, 30, rows)
    lens[rng.choice(rows, rows // 3, replace=False)] = 0   # empty rows
    flat = np.concatenate([rng.choice(min(n, 3_000), ln, replace=False)
                           * (n // 3_000) for ln in lens])
    ids = np.repeat(np.arange(rows), lens)
    valid = rng.random(flat.shape[0]) < 0.95
    args = tuple(torch.tensor(x, device=device) for x in (
        flat.astype(np.int32), ids.astype(np.int32), valid))
    return args, dict(n=n, num_rows=num_rows), k, "scratch"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["invalid", "rows", "nodes", "bits"])
def test_greedy_flat_kernel_on_edge_pools(card, case):
    """Byte for byte against the plain version on pools with invalid
    elements, with num_rows far above the rows, and on the two that put the
    blocks' Occur and Covered in the scratch (the kernel's global form)."""
    args, kw, k, place = _edge_pool(case, card)
    lay = tgreedy.flat_layout(kw["n"], kw["num_rows"],
                              *tgreedy.flat_grid(card))
    assert lay.shared == (place == "shared")
    want = ref.greedy_flat_ref(*args, **kw, k=k)
    before = ops.launch_counts()["greedy_flat"]
    got = tgreedy.greedy_flat(*args, **kw, k=k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["greedy_flat"] == before + 1
    for x, y in zip(got, want):
        assert x.dtype == torch.int32 and torch.equal(x, y)
    if case == "nodes":                                # past the covered
        assert int(got[1][-1]) == 0 and int(got[0][-1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged", "small", "wide", "longrow"])
def test_flat_selection_on_card_equals_cpu(card, name):
    """The store's flat selection on the card (one greedy_flat launch, no
    host sync) gives the CPU store's seeds, gains and frac bytes."""
    import warnings
    got_store, want_store = _greedy_store(name, card), _greedy_store(name,
                                                                     "cpu")
    got_store.select(5, method="flat")                  # builds the kernel
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = got_store.select(50, method="flat")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert syncs == []
    counts = ops.launch_counts()
    assert counts["greedy_flat"] == 1 and counts["popcount_words"] == 0
    want = want_store.select(50, method="flat")
    assert torch.equal(got.seeds.cpu(), want.seeds)
    assert torch.equal(got.gains.cpu(), want.gains)
    assert got.frac.cpu().numpy().tobytes() == want.frac.numpy().tobytes()


@pytest.mark.cuda
def test_greedy_flat_on_an_empty_pool(card):
    """No element: Occur is all zero, every seed is 0 with gain 0."""
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    seeds, gains = tgreedy.greedy_flat(
        empty, empty, empty.bool(), n=33, num_rows=32, k=4)
    assert seeds.tolist() == [0] * 4 and gains.tolist() == [0] * 4


@pytest.mark.cuda
def test_greedy_grid_and_barriers(card):
    """The grid is a block an SM; the barrier-only launch of that grid
    runs and is not counted as a greedy_flat launch."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert tgreedy.grid_blocks(card) == sms
    before = ops.launch_counts()["greedy_flat"]
    tgreedy.grid_barriers(100, card)
    torch.cuda.synchronize()
    assert ops.launch_counts()["greedy_flat"] == before


@pytest.mark.cuda
def test_greedy_wrapper_checks_inputs(card):
    store = _greedy_store("small", card)
    (flat, ids, valid), kw = _store_args(store)
    with pytest.raises(TypeError):
        tgreedy.greedy_flat(flat.long(), ids, valid, **kw, k=2)
    with pytest.raises(TypeError):
        tgreedy.greedy_flat(flat, ids, valid.int(), **kw, k=2)
    with pytest.raises(ValueError):
        tgreedy.greedy_flat(flat, ids.cpu(), valid, **kw, k=2)
    with pytest.raises(ValueError):
        tgreedy.greedy_flat(flat, ids[:-1], valid, **kw, k=2)
    strided = torch.zeros(2 * flat.shape[0], dtype=torch.int32,
                          device=card)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        tgreedy.greedy_flat(flat, strided, valid, **kw, k=2)
    for bad in (dict(kw, n=0), dict(kw, num_rows=0)):
        with pytest.raises(ValueError):
            tgreedy.greedy_flat(flat, ids, valid, **bad, k=2)
    with pytest.raises(ValueError):
        tgreedy.greedy_flat(flat, ids, valid, **kw, k=0)


# the approximate mode's sketch greedy (csrc/greedy.cu, greedy_sketch):
# every lane layout (a thread a row at W <= 4, 16-byte loads at W % 4 == 0,
# lane groups of 2 to 32), words off the 16-byte alignment, and a cov too
# wide for shared memory (read through each block's copy in the scratch)


def _sketch_words(r, w, kind):
    """(r, w) int32 sketch words: ``random`` (bit 31 in about half),
    ``sparse`` (one bit a row among 8 buckets: ties), ``saturating`` (sparse
    with up to three rows of all ones: every gain is 0 once one is
    picked)."""
    if kind == "random":
        return _words(r, w)
    words = np.zeros((r, w), np.uint32)
    bucket = RNG.integers(0, min(8, 32 * w), r)
    words[np.arange(r), bucket >> 5] = np.uint32(1) << (bucket & 31)
    if kind == "saturating":
        words[RNG.choice(r - 1, min(3, r - 1), replace=False)] = 0xFFFFFFFF
    return torch.tensor(words.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "sparse", "saturating"])
@pytest.mark.parametrize("r,w", [(301, 1), (3, 2), (257, 3), (75881, 4),
                                 (301, 5), (301, 8), (4097, 32), (301, 128),
                                 (2049, 512), (40, 60000)])
def test_greedy_sketch_kernel_equals_plain(card, r, w, kind):
    """Byte for byte at k = 1, 50 and, up to 300 nodes, past the last node
    (the early stop and the padding), on the words as given and one word
    off the 16-byte alignment."""
    host = _sketch_words(r, w, kind)
    words = host.to(card)
    flat = torch.empty(r * w + 1, dtype=torch.int32, device=card)
    shifted = flat[1:].view(r, w)
    shifted.copy_(words)
    n = r - 1
    for k in (1, 50) + ((n + 3,) if n <= 300 else ()):
        want = ref.greedy_sketch_ref(host, n=n, k=k)
        for x in (words, shifted) if k == 50 else (words,):
            before = ops.launch_counts()["greedy_sketch"]
            got = tgreedy.greedy_sketch(x, n=n, k=k)
            torch.cuda.synchronize()
            assert ops.launch_counts()["greedy_sketch"] == before + 1
            for a, b in zip(got, want):
                assert a.dtype == torch.int32 and a.is_cuda
                assert torch.equal(a.cpu(), b), (k, x is shifted)
    assert torch.equal(ref.greedy_sketch_ref(words, n=n, k=5)[0].cpu(),
                       ref.greedy_sketch_ref(host, n=n, k=5)[0])


@pytest.mark.cuda
def test_greedy_sketch_grid(card):
    """A block an SM; shared memory holds the widest sketch row the port
    meets at 16,384 buckets and more, not the 60,000 words above."""
    blocks, shared_words = tgreedy.sketch_grid(card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert blocks == sms == tgreedy.grid_blocks(card)
    assert 512 <= shared_words < 60000


@pytest.mark.cuda
def test_sketch_selection_is_one_launch_and_one_host_sync(card):
    """The store's selection on the card: one greedy_sketch launch, no
    popcount, and one host read (with torch's sync debug mode); it equals
    the CPU store's seeds, gains, frac bytes and certificate."""
    import warnings
    nodes = torch.tensor(RNG.integers(0, 3000, (2048, 7)))
    lens = torch.tensor(RNG.integers(0, 8, 2048))
    stores = {}
    for dev in ("cpu", card):
        stores[dev] = cov.SketchRRStore(3000, sketch_k=1024, device=dev)
        stores[dev].append_batch((nodes, lens))
    stores[card].select(5)                              # builds the kernel
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    info = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = stores[card].select(50, info_out=info)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, syncs
    counts = ops.launch_counts()
    assert counts["greedy_sketch"] == 1
    assert counts["popcount_words"] == counts["sketch_union_popcount"] == 0
    want_info = {}
    want = stores["cpu"].select(50, info_out=want_info)
    assert torch.equal(got.seeds.cpu(), want.seeds)
    assert torch.equal(got.gains.cpu(), want.gains)
    assert got.frac.cpu().numpy().tobytes() == want.frac.numpy().tobytes()
    assert info == want_info


@pytest.mark.cuda
def test_sketch_fold_flag_raises_at_the_next_read(card):
    """A fold given the store's flag does not raise at a bucket outside the
    sketch (it reads nothing back); the next selection and the next append
    do.  The in-range pairs are folded, as on the CPU."""
    store = cov.SketchRRStore(10, sketch_k=64, device=card)
    v = torch.tensor([1, 2, 3], dtype=torch.int32, device=card)
    b = torch.tensor([5, 64, 63], dtype=torch.int32, device=card)
    ops.sketch_scatter_or(store.words, v, b, bad=store.fold_error)
    assert store.fold_error.tolist() == [1]
    cpu = torch.zeros(11, 2, dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    ref.sketch_scatter_or_ref(cpu, v.cpu(), b.cpu(), flag)
    assert torch.equal(store.words.cpu(), cpu) and flag.tolist() == [1]
    with pytest.raises(ValueError, match="outside"):
        store.select(3)
    with pytest.raises(ValueError, match="outside"):
        store.append_batch((torch.tensor([[1, 2]]), torch.tensor([2])))
    with pytest.raises(ValueError):
        ops.sketch_scatter_or(store.words, v, b,
                              bad=torch.zeros(1, dtype=torch.int64,
                                              device=card))


@pytest.mark.cuda
def test_greedy_sketch_wrapper_checks_inputs(card):
    words = _words(9, 4).to(card)
    with pytest.raises(TypeError):
        tgreedy.greedy_sketch(words.long(), n=8, k=2)
    with pytest.raises(ValueError):
        tgreedy.greedy_sketch(words.t(), n=3, k=2)
    with pytest.raises(ValueError):
        tgreedy.greedy_sketch(words[0], n=1, k=2)
    for bad in (dict(n=0, k=2), dict(n=10, k=2), dict(n=8, k=0)):
        with pytest.raises(ValueError):
            tgreedy.greedy_sketch(words, **bad)


def _celf_pool(device, n=3000, rows=5000, width=9):
    """A pool with rows of 0 to width elements, a hub in a third of the
    rows, and rows that repeat a node (the kernels count such a row
    once)."""
    rng = np.random.default_rng(11)
    lens = rng.integers(0, width + 1, rows)
    nodes = rng.integers(0, n, (rows, width))
    nodes[rng.random(rows) < 0.33, 0] = 7          # the hub
    nodes[:200, 1] = nodes[:200, 0]                # a node twice a row
    lens[:200] = np.maximum(lens[:200], 2)
    store = cov.DeviceRRStore(n, device=device)
    for i in range(0, rows, 1024):
        store.append_batch((torch.tensor(nodes[i:i + 1024]),
                            torch.tensor(lens[i:i + 1024])))
    t = store.n_elems
    return store, (store.flat[:t], store.ids[:t], store.valid[:t])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 32, 2048, 2049, 5000])
@pytest.mark.parametrize("cover", [0.0, 0.5])
def test_celf_kernels_equal_plain(card, c, cover):
    store, pool = _celf_pool(card)
    nw = store.row_capacity() // 32
    cov_words = _words(1, nw)[0].to(card) if cover else \
        torch.zeros(nw, dtype=torch.int32, device=card)
    cands = RNG.integers(-1, store.n_nodes + 1, c)
    cands[:min(c, 3)] = [7, -1, 7][:min(c, 3)]     # the hub, twice
    cands = torch.tensor(cands, dtype=torch.int32, device=card)
    before = ops.launch_counts()
    got = ops.celf_eval(*pool, cov_words, cands)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["celf_eval"] - before["celf_eval"] == -(-c // 2048)
    want = ref.celf_eval_ref(*pool, cov_words, cands)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got[0]) > 0 or cover
    for u in (7, int(pool[0][0]), 0, store.n_nodes, -1):
        mine, plain = cov_words.clone(), cov_words.clone()
        gain = ops.celf_apply(*pool, mine, u)
        want_gain = ref.celf_apply_ref(*pool, plain, u)
        torch.cuda.synchronize()
        assert gain.dtype == torch.int32 and gain.dim() == 0
        assert int(gain) == int(want_gain)
        assert torch.equal(mine, plain)
    assert ops.launch_counts()["celf_apply"] - after["celf_apply"] == 5


@pytest.mark.cuda
def test_celf_kernels_on_an_empty_pool_and_a_short_cover(card):
    flat = torch.tensor([3, 3, 1, 3, 2, 3], dtype=torch.int32, device=card)
    ids = torch.tensor([0, 0, 0, 1, 1, 40], dtype=torch.int32, device=card)
    valid = torch.ones(6, dtype=torch.bool, device=card)
    cw = torch.zeros(1, dtype=torch.int32, device=card)   # row 40 dropped
    cands = torch.tensor([3, 1, 9], device=card)
    assert ops.celf_eval(flat, ids, valid, cw, cands).tolist() == [2, 1, 0]
    assert int(ops.celf_apply(flat, ids, valid, cw, 3)) == 2
    assert cw.tolist() == [3]
    empty = flat[:0]
    assert ops.celf_eval(empty, ids[:0], valid[:0], cw,
                         cands).tolist() == [0, 0, 0]
    assert int(ops.celf_apply(empty, ids[:0], valid[:0], cw, 3)) == 0
    assert ops.celf_eval(flat, ids, valid, cw, cands[:0]).numel() == 0


@pytest.mark.cuda
def test_celf_wrappers_check_inputs(card):
    from repro_torch.kernels import celf as tcelf
    _, pool = _celf_pool(card, rows=64)
    cw = torch.zeros(4, dtype=torch.int32, device=card)
    cands = torch.tensor([1, 2], device=card)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcelf.celf_eval(*(x.cpu() for x in pool), cw.cpu(), cands.cpu())
    with pytest.raises(TypeError):
        tcelf.celf_eval(pool[0].long(), *pool[1:], cw, cands)
    with pytest.raises(ValueError):
        tcelf.celf_eval(*pool, cw.long(), cands)
    with pytest.raises(ValueError):
        tcelf.celf_eval(*pool, cw[:0], cands)
    with pytest.raises(ValueError):
        tcelf.celf_eval(*pool, cw, cands.float())
    with pytest.raises(ValueError):
        tcelf.celf_apply(pool[0], pool[1][:-1], pool[2], cw, 1)
    with pytest.raises(ValueError):
        tcelf.celf_apply(*pool, cw, 1 << 31)


@pytest.mark.cuda
@pytest.mark.parametrize("eval_batch", [1, 32])
def test_celf_solve_on_card_equals_flat(card, eval_batch):
    """A celf solve on the card equals the flat solve on the card and the
    celf solve on the CPU, through one celf_select launch a selection and
    the exact store's fold (no celf_eval, celf_apply or sweep kernel)."""
    prob = IMProblem(k=10, eps=0.4)
    flat = IMMSolver(_graph(card), batch=256, selection="fused", seed=4,
                     device=card).solve(prob)
    cpu = IMMSolver(_graph("cpu"), batch=256, selection="celf", seed=4,
                    eval_batch=eval_batch, device="cpu").solve(prob)
    ops.reset_launch_counts()
    gpu = IMMSolver(_graph(card), batch=256, selection="celf", seed=4,
                    eval_batch=eval_batch, device=card).solve(prob)
    counts = ops.launch_counts()
    assert counts["sketch_fold_rows"] > 0
    for name in ("celf_eval", "celf_apply", "sketch_union_popcount",
                 "popcount_words", "sketch_scatter_or"):
        assert counts[name] == 0, name
    assert counts["celf_select"] == gpu.stats.lb_iters + 1
    for other in (flat, cpu):
        np.testing.assert_array_equal(gpu.seeds, other.seeds)
        np.testing.assert_array_equal(gpu.gains, other.gains)
        assert gpu.frac == other.frac
        assert gpu.stats.theta == other.stats.theta
    early = IMMSolver(_graph(card), batch=256, selection="celf", seed=4,
                      device=card).solve(IMProblem(k=10, eps=0.4,
                                                   early_exit=True))
    np.testing.assert_array_equal(early.seeds, gpu.seeds)
    assert early.stats.theta == gpu.stats.theta


# celf_select (csrc/celf.cu): a whole CELF selection in one cooperative
# launch, against its plain version on a host copy, in every field


def _host_pool(store):
    t = store.n_elems
    return tuple(x[:t].cpu() for x in (store.flat, store.ids, store.valid))


def _select_both(store, k, c, sketch):
    """celf_select on the card and celf_select_ref on a host copy."""
    from repro_torch.kernels import celf as tcelf
    t = store.n_elems
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    kw = dict(n=store.n_nodes, num_rows=store.row_capacity(), k=k, c=c)
    got = tcelf.celf_select(*pool, sketch=sketch, **kw)
    want = ref.celf_select_ref(*_host_pool(store), sketch=None
                               if sketch is None else sketch.cpu(), **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("sketch_k", [None, 64, 1024])
@pytest.mark.parametrize("c", [1, 32, 2500])
def test_celf_select_kernel_equals_plain(card, c, sketch_k):
    """Seeds, gains and both counts at one candidate a call, the default
    32 and a batch past a chunk of 2,048 (two chunks), with and without
    the sketch's sweep; a row may repeat a node and a hub is in a third of
    the rows."""
    store, _ = _celf_pool(card)
    sketch = None if sketch_k is None else store.sketch_words(sketch_k)
    before = ops.launch_counts()["celf_select"]
    got, want = _select_both(store, 30, c, sketch)
    assert ops.launch_counts()["celf_select"] == before + 1
    for a, b in zip(got[:3], want):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)
    assert int(got[3]) > 0                        # grid barriers run


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "past_n", "chunks3", "tiny",
                                  "wide_sketch"])
def test_celf_select_kernel_on_edge_pools(card, case):
    """An empty pool (every gain 0, node 0 again and again), k past n, a
    batch of three chunks (5,000 of 6,000 nodes), fewer nodes than blocks,
    and a sketch row wider than shared memory holds (each block's union in
    the scratch)."""
    from repro_torch.kernels import celf as tcelf
    k, c, sketch = 5, 32, None
    if case == "empty":
        store = cov.DeviceRRStore(50, device=card)
    elif case == "chunks3":
        store, _ = _celf_pool(card, n=6000, rows=3000)
        c = 5000
    elif case == "tiny":
        store, _ = _celf_pool(card, n=20, rows=200, width=4)
        k, c = 25, 3
    else:
        store, _ = _celf_pool(card, n=40, rows=300, width=5)
        k = 45 if case == "past_n" else 8
        if case == "wide_sketch":
            _, shared_words = tcelf.select_grid(card)
            sketch = _words(41, shared_words + 5).to(card)
    got, want = _select_both(store, k, c, sketch)
    for a, b in zip(got[:3], want):
        assert torch.equal(a.cpu(), b), case
    if case == "empty":
        assert want[0].tolist() == [0] * k and not want[1].any()


@pytest.mark.cuda
def test_celf_selection_is_one_launch_and_one_host_sync(card):
    """The store's celf selection on the card: one celf_select launch, no
    other kernel, and one host read (torch's sync debug mode); it equals
    the CPU store's seeds, gains, frac bytes and stats_out."""
    import warnings
    nodes = torch.tensor(RNG.integers(0, 3000, (2048, 7)))
    lens = torch.tensor(RNG.integers(0, 8, 2048))
    stores = {}
    for dev in ("cpu", card):
        stores[dev] = cov.DeviceRRStore(3000, sketch_k=1024, device=dev)
        stores[dev].append_batch((nodes, lens))
    stores[card].select(5, method="celf")               # builds the kernel
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = cov.select_seeds_celf(stores[card], 50, stats_out=stats)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, syncs
    counts = ops.launch_counts()
    assert counts["celf_select"] == 1
    assert sum(counts.values()) == 1, counts
    want_stats = {}
    want = cov.select_seeds_celf(stores["cpu"], 50, stats_out=want_stats)
    assert torch.equal(got.seeds.cpu(), want.seeds)
    assert torch.equal(got.gains.cpu(), want.gains)
    assert got.frac.cpu().numpy().tobytes() == want.frac.numpy().tobytes()
    assert stats == want_stats
    stores[card].fold_error[0] = 1
    with pytest.raises(ValueError, match="outside"):   # at the one read
        cov.select_seeds_celf(stores[card], 3)


@pytest.mark.cuda
def test_celf_select_wrapper_checks_inputs(card):
    """Every bad input raises before a launch; a CPU tensor is refused (no
    plain fallback on the wrapper)."""
    from repro_torch.kernels import celf as tcelf
    store, pool = _celf_pool(card, rows=64)
    kw = dict(n=store.n_nodes, num_rows=store.row_capacity(), k=3, c=4)
    sk = store.sketch_words(64)
    before = ops.launch_counts()["celf_select"]
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcelf.celf_select(*(x.cpu() for x in pool), **kw)
    with pytest.raises(TypeError):
        tcelf.celf_select(pool[0].long(), *pool[1:], **kw)
    with pytest.raises(ValueError):
        tcelf.celf_select(pool[0], pool[1][:-1], pool[2], **kw)
    for bad in (dict(kw, c=0), dict(kw, c=kw["n"] + 1), dict(kw, k=0),
                dict(kw, num_rows=48), dict(kw, num_rows=0)):
        with pytest.raises(ValueError):
            tcelf.celf_select(*pool, **bad)
    with pytest.raises(ValueError):
        tcelf.celf_select(*pool, sketch=sk[:10], **kw)
    with pytest.raises(TypeError):
        tcelf.celf_select(*pool, sketch=sk.long(), **kw)
    with pytest.raises(ValueError):
        tcelf.celf_select(*pool, sketch=sk.cpu(), **kw)
    assert ops.launch_counts()["celf_select"] == before


@pytest.mark.cuda
def test_celf_select_barrier_floor_runs(card):
    """celf_select's grid (a block an SM) is greedy_flat's, whose
    barrier-only launch runs and is not counted as a celf_select launch."""
    from repro_torch.kernels import celf as tcelf
    from repro_torch.kernels import greedy as tgreedy
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert tcelf.select_grid(card)[0] == tgreedy.grid_blocks(card) == sms
    before = ops.launch_counts()["celf_select"]
    tgreedy.grid_barriers(100, card)
    torch.cuda.synchronize()
    assert ops.launch_counts()["celf_select"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", [(1, 1), (33, 5), (7, 2373), (512, 2372)])
def test_frontier_update_kernel_equals_plain(card, b, w):
    """new = a & ~visited and visited |= a in place, exact, on the words as
    given and one word off the 16-byte alignment; a may be visited."""
    a, v = _words(b, w), _words(b, w)
    for shift in (0, 1):
        buf = torch.zeros(2, b * w + shift, dtype=torch.int32, device=card)
        x, y = (buf[i, shift:].view(b, w) for i in (0, 1))
        x.copy_(a)
        y.copy_(v)
        plain = v.clone()
        new = ops.frontier_update(x, y)
        want = ref.frontier_update_ref(a, plain)
        torch.cuda.synchronize()
        assert torch.equal(new.cpu(), want) and torch.equal(y.cpu(), plain)
        assert torch.equal(y.cpu(), v | a)
    same = v.to(card)
    assert not ops.frontier_update(same, same).any()
    assert torch.equal(same.cpu(), v)


@pytest.mark.cuda
def test_frontier_update_wrapper_checks_inputs(card):
    x = _words(4, 3).to(card)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbitset.frontier_update(x.cpu(), x.cpu())
    with pytest.raises(TypeError):
        tbitset.frontier_update(x, x.long())
    with pytest.raises(ValueError):
        tbitset.frontier_update(x, x[:2])
    with pytest.raises(ValueError):
        tbitset.frontier_update(x, x.t())


# greedy_sketch's forms (csrc/greedy.cu: rows in registers, shared memory or
# global memory; the blocks' records read after each step's barrier) and
# celf_select's top-list path (c <= 32), against their plain versions


def _boundary_words(n, w, blocks):
    """Sparse rows with equal best rows on both sides of the first block
    boundaries of a grid of ``blocks`` (the last row of a block and the
    first of the next), and an all-zero row at each other boundary."""
    words = _sketch_words(n + 1, w, "sparse").numpy().view(np.uint32).copy()
    slots = -(-n // blocks)
    for b, v in enumerate(range(slots, n, slots)):
        if b < 4:
            pattern = RNG.integers(0, 1 << 32, size=w, dtype=np.int64)
            words[v - 1] = words[v] = (pattern | 0xFFFF).astype(np.uint32)
        else:
            words[v] = 0
    return torch.tensor(words.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,form", [
    (40_000, 1, "registers"), (75_879, 3, "registers"),
    (75_879, 4, "registers"), (135_000, 4, "registers"),
    (600_000, 4, "shared"), (75_879, 5, "shared"), (75_879, 32, "shared"),
    (75_879, 128, "global"), (75_879, 512, "global")])
def test_greedy_sketch_forms_equal_plain(card, n, w, form):
    """Each form of the rows at the shapes that take it: random, sparse
    (ties), boundary (equal best rows on both sides of block boundaries)
    and all-zero words, k = 50, byte for byte."""
    from repro_torch.kernels import greedy as tgreedy
    blocks, shared_words = tgreedy.sketch_grid(card)
    lay = tgreedy.sketch_layout(w, w % 4 == 0, n=n, blocks=blocks,
                                shared_words=shared_words)
    assert lay.form == form
    kinds = {"random": _sketch_words(n + 1, w, "random"),
             "sparse": _sketch_words(n + 1, w, "sparse"),
             "boundary": _boundary_words(n, w, blocks),
             "zero": torch.zeros(n + 1, w, dtype=torch.int32)}
    for kind, host in kinds.items():
        got = tgreedy.greedy_sketch(host.to(card), n=n, k=50)
        want = ref.greedy_sketch_ref(host, n=n, k=50)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (kind, form)
        if kind == "zero":
            assert want[0].tolist() == list(range(50))
        if kind == "boundary":                     # the lower of a pair
            slots = -(-n // blocks)
            assert int(want[0][0]) % slots == slots - 1


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 4, 32, 512])
def test_greedy_sketch_past_the_last_node(card, w):
    """k past n: the steps stop when no node is left, on every form."""
    host = _sketch_words(41, w, "random")
    got = tgreedy.greedy_sketch(host.to(card), n=40, k=60)
    want = ref.greedy_sketch_ref(host, n=40, k=60)
    assert int(want[2]) == 40
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 32])
def test_greedy_sketch_back_to_back_launches(card, w):
    """200 launches back to back, no sync between them, on random sketches
    from 200 seeds: each equals its plain version.  The scratch of a
    launch is the allocator's reuse of the last one's, so a record slot
    read before its step's store would show."""
    n, k = 20_000, 20
    hosts, outs = [], []
    for seed in range(200):
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 1 << 32, size=(n + 1, w), dtype=np.int64)
        u &= rng.integers(0, 1 << 32, size=(n + 1, w), dtype=np.int64)
        hosts.append(torch.tensor(u.astype(np.uint32).view(np.int32)))
    cards = [h.to(card) for h in hosts]
    torch.cuda.synchronize()
    for x in cards:
        outs.append(tgreedy.greedy_sketch(x, n=n, k=k))
    torch.cuda.synchronize()
    for host, got in zip(hosts, outs):
        want = ref.greedy_sketch_ref(host, n=n, k=k)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("sketch_k", [1024, 16384])
@pytest.mark.parametrize("c", [1, 32, 64, 65, 2048, 2049])
def test_celf_select_list_and_radix_paths_equal_plain(card, c, sketch_k):
    """The top-list path (c <= 32: lists of 32 keys) and the radix pick
    (c > 32, two chunks past 2,048) at the CELF cell's sketch widths:
    seeds, gains and both counts, and the layout the launch takes."""
    from repro_torch.kernels import celf as tcelf
    store, _ = _celf_pool(card, n=6000, rows=6000)
    sketch = store.sketch_words(sketch_k)
    blocks, shared_words = tcelf.select_grid(card)
    lay = tcelf.select_layout(store.n_nodes, store.row_capacity(), c,
                              sketch.shape[1], blocks, shared_words,
                              store.n_elems)
    assert lay.list == (tcelf.LIST if c <= tcelf.LIST else 0)
    got, want = _select_both(store, 30, c, sketch)
    for a, b in zip(got[:3], want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), (c, sketch_k)
    assert int(got[3]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 16, 32])
def test_celf_select_list_path_pool_in_memory(card, c):
    """The list path with the pool's pairs left in memory (a pool whose
    block share does not fit beside the merge buffers) equals the plain
    version."""
    from repro_torch.kernels import celf as tcelf
    store, _ = _celf_pool(card, n=3000, rows=700_000, width=9)
    blocks, shared_words = tcelf.select_grid(card)
    lay = tcelf.select_layout(store.n_nodes, store.row_capacity(), c, 32,
                              blocks, shared_words, store.n_elems)
    assert lay.list and not lay.pool_on_chip
    got, want = _select_both(store, 10, c, store.sketch_words(1024))
    for a, b in zip(got[:3], want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("sketch_k,eval_batch", [(1024, 64), (16384, 32)])
def test_celf_early_exit_solve_on_card_equals_cpu(card, sketch_k, eval_batch):
    """A celf solve with the early exit on the card (top lists of 64 and of
    32 keys) equals the same solve on the CPU (the plain version) in every
    field that a caller reads."""
    prob = IMProblem(k=10, eps=0.4, early_exit=True)
    kw = dict(batch=256, selection="celf", seed=4, sketch_k=sketch_k,
              eval_batch=eval_batch)
    cpu = IMMSolver(_graph("cpu"), device="cpu", **kw).solve(prob)
    gpu = IMMSolver(_graph(card), device=card, **kw).solve(prob)
    np.testing.assert_array_equal(gpu.seeds, cpu.seeds)
    np.testing.assert_array_equal(gpu.gains, cpu.gains)
    assert gpu.frac == cpu.frac
    assert gpu.stats.theta == cpu.stats.theta
    assert gpu.stats.early_exit_skips == cpu.stats.early_exit_skips


@pytest.mark.cuda
def test_celf_select_back_to_back_launches(card):
    """200 celf_select launches back to back on pools from 200 seeds, no
    sync between them: each equals its plain version."""
    from repro_torch.kernels import celf as tcelf
    outs, hosts = [], []
    for seed in range(200):
        rng = np.random.default_rng(seed)
        n, rows, width = 300, 400, 6
        lens = rng.integers(0, width + 1, rows)
        nodes = rng.integers(0, n, (rows, width))
        store = cov.DeviceRRStore(n, sketch_k=64, device=card)
        store.append_batch((torch.tensor(nodes), torch.tensor(lens)))
        t = store.n_elems
        pool = (store.flat[:t], store.ids[:t], store.valid[:t])
        kw = dict(n=n, num_rows=store.row_capacity(), k=8, c=16)
        outs.append(tcelf.celf_select(*pool, sketch=store.sketch_words(),
                                      **kw))
        hosts.append((_host_pool(store), store.sketch_words().cpu(), kw))
    torch.cuda.synchronize()
    for got, (pool, sketch, kw) in zip(outs, hosts):
        want = ref.celf_select_ref(*pool, sketch=sketch, **kw)
        for a, b in zip(got[:3], want):
            assert torch.equal(a.cpu(), b)


# ------------------------------------------------------- problem variants

def _alias_table(n, device, kind):
    """(weights, their alias table on ``device``)."""
    from repro_torch.core import roots
    w = {"mod7": np.arange(n) % 7,
         "sparse": np.isin(np.arange(n), [3, n // 2, n - 1]) * 2.0,
         "random": np.random.default_rng(n).random(n) ** 3}[kind]
    w = w.astype(np.float32)
    return w, roots.build_alias_table(w, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mod7", "sparse", "random"])
@pytest.mark.parametrize("name,qcap", [("ba200", None), ("ba1500", 5),
                                       ("hub", None), ("standin", None)])
def test_queue_kernel_with_a_table_equals_plain(card, name, qcap, kind):
    """Weighted roots drawn in the launch: the kernel against the plain
    version with the same alias table, on the card and on the CPU, byte for
    byte, roots included; every root has a positive weight."""
    g = _queue_graph(name, card)
    w, table = _alias_table(g.n_nodes, card, kind)
    batch = 512 if name == "standin" else 128
    q = g.n_nodes if qcap is None else qcap
    args = (g.offsets, g.indices, g.weights, round_seed(7, 2), batch)
    ops.reset_launch_counts()
    got = ops.queue_bfs(*args, qcap=q, ec=128, table=table)
    assert ops.launch_counts()["queue_bfs"] == 1
    _assert_same_round(got, ref.queue_round_ref(*args, qcap=q, ec=128,
                                                table=table))
    if name != "standin":
        cpu = ref.queue_round_ref(
            *(x.cpu() for x in args[:3]), *args[3:], qcap=q, ec=128,
            table=tuple(x.cpu() for x in table))
        _assert_same_round(tuple(x.cpu() for x in got), cpu)
    assert (w[got[4].cpu().numpy()] > 0).all()


@pytest.mark.cuda
def test_queue_wrapper_checks_the_table(card):
    g = _queue_graph("ba200", card)
    _, table = _alias_table(g.n_nodes, card, "mod7")
    args = (g.offsets, g.indices, g.weights, 1, 8)
    with pytest.raises(TypeError):
        tqueue.queue_bfs(*args, qcap=8, ec=8,
                         table=(table.prob.double(), table.alias))
    with pytest.raises(ValueError):
        tqueue.queue_bfs(*args, qcap=8, ec=8,
                         table=(table.prob[:-1], table.alias[:-1]))
    with pytest.raises(ValueError):
        tqueue.queue_bfs(*args, qcap=8, ec=8,
                         table=(table.prob.cpu(), table.alias))


def _variant_kw(n, case, device):
    v = torch.arange(n, device=device)
    costs = (1 + v % 5).to(torch.float32)
    every = torch.ones(n, dtype=torch.bool, device=device)
    kw = dict(cand=every, costs=None, budget=float("inf"), n_group=n,
              n_groups=1)
    if case == "candidates":
        kw.update(k=20, cand=v % 3 == 0)
    elif case == "budget":
        kw.update(k=40, costs=costs, budget=40.0)
    elif case == "cand_budget":
        kw.update(k=30, cand=v % 3 == 0, costs=costs, budget=31.0)
    elif case == "unit_budget":
        kw.update(k=12, costs=torch.ones(n, device=device), budget=12.0)
    elif case == "exhausted":
        kw.update(k=5, cand=(v == 7) | (v == 9))
    elif case == "groups":
        kw.update(k=9, n_group=-(-n // 3), n_groups=3, group_quota=2)
    elif case == "narrow_groups":
        kw.update(k=30, n_group=7, n_groups=-(-n // 7), group_quota=1)
    elif case == "zero_quota":
        kw.update(k=4, group_quota=0)
    elif case == "plain":
        kw.update(k=30)
    kw.setdefault("group_quota", kw["k"])
    return kw


_VARIANT_CASES = ["candidates", "budget", "cand_budget", "unit_budget",
                  "exhausted", "groups", "narrow_groups", "zero_quota"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _VARIANT_CASES)
@pytest.mark.parametrize("name", ["ragged", "small", "wide", "longrow"])
def test_greedy_flat_variant_kernel_equals_plain(card, name, case):
    """The variant scan in one launch against its plain version, seeds,
    gains and the float32 bytes of spent; no seed repeats, the candidates
    and group quotas hold."""
    store = _greedy_store(name, card)
    args, kw = _store_args(store)
    vkw = _variant_kw(store.n_nodes, case, card)
    want = ref.greedy_flat_variant_ref(*args, **kw, **vkw)
    before = ops.launch_counts()["greedy_flat_variant"]
    got = tgreedy.greedy_flat_variant(*args, **kw, **vkw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["greedy_flat_variant"] == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (case, x, y)
    s = got[0].cpu().numpy()
    live = s[s < store.n_nodes]
    assert len(live) == len(set(live.tolist()))
    assert bool(vkw["cand"][torch.as_tensor(live, device=card)].all())
    if case in ("groups", "narrow_groups"):
        quota = np.bincount(live // vkw["n_group"], minlength=vkw["n_groups"])
        assert quota.max() <= vkw["group_quota"]
    if case == "zero_quota":
        assert len(live) == 0
    if vkw["costs"] is not None:
        assert float(got[2]) <= vkw["budget"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["candidates", "cand_budget", "groups",
                                  "narrow_groups"])
def test_greedy_flat_variant_past_the_shared_layout(card, case):
    """n = 4,000,000: a block's state no longer fits in shared memory, so
    it lives in the scratch; the kernel still equals its plain version."""
    n = 4_000_000
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 50, 2000)
    nodes = np.full((2000, 50), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    store = cov.DeviceRRStore(n, device=card)
    store.append_batch((torch.tensor(nodes), torch.tensor(lens)))
    args, kw = _store_args(store)
    blocks, shared_bytes = tgreedy.flat_grid(card)
    vkw = _variant_kw(n, case, card)
    lay = tgreedy.flat_layout(n, kw["num_rows"], blocks, shared_bytes,
                              vkw["n_group"], vkw["n_groups"])
    assert not lay.shared
    got = tgreedy.greedy_flat_variant(*args, **kw, **vkw)
    want = ref.greedy_flat_variant_ref(*args, **kw, **vkw)
    for x, y in zip(got, want):
        assert torch.equal(x, y), case


@pytest.mark.cuda
def test_greedy_flat_variant_wrapper_checks_inputs(card):
    store = _greedy_store("small", card)
    args, kw = _store_args(store)
    n = store.n_nodes
    vkw = _variant_kw(n, "budget", card)
    for bad in (dict(cand=vkw["cand"][:-1]), dict(cand=vkw["cand"].int()),
                dict(costs=vkw["costs"].double()),
                dict(costs=vkw["costs"].cpu()),
                dict(n_group=1, n_groups=2)):
        with pytest.raises(ValueError):
            tgreedy.greedy_flat_variant(*args, **kw, **{**vkw, **bad})


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,form", [
    (40_000, 1, "registers"), (75_879, 4, "registers"),
    (135_000, 4, "registers"), (75_879, 5, "shared"),
    (75_879, 32, "shared"), (75_879, 128, "global"),
    (75_879, 512, "global")])
def test_greedy_sketch_masked_forms_equal_plain(card, n, w, form):
    """The candidate mask on each form of the rows: every third node, two
    nodes (the greedy runs out, k = 5), and one candidate per block
    boundary pair, against the plain version byte for byte."""
    blocks, shared_words = tgreedy.sketch_grid(card)
    lay = tgreedy.sketch_layout(w, w % 4 == 0, n=n, blocks=blocks,
                                shared_words=shared_words)
    assert lay.form == form
    v = torch.arange(n)
    masks = {"third": v % 3 == 0, "two": (v == 7) | (v == n - 2),
             "boundary": v % -(-n // blocks) == 0}
    for kind in ("random", "sparse"):
        host = _sketch_words(n + 1, w, kind)
        for mname, mask in masks.items():
            k = 5 if mname == "two" else 50
            got = tgreedy.greedy_sketch(host.to(card), n=n, k=k,
                                        cand=mask.to(card))
            want = ref.greedy_sketch_ref(host, n=n, k=k, cand=mask)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (kind, mname, form)
            s = want[0]
            assert bool(mask[s[s < n]].all())
            if mname == "two":
                assert int(want[2]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["flat", "bitset", "celf"])
def test_variant_selections_on_card_equal_cpu(card, method):
    """The store's variant selections on the card against the same store on
    the CPU: candidates with a budget, seeds, gains, frac and spent bytes."""
    outs = {}
    for dev in (card, torch.device("cpu")):
        n, batches = _greedy_batches("wide")
        store = cov.DeviceRRStore(n, sketch_k=256, device=dev)
        for nodes, lens in batches:
            store.append_batch((torch.as_tensor(nodes), torch.as_tensor(lens)))
        costs = (1 + np.arange(n) % 5).astype(np.float32)
        spec = cov.SelectionSpec(k_steps=25, n_group=n, group_quota=25,
                                 cand=np.arange(n) % 2 == 0, costs=costs,
                                 budget=25.0)
        res = store.select(0, method=method, spec=spec, eval_batch=16)
        outs[dev.type] = [x.cpu() for x in res]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _row_weights_of(ids, kind):
    """Element weights from the row ids: integer (r mod 7 + 1), dyadic
    ((r mod 7) / 8), with zeros, or non-dyadic (1 / (r mod 7 + 1)); every
    element of a row carries the row's weight, as the store writes it."""
    r = ids.to(torch.int64) % 7
    return {"integer": r + 1.0, "dyadic": r / 8.0,
            "fraction": 1.0 / (r + 1.0)}[kind].to(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "candidates", "budget",
                                  "exhausted", "groups", "zero_quota"])
@pytest.mark.parametrize("name", ["ragged", "wide", "longrow"])
@pytest.mark.parametrize("kind", ["integer", "dyadic"])
def test_weighted_greedy_flat_variant_kernel_equals_plain(card, name, case,
                                                          kind):
    """The weighted form in one launch against its plain version: seeds
    and the float32 bytes of gains and spent, at weights whose float32
    sums are exact in any order; counted under its own name."""
    store = _greedy_store(name, card)
    args, kw = _store_args(store)
    vkw = _variant_kw(store.n_nodes, case, card)
    ew = _row_weights_of(args[1], kind)
    want = ref.greedy_flat_variant_ref(*args, **kw, **vkw, ew=ew)
    before = ops.launch_counts()
    got = tgreedy.greedy_flat_variant(*args, **kw, **vkw, ew=ew)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["greedy_flat_variant[weighted]"] == \
        before["greedy_flat_variant[weighted]"] + 1
    assert after["greedy_flat_variant"] == before["greedy_flat_variant"]
    assert got[1].dtype == torch.float32
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y), (case, x, y)


@pytest.mark.cuda
def test_weighted_greedy_flat_variant_non_dyadic_within_tolerance(card):
    """Non-dyadic weights: the atomics add in another order than the plain
    version, so each gain may differ in its last bits (relative 1e-5 for
    these few-hundred-term sums); the seeds agree here."""
    store = _greedy_store("wide", card)
    args, kw = _store_args(store)
    vkw = dict(_variant_kw(store.n_nodes, "candidates", card), k=30,
               group_quota=30)
    ew = _row_weights_of(args[1], "fraction")
    got = tgreedy.greedy_flat_variant(*args, **kw, **vkw, ew=ew)
    want = ref.greedy_flat_variant_ref(*args, **kw, **vkw, ew=ew)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_weighted_greedy_flat_variant_past_the_shared_layout(card):
    """n = 4,000,000: the weighted form with its state in the scratch."""
    n = 4_000_000
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 50, 2000)
    nodes = np.full((2000, 50), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    store = cov.DeviceRRStore(n, row_weighted=True, device=card)
    store.append_batch((torch.tensor(nodes), torch.tensor(lens)),
                       row_w=np.arange(2000) % 7 + 1)
    spec = cov.SelectionSpec(k_steps=40, n_group=n, group_quota=40,
                             cand=np.arange(n) % 2 == 0, weighted=True)
    got = cov.select_variant(store, spec)
    host = cov.DeviceRRStore(n, row_weighted=True, device="cpu")
    host.append_batch((torch.tensor(nodes), torch.tensor(lens)),
                      row_w=np.arange(2000) % 7 + 1)
    want = cov.select_variant(host, spec)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged", "wide", "longrow"])
def test_weighted_celf_kernels_equal_plain(card, name):
    """celf_eval and celf_apply with row weights against their plain
    versions: the float32 bytes of each candidate's covered weight and of
    the commit's gain, and the Covered words; a null weight pointer keeps
    the counts."""
    store = _greedy_store(name, card)
    args, kw = _store_args(store)
    rows = kw["num_rows"]
    roww = cov.row_weights(args[1], args[2], _row_weights_of(args[1],
                                                            "integer"), rows)
    cov_words = torch.zeros(rows // 32, dtype=torch.int32, device=card)
    ref.celf_apply_ref(*args, cov_words, 3, roww)
    cands = torch.tensor([0, 1, 2, 3, -1, 5, 5, store.n_nodes - 1],
                         dtype=torch.int32, device=card)
    before = ops.launch_counts()
    got = ops.celf_eval(*args, cov_words, cands, roww=roww)
    mine, plain = cov_words.clone(), cov_words.clone()
    gain = ops.celf_apply(*args, mine, 2, roww=roww)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["celf_eval[weighted]"] == before["celf_eval[weighted]"] + 1
    assert after["celf_apply[weighted]"] == before["celf_apply[weighted]"] + 1
    assert after["celf_eval"] == before["celf_eval"]
    want = ref.celf_eval_ref(*args, cov_words, cands, roww)
    want_gain = ref.celf_apply_ref(*args, plain, 2, roww)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert gain.dtype == torch.float32
    assert int(gain.view(torch.int32)) == int(want_gain.view(torch.int32))
    assert torch.equal(mine, plain)
    assert torch.equal(ops.celf_eval(*args, cov_words, cands),
                       ref.celf_eval_ref(*args, cov_words, cands))


def _lt_graph(name, device):
    """A reverse graph for the LT walks and its cumulative weights: BA
    graphs under WC weights (walks end on revisits) or at 0.8 of them, and
    a star whose hub row (5,000 in-edges) takes several search rounds."""
    from repro_torch.core import lt
    if name == "star":
        n = 5_001
        src = np.concatenate([np.arange(1, n), np.zeros(n - 1, np.int64)])
        dst = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n)])
        g = weights.wc_weights(csr.from_edges(src, dst, n, device=device))
    else:
        n, scale = {"ba200": (200, 1.0), "ba1500": (1500, 0.8)}[name]
        src, dst = generators.barabasi_albert(n, 4, seed=3)
        indeg = np.bincount(dst, minlength=n).astype(np.float64)
        g = csr.from_edges(src, dst, n, weights=(scale / indeg[dst]).astype(
            np.float32), device=device)
    g_rev = csr.reverse(g)
    return g_rev, lt.row_cumweights(g_rev)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,qcap", [("ba200", None), ("ba1500", None),
                                       ("ba1500", 3), ("star", None)])
def test_lt_walk_kernel_equals_plain(card, name, qcap, weighted):
    """One LT round in one launch against its plain version byte for
    byte: walks and their zeros, lengths, overflow, draws and roots."""
    from repro_torch.core.roots import build_alias_table
    from repro_torch.kernels import lt as tlt
    g_rev, rowcum = _lt_graph(name, card)
    n = g_rev.n_nodes
    qcap = n if qcap is None else qcap
    table = build_alias_table(np.arange(n) % 7, device=card) \
        if weighted else None
    args = (g_rev.offsets, g_rev.indices, rowcum, round_seed(5, 1), 300)
    before = ops.launch_counts()["lt_walk"]
    got = tlt.lt_walk(*args, qcap=qcap, table=table)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lt_walk"] == before + 1
    want = ref.lt_round_ref(*args, qcap=qcap, table=table)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    if qcap < n:
        assert bool(got[2].any())


@pytest.mark.cuda
def test_lt_walk_wrapper_checks_inputs(card):
    from repro_torch.kernels import lt as tlt
    g_rev, rowcum = _lt_graph("ba200", card)
    args = (g_rev.offsets, g_rev.indices)
    with pytest.raises(ValueError):
        tlt.lt_walk(*args, rowcum[:-1], 0, 8, qcap=8)
    with pytest.raises(TypeError):
        tlt.lt_walk(*args, rowcum.double(), 0, 8, qcap=8)
    with pytest.raises(ValueError):
        tlt.lt_walk(*args, rowcum.cpu(), 0, 8, qcap=8)
    with pytest.raises(ValueError):
        tlt.lt_walk(*args, rowcum, 0, 8, qcap=0)


@pytest.mark.cuda
@pytest.mark.parametrize("selection", ["flat", "bitset", "celf"])
def test_lt_and_row_weighted_solves_on_card_equal_cpu(card, selection):
    """An LT solve and a row-weighted solve on an engine instance, each on
    the card and on the CPU: every field equal (integer weights)."""
    from repro_torch.core.engine import make_engine
    w = (np.arange(1500) % 7).astype(np.float32)
    outs = {}
    for dev in (card, torch.device("cpu")):
        g = _graph(dev)
        lt_res = IMMSolver(g, model="lt", batch=256, selection=selection,
                           seed=2, device=dev).solve(IMProblem(k=8, eps=0.5))
        eng = make_engine("queue", csr.reverse(g), batch=256)
        rw = IMMSolver(g, engine=eng, selection=selection, seed=2,
                       device=dev)
        rw_res = rw.solve(IMProblem(k=8, eps=0.5, node_weights=w))
        assert rw._row_weight_mode
        outs[dev.type] = [(r.seeds.tolist(), np.asarray(r.gains).tobytes(),
                           np.float32(r.frac).tobytes(), r.spread,
                           r.stats.theta, r.stats.rounds)
                          for r in (lt_res, rw_res)]
    assert outs["cuda"] == outs["cpu"]


# the chunk dedup and the tiled roots of csrc/queue.cu, and the persistent
# lanes of csrc/refill.cu


def _multigraph(name, device, shuffle=False):
    """The reverse CSR of a multigraph as it is (no coalescing): ``"multi"``
    BA(300, 3) with WC weights and every third edge repeated at its own
    weight, twice; ``"multihub"`` 2,000 nodes whose node 7 is reached from
    every other node by one to five parallel edges of weight 0.02 (a row of
    about 6,000 edges, tiles full of duplicates) and 20,000 in-edges of
    weight 0.0005 from node 11 (past the kernel's 16,384-edge segment),
    plus a ring.  Rows are destination-sorted, or with ``shuffle`` each
    row's edges in a seeded random order (the ``sort`` mode's input)."""
    rng = np.random.default_rng(7)
    if name == "multi":
        src, dst = generators.barabasi_albert(300, 3, seed=4)
        s, d, w = csr.to_edges(weights.wc_weights(csr.from_edges(
            src, dst, 300, device="cpu")))
        rep = np.arange(s.size) % 3 == 0
        s, d = np.concatenate([s, s[rep], s[rep]]), np.concatenate(
            [d, d[rep], d[rep]])
        w = np.concatenate([w, w[rep], w[rep]])
        n = 300
    else:
        n = 2000
        others = np.setdiff1d(np.arange(n), [7])
        reps = rng.integers(1, 6, size=others.size)
        s = np.concatenate([np.repeat(others, reps), np.full(20000, 11),
                            np.arange(n)])
        d = np.concatenate([np.full(reps.sum(), 7), np.full(20000, 7),
                            (np.arange(n) + 1) % n])
        w = np.concatenate([np.full(reps.sum(), 0.02), np.full(20000, 5e-4),
                            np.full(n, 0.3)])
    g_rev = csr.reverse(csr.from_edges(s, d, n, weights=w.astype(np.float32),
                                       device="cpu"))
    if shuffle:
        offs, idx, wr = g_rev.numpy()
        row_of = np.repeat(np.arange(n), np.diff(offs.astype(np.int64)))
        order = np.lexsort((rng.random(idx.size), row_of))
        g_rev = csr.CSRGraph(torch.from_numpy(offs),
                             torch.from_numpy(idx[order]),
                             torch.from_numpy(wr[order]))
    return g_rev.to(device)


def _round_args(g):
    return g.offsets, g.indices, g.weights


@pytest.mark.cuda
@pytest.mark.parametrize("ec", [8, 128])
@pytest.mark.parametrize("qcap", [5, None], ids=["qcap5", "qcapn"])
@pytest.mark.parametrize("name", ["multi", "multihub"])
def test_queue_kernel_dedup_equals_plain(card, name, qcap, ec):
    """queue_bfs[dedup] against the plain version on the card and on the
    CPU, byte for byte, on destination-sorted rows (segmented and sort,
    which must agree) and on shuffled rows (sort)."""
    from repro_torch.core.rrset import detect_dedup_mode
    sorted_g = _multigraph(name, card)
    assert detect_dedup_mode(sorted_g) == "segmented"
    q = sorted_g.n_nodes if qcap is None else qcap
    rounds = {}
    for mode, g in (("segmented", sorted_g), ("sort", sorted_g),
                    ("shuffled", _multigraph(name, card, shuffle=True))):
        dedup = "segmented" if mode == "segmented" else "sort"
        ops.reset_launch_counts()
        got = ops.queue_bfs(*_round_args(g), 0xC0FFEE, 128, qcap=q, ec=ec,
                            dedup=dedup)
        assert ops.launch_counts()["queue_bfs"] == 1
        _assert_same_round(got, ref.queue_round_ref(
            *_round_args(g), 0xC0FFEE, 128, qcap=q, ec=ec, dedup=dedup))
        _assert_same_round(tuple(x.cpu() for x in got), ops.queue_bfs(
            *_round_args(g.to("cpu")), 0xC0FFEE, 128, qcap=q, ec=ec,
            dedup=dedup))
        rounds[mode] = got
    _assert_same_round(rounds["segmented"], rounds["sort"])
    for queue, length in zip(rounds["segmented"][0].cpu().numpy(),
                             rounds["segmented"][1].cpu().numpy()):
        assert len(set(queue[:length].tolist())) == length
    if qcap is None:
        assert int(rounds["segmented"][1].max()) > 20


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 3, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_queue_kernel_tiled_equals_plain(card, tile, weighted):
    """queue_bfs[tiled]: lanes bT .. bT + T - 1 share lane bT's root (its
    bucket and, with an alias table, its accept draw), each with its own
    trials; against the plain version on the card and the CPU; T = 1 is
    the untiled round."""
    from repro_torch.core.roots import build_alias_table
    g = _queue_graph("ba1500", card)
    table = (build_alias_table((np.arange(g.n_nodes) % 7).astype(np.float32),
                               device=card) if weighted else None)
    got = ops.queue_bfs(*_round_args(g), 99, 120, qcap=g.n_nodes, ec=128,
                        table=table, root_tile=tile)
    _assert_same_round(got, ref.queue_round_ref(
        *_round_args(g), 99, 120, qcap=g.n_nodes, ec=128, table=table,
        root_tile=tile))
    plain = ops.queue_bfs(*_round_args(g), 99, 120, qcap=g.n_nodes, ec=128,
                          table=table)
    roots = got[4].reshape(-1, tile)
    assert torch.equal(roots, plain[4][::tile, None].expand(-1, tile))
    if tile == 1:
        _assert_same_round(got, plain)


def _refill_rows(out, quota):
    """The emitted rows of a refill round by row id, as host lists."""
    flat, lengths, n_done, _, rows, row_steps = (x.cpu().numpy()
                                                 for x in out)
    got = {}
    for lane in range(flat.shape[0]):
        off = 0
        for j in range(int(n_done[lane])):
            ln = int(lengths[lane, j])
            got[int(rows[lane, j])] = (flat[lane, off:off + ln].tolist(),
                                       int(row_steps[lane, j]))
            off += ln
        assert not flat[lane, off:].any()
        assert (rows[lane, int(n_done[lane]):] == -1).all()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 7, 64, 300])
@pytest.mark.parametrize("name", ["ba1500", "hub", "multi"])
def test_refill_kernel_equals_plain_and_queue(card, name, lanes):
    """refill_bfs: every row below the quota emitted once, each equal to
    the plain version's row and to queue_bfs's lane of its id (its
    lock-step count too), at 1, 7, 64 and 300 lanes (more lanes than rows
    at 300); segmented dedup on the multigraph."""
    g = _multigraph("multi", card) if name == "multi" else \
        _queue_graph(name, card)
    dedup = "segmented" if name == "multi" else "none"
    quota, n = 256, g.n_nodes
    # room for four times a lane's share of the rows, each at most n long
    kw = dict(quota=quota, out_cap=n * min(quota, 4 * -(-quota // lanes) + 8),
              max_sets=quota, ec=128, dedup=dedup)
    ops.reset_launch_counts()
    out = ops.refill_bfs(*_round_args(g), 41, lanes, **kw)
    assert ops.launch_counts()["refill_bfs"] == 1
    assert not bool(out[3].any())
    got = _refill_rows(out, quota)
    want = _refill_rows(ref.refill_round_ref(*_round_args(g), 41, lanes,
                                             **kw)[:6], quota)
    assert got == want and sorted(got) == list(range(quota))
    queue, lengths, _, steps, _ = ops.queue_bfs(
        *_round_args(g), 41, quota, qcap=n, ec=128, dedup=dedup)
    for r, (row, row_steps) in got.items():
        assert row == queue[r, :lengths[r]].tolist()
        assert row_steps == int(steps[r])


@pytest.mark.cuda
def test_refill_kernel_overflow_and_global_visited(card):
    """A small out_cap: a lane that runs out of room sets its flag, emits
    no partial set, and every emitted row still equals its queue lane; and
    the global visited scratch (n past what shared memory holds)."""
    g = _queue_graph("ba1500", card)
    out = ops.refill_bfs(*_round_args(g), 5, 16, quota=200, out_cap=40,
                         max_sets=64, ec=128)
    assert bool(out[3].any())
    got = _refill_rows(out, 200)
    queue, lengths = ops.queue_bfs(*_round_args(g), 5, 200, qcap=1500,
                                   ec=128)[:2]
    for r, (row, _) in got.items():
        assert row == queue[r, :lengths[r]].tolist()
    wide = _queue_graph(f"wide{SHARED_VISITED_NODES + 1}", card)
    out = ops.refill_bfs(*_round_args(wide), 3, 32, quota=64, out_cap=4096,
                         max_sets=64, ec=128)
    got = _refill_rows(out, 64)
    queue, lengths = ops.queue_bfs(*_round_args(wide), 3, 64,
                                   qcap=wide.n_nodes, ec=128)[:2]
    assert sorted(got) == list(range(64))
    for r, (row, _) in got.items():
        assert row == queue[r, :lengths[r]].tolist()


@pytest.mark.cuda
def test_refill_and_mrim_engines_on_card_equal_cpu(card):
    """RefillEngine.sample: one refill_bfs launch and one host read, the
    queue engine's batch row for row and the CPU's steps; MRIMEngine: one
    queue_bfs launch, equal to the CPU; and a refill solve equal to the
    queue solve in every field but the steps."""
    import warnings
    from repro_torch.core.engine import make_engine
    eng = make_engine("refill", csr.reverse(_graph(card)), batch=256)
    eng.sample(1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            batch = eng.sample(2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert ops.launch_counts()["refill_bfs"] == 1
    cpu = make_engine("refill", csr.reverse(_graph("cpu")),
                      batch=256).sample(2)
    queue = make_engine("queue", csr.reverse(_graph(card)),
                        batch=256).sample(2)
    assert torch.equal(batch.nodes.cpu(), cpu.nodes) and \
        batch.steps == cpu.steps
    assert torch.equal(batch.nodes, queue.nodes[:, :batch.nodes.shape[1]])
    assert torch.equal(batch.lengths, queue.lengths)
    dev_batch = eng.sample_device(2)
    width = batch.nodes.shape[1]
    assert torch.equal(dev_batch.nodes[:, :width], batch.nodes)
    assert torch.equal(dev_batch.lengths, batch.lengths)
    ops.reset_launch_counts()
    mrim = make_engine("mrim", csr.reverse(_graph(card)), batch=64,
                       t_rounds=3).sample(4)
    assert ops.launch_counts()["queue_bfs"] == 1
    mcpu = make_engine("mrim", csr.reverse(_graph("cpu")), batch=64,
                       t_rounds=3).sample(4)
    assert torch.equal(mrim.nodes.cpu(), mcpu.nodes)
    assert torch.equal(mrim.roots.cpu(), mcpu.roots)
    fields = []
    for name in ("queue", "refill"):
        res = IMMSolver(_graph(card), engine=name, batch=256, seed=4,
                        device=card).solve(IMProblem(k=8, eps=0.5))
        fields.append((res.seeds.tolist(), res.gains.tolist(),
                       res.stats.theta, res.stats.rounds,
                       res.stats.n_rr_sampled))
    assert fields[0] == fields[1]


@pytest.mark.cuda
def test_refill_wrapper_checks_inputs(card):
    from repro_torch.kernels import refill as trefill
    g = _queue_graph("ba40", card)
    kw = dict(quota=8, out_cap=64, max_sets=4, ec=128)
    with pytest.raises(TypeError):
        trefill.refill_bfs(g.offsets.long(), g.indices, g.weights, 0, 4, **kw)
    with pytest.raises(ValueError, match="CUDA kernel"):
        trefill.refill_bfs(*_round_args(g.to("cpu")), 0, 4, **kw)
    for bad in (dict(out_cap=0), dict(max_sets=0), dict(ec=0),
                dict(quota=-1)):
        with pytest.raises(ValueError):
            trefill.refill_bfs(*_round_args(g), 0, 4, **{**kw, **bad})
    with pytest.raises(ValueError, match="dedup"):
        trefill.refill_bfs(*_round_args(g), 0, 4, **kw, dedup="bogus")
    empty = trefill.refill_bfs(*_round_args(g), 0, 0, **kw)
    assert [tuple(x.shape) for x in empty] == [(0, 64), (0, 4), (0,), (0,),
                                               (0, 4), (0, 4)]
    zero = trefill.refill_bfs(*_round_args(g), 0, 4, **{**kw, "quota": 0})
    assert not bool(zero[2].any()) and not bool(zero[0].any())


# the stacked selection (csrc/greedy.cu greedy_stacked): R requests in one
# launch, each row byte for byte its solo scan

_STACKED_MIXES = {
    "mixed": ("plain50", "plain10", "cand", "budget", "exhausted", "quota",
              "cand_budget", "pad"),
    "plain": ("plain50", "plain10"),
}


def _stacked_kw(n, rows, mix, device):
    """greedy_stacked's row operands for ``rows`` requests that cycle
    through ``mix``: plain k = 50 / 10, candidates (every third node),
    costs 1 + v mod 5 with a budget, two candidates (the row runs out),
    three groups of quota 2, candidates with a budget, and a padding row
    (no step)."""
    v = np.arange(n)
    cols = dict(cand=np.ones((rows, n), bool),
                costs=np.ones((rows, n), np.float32),
                budget=np.full(rows, np.inf, np.float32),
                ks=np.zeros(rows, np.int32), quota=np.zeros(rows, np.int32),
                plain=np.ones(rows, bool), use_costs=np.zeros(rows, bool))
    for r in range(rows):
        kind = mix[r % len(mix)]
        k = {"plain50": 50, "plain10": 10, "cand": 20, "budget": 40,
             "exhausted": 5, "quota": 9, "cand_budget": 30, "pad": 0}[kind]
        cols["ks"][r] = cols["quota"][r] = k
        cols["plain"][r] = kind.startswith("plain") or kind == "pad"
        if kind in ("cand", "cand_budget"):
            cols["cand"][r] = v % 3 == 0
        if kind == "exhausted":
            cols["cand"][r] = np.isin(v, [7, 9])
        if kind in ("budget", "cand_budget"):
            cols["costs"][r] = 1 + v % 5
            cols["budget"][r] = float(k) + 1
            cols["use_costs"][r] = True
        if kind == "quota":
            cols["quota"][r] = 2
    kw = {name: torch.from_numpy(x).to(device) for name, x in cols.items()}
    return dict(kw, n=n, k_max=1 << max(int(cols["ks"].max()) - 1,
                                        0).bit_length(),
                n_group=-(-n // 3), n_groups=3)


def _solo_rows(args, kw, skw):
    """Each row's solo kernel: greedy_flat for a plain row,
    greedy_flat_variant for a variant row, padded to k_max."""
    n, k_max = skw["n"], skw["k_max"]
    rows = []
    for r in range(skw["ks"].shape[0]):
        k = int(skw["ks"][r])
        seeds = torch.full((k_max,), n, dtype=torch.int32)
        gains = torch.zeros(k_max, dtype=torch.int32)
        spent = torch.zeros((), dtype=torch.float32)
        if k and bool(skw["plain"][r]):
            s, g = tgreedy.greedy_flat(*args, **kw, k=k)
        elif k:
            s, g, spent = tgreedy.greedy_flat_variant(
                *args, **kw, k=k, cand=skw["cand"][r].contiguous(),
                costs=skw["costs"][r].contiguous()
                if bool(skw["use_costs"][r]) else None,
                budget=float(skw["budget"][r]), n_group=skw["n_group"],
                n_groups=skw["n_groups"], group_quota=int(skw["quota"][r]))
        if k:
            seeds[:k], gains[:k] = s.cpu(), g.cpu()
        rows.append((seeds, gains, spent.cpu()))
    return [torch.stack(x) for x in zip(*rows)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,mix", [(1, "mixed"), (3, "mixed"),
                                      (8, "mixed"), (16, "plain"),
                                      (16, "mixed")])
@pytest.mark.parametrize("name", ["ragged", "small", "wide", "longrow"])
def test_greedy_stacked_kernel_equals_plain(card, name, rows, mix):
    """R requests in one launch against the plain stacked scan, and every
    row against its solo kernel (greedy_flat or greedy_flat_variant):
    seeds, gains and the float32 bytes of spent."""
    store = _greedy_store(name, card)
    args, kw = _store_args(store)
    skw = _stacked_kw(store.n_nodes, rows, _STACKED_MIXES[mix], card)
    skw.pop("n")
    want = ref.greedy_stacked_ref(*args, **kw, **skw)
    before = ops.launch_counts()["greedy_stacked"]
    got = tgreedy.greedy_stacked(*args, **kw, **skw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["greedy_stacked"] == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (name, rows, mix, x, y)
    solo = _solo_rows(args, kw, dict(skw, n=store.n_nodes))
    for x, y in zip(got, solo):
        assert torch.equal(x.cpu(), y), (name, rows, mix)


@pytest.mark.cuda
def test_greedy_stacked_past_the_shared_layout(card):
    """n = 4,000,000 and 2,000 rows of up to 50 nodes: Occur of 8 rows is
    128 MB of scratch; the kernel still equals its plain version."""
    n = 4_000_000
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 50, 2000)
    nodes = np.full((2000, 50), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    store = cov.DeviceRRStore(n, device=card)
    store.append_batch((torch.tensor(nodes), torch.tensor(lens)))
    args, kw = _store_args(store)
    skw = _stacked_kw(n, 8, _STACKED_MIXES["mixed"], card)
    skw.pop("n")
    got = tgreedy.greedy_stacked(*args, **kw, **skw)
    want = ref.greedy_stacked_ref(*args, **kw, **skw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_greedy_stacked_wrapper_checks_inputs(card):
    store = _greedy_store("small", card)
    args, kw = _store_args(store)
    skw = _stacked_kw(store.n_nodes, 3, _STACKED_MIXES["mixed"], card)
    skw.pop("n")
    for bad in (dict(cand=skw["cand"][:, :-1]),
                dict(cand=skw["cand"].int()),
                dict(costs=skw["costs"].double()),
                dict(budget=skw["budget"].cpu()),
                dict(ks=skw["ks"][:-1]), dict(plain=skw["plain"].int()),
                dict(n_group=1, n_groups=2)):
        with pytest.raises(ValueError):
            tgreedy.greedy_stacked(*args, **kw, **{**skw, **bad})
    with pytest.raises(ValueError, match="CUDA kernel"):
        tgreedy.greedy_stacked(*(a.cpu() for a in args), **kw, **skw)


def _stacked_problems(n, theta):
    """The reference's serving mix: plain, candidates, a budget, plain."""
    cand = np.arange(n) % 3 == 0
    costs = (1 + np.arange(n) % 5).astype(np.float32)
    return [IMProblem(k=5, theta=theta),
            IMProblem(k=3, theta=theta, candidates=np.flatnonzero(cand)),
            IMProblem(k=None, budget=2.5, costs=costs, theta=theta),
            IMProblem(k=4, theta=theta)]


@pytest.mark.cuda
def test_solve_stacked_and_execute_batch_on_card_equal_solo(card):
    """solve_stacked on the card equals the solo solves (one greedy_stacked
    launch for the batch), and equals the same batch on the CPU;
    execute_batch stacks all but the top-1 rider."""
    from repro_torch.serve import execute_batch
    probs = _stacked_problems(1500, 1024)
    solo = IMMSolver(_graph(card), batch=256, seed=0, device=card)
    want = [solo.solve_problem(p) for p in probs]
    stk = IMMSolver(_graph(card), batch=256, seed=0, device=card)
    stk.sample_until(1024)
    ops.reset_launch_counts()
    got = stk.solve_stacked(probs)
    counts = ops.launch_counts()
    assert counts["greedy_stacked"] == 1
    assert counts["greedy_flat"] == counts["greedy_flat_variant"] == 0
    cpu = IMMSolver(_graph("cpu"), batch=256, seed=0,
                    device="cpu").solve_stacked(probs)
    for a, b, c in zip(want, got, cpu):
        for x in (b, c):
            assert np.array_equal(a.seeds, x.seeds)
            assert np.array_equal(a.gains, x.gains)
            assert (a.frac, a.spread, a.cost) == (x.frac, x.spread, x.cost)
    stats = {}
    batch = probs + [IMProblem(k=1, theta=1024)]
    res = execute_batch(IMMSolver(_graph(card), batch=256, seed=0,
                                  device=card), batch, stats_out=stats)
    ref_res = execute_batch(IMMSolver(_graph(card), batch=256, seed=0,
                                      device=card), batch, stacked=False)
    for a, b in zip(ref_res, res):
        assert np.array_equal(a.seeds, b.seeds)
        assert (a.frac, a.spread, a.cost) == (b.frac, b.spread, b.cost)
    assert stats == {"stacked_batches": 1, "stacked_requests": 4}


# ------------------------------------------------ durability and streaming

def _durable_graph(dev, n=3000):
    src, dst = generators.barabasi_albert(n, 4, seed=0)
    return weights.wc_weights(csr.from_edges(src, dst, n, device=dev))


@pytest.mark.cuda
def test_save_and_restore_pool_on_card(card, tmp_path):
    """A checkpoint taken in the middle of a solve on the card restores
    onto the card (never quietly onto the CPU) and finishes equal to the
    uninterrupted solve; the same checkpoint restored on the CPU holds the
    same state."""
    g = _durable_graph(card)
    opts = dict(batch=256, seed=0, sketch_k=256)
    p = IMProblem(k=10, eps=0.5)
    clean = IMMSolver(g, device=card, **opts).solve(p)
    d = str(tmp_path / "ck")
    s1 = IMMSolver(g, device=card, checkpoint_dir=d, checkpoint_every=2,
                   **opts)
    s1.prepare(p)
    s1.sample_until(clean.stats.n_rr_sampled // 2)
    s2 = IMMSolver(g, device=card, **opts)
    s2.restore_pool(d)
    assert s2.store.flat.is_cuda and s2.store.sketch_words().is_cuda
    got = s2.solve(p)
    np.testing.assert_array_equal(got.seeds, clean.seeds)
    np.testing.assert_array_equal(got.gains, clean.gains)
    assert got.frac == clean.frac and got.stats == clean.stats
    host = IMMSolver(g.to("cpu"), device="cpu", **opts)
    host.restore_pool(d)
    s3 = IMMSolver(g, device=card, **opts)
    s3.restore_pool(d)
    for k, v in s3.store.state().items():
        assert v.tobytes() == host.store.state()[k].tobytes(), k


@pytest.mark.cuda
def test_eviction_rebuild_scatter_or_equals_plain(card):
    """The eviction's sketch rebuild (one ``sketch_scatter_or`` launch) on
    the card equals the plain scatter and the CPU eviction of the same
    state, for each of the three evictions."""
    g = _durable_graph(card)
    s = IMMSolver(g, batch=256, seed=0, sketch_k=512, device=card)
    s.solve(IMProblem(k=5, theta=4096))
    state, cfg = s.store.state(), s.store.config()
    dev_store = cov.DeviceRRStore.from_state(state, cfg, device=card)
    cpu_store = cov.DeviceRRStore.from_state(state, cfg, device="cpu")
    aff = np.arange(0, 3000, 97)
    for evict in (lambda st: st.evict_earliest_rounds(3),
                  lambda st: st.evict_to_bytes(
                      st.per_device_pool_bytes() // 2),
                  lambda st: st.evict_rows_containing(aff)):
        before = ops.launch_counts()["sketch_scatter_or"]
        assert evict(dev_store) == evict(cpu_store)
        assert ops.launch_counts()["sketch_scatter_or"] == before + 1
        a, b = dev_store.state(), cpu_store.state()
        for k in b:
            assert a[k].tobytes() == b[k].tobytes(), k
        t = dev_store.n_elems
        words = torch.zeros_like(dev_store.sketch_words())
        v = dev_store.flat[:t]
        bkt = bucket_of(dev_store.ids[:t], dev_store.sketch_k,
                        dev_store.sketch_mode)
        want = ref.sketch_scatter_or_ref(words, v, bkt)
        assert torch.equal(dev_store.sketch_words(), want)


@pytest.mark.cuda
def test_degraded_sweeps_on_card_equal_the_cpu(card, tmp_path):
    """``deadline_s=0`` on a sketch pool: k sweeps (one
    ``sketch_union_popcount`` and one ``popcount_words`` launch each) on
    the card give the CPU run's answer on the same state."""
    g = _durable_graph(card)
    opts = dict(batch=256, seed=0, sketch_k=1024)
    s = IMMSolver(g, device=card, **opts)
    s.solve(IMProblem(k=10, theta=4096))
    d = str(tmp_path / "ck")
    s.save_pool(d)
    host = IMMSolver(g.to("cpu"), device="cpu", **opts)
    host.restore_pool(d)
    before = ops.launch_counts()
    got = s.solve_problem(IMProblem(k=10, theta=4096), deadline_s=0)
    after = ops.launch_counts()
    want = host.solve_problem(IMProblem(k=10, theta=4096), deadline_s=0)
    assert got.degraded and want.degraded
    assert after["sketch_union_popcount"] - \
        before["sketch_union_popcount"] == 10
    assert after["popcount_words"] - before["popcount_words"] == 10
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.gains, want.gains)
    assert got.frac == want.frac and got.spread_bounds == want.spread_bounds


# ------------------------------------------------------------- serving

def _serve(coro):
    import asyncio
    return asyncio.run(asyncio.wait_for(coro, 300))


def _fields(res):
    return (np.asarray(res.seeds).tolist(), np.asarray(res.gains).tolist(),
            np.float32(res.frac).tobytes(), np.float32(res.spread).tobytes(),
            res.cost, res.degraded)


@pytest.mark.cuda
def test_service_batch_on_card_equals_cold_solves(card):
    """A θ-pinned micro-batch through ``IMService`` on the card (one
    stacked scan, the top-1 rider on the Occur fast path) equals cold
    solves on the card, field for field."""
    import asyncio
    from repro_torch.serve import ServeConfig, build_service
    g = _durable_graph(card)
    probs = _stacked_problems(3000, 1024) + [IMProblem(k=1, theta=1024)]
    opts = {"batch": 256, "seed": 0, "device": "cuda"}

    async def go():
        svc = build_service({"g": g}, ServeConfig(
            max_batch=16, batch_window_s=0.05, solver_opts=opts))
        async with svc:
            got = await asyncio.gather(*(svc.submit("g", p) for p in probs))
        return got, svc.stats()
    ops.reset_launch_counts()
    got, st = _serve(go())
    counts = ops.launch_counts()
    assert counts["greedy_stacked"] >= 1 and counts["queue_bfs"] >= 1
    assert st.stacked_batches >= 1 and st.occur_fastpath >= 1
    for p, r in zip(probs, got):
        cold = IMMSolver(g, batch=256, seed=0, device=card).solve_problem(p)
        assert _fields(r.result) == _fields(cold)
        assert isinstance(r.result.seeds, np.ndarray)


@pytest.mark.cuda
def test_two_cluster_workers_on_card_equal_one_worker(card):
    """Two cluster workers solving at once on the one card (their solvers
    share the device and its default stream) give the answers of a
    single worker."""
    import asyncio
    from repro_torch.serve import IMCluster, ServeConfig
    g = _durable_graph(card)
    thetas = list(range(1024, 1036))
    cfg = ServeConfig(max_batch=8,
                      solver_opts={"batch": 256, "seed": 0, "device": "cuda"})

    async def go(workers):
        cl = IMCluster({"g": g}, cfg, workers=workers)
        await cl.start()
        try:
            got = await asyncio.gather(*(
                cl.submit("g", IMProblem(k=5, theta=t)) for t in thetas))
            owners = {cl.ring.owner(cl.route_key("g", IMProblem(
                k=5, theta=t))) for t in thetas}
        finally:
            await cl.stop()
        return [_fields(r.result) for r in got], owners
    two, owners = _serve(go(2))
    one, _ = _serve(go(1))
    assert owners == {0, 1}
    assert two == one


@pytest.mark.cuda
def test_card_registry_rehydrates_a_cpu_spill(card, tmp_path):
    """A registry on the card rehydrates the spill that a CPU registry
    wrote, onto the card, with no sampling, and answers bit for bit."""
    from repro_torch.serve import WarmSolverRegistry
    p = IMProblem(k=5, theta=2048)
    host = WarmSolverRegistry(solver_opts={"batch": 256, "seed": 0,
                                           "device": "cpu"},
                              spill_dir=str(tmp_path))
    host.add_graph("g", _durable_graph("cpu"))
    e = host.get("g", p)
    want = e.solver.solve(p)
    host.account(e)
    host.evict(host.solver_key("g", p))
    reg = WarmSolverRegistry(solver_opts={"batch": 256, "seed": 0,
                                          "device": "cuda"},
                             spill_dir=str(tmp_path))
    reg.add_graph("g", _durable_graph(card))
    entry = reg.get("g", p)
    assert reg.snapshot().rehydrations == 1
    assert entry.solver.store.flat.is_cuda
    before = ops.launch_counts()["queue_bfs"]
    got = entry.solver.solve(p)
    assert ops.launch_counts()["queue_bfs"] == before
    assert _fields(got) == _fields(want)


def _shard_pool(rows, n, seed):
    """A flat pool of ``rows`` RR sets of up to 40 distinct nodes, rows
    contiguous (``build_store``'s layout), on the CPU."""
    rng = np.random.default_rng(seed)
    lists = [rng.choice(n, size=int(rng.integers(0, min(n, 40) + 1)),
                        replace=False).tolist() for _ in range(rows)]
    st = cov.build_store(lists, n, device="cpu")
    return st.rr_flat, st.rr_ids, st.valid


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (97, 64), (5000, 3000),
                                    (20000, 75879)])
def test_occur_flat_kernel_equals_plain(card, rows, n):
    flat, _, valid = _shard_pool(rows, n, rows)
    valid = valid & torch.from_numpy(RNG.random(valid.shape[0]) < 0.9)
    got = ops.occur_flat(flat.to(card), valid.to(card), n=n)
    assert torch.equal(got.cpu(), ref.occur_flat_ref(flat, valid, n=n))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (97, 64), (5000, 3000),
                                    (20000, 75879)])
def test_shard_flat_step_kernel_equals_plain_over_a_selection(card, rows, n):
    """Eight seed steps of the sharded scan on one shard: the decrement,
    the gain slot and the Covered words of every step equal the plain
    version's, with no host read of the seed."""
    flat, ids, valid = _shard_pool(rows, n, rows + 1)
    num_rows = max(32, 1 << max(rows - 1, 0).bit_length())
    occur = ref.occur_flat_ref(flat, valid, n=n)
    cov_cpu = torch.zeros(num_rows // 32, dtype=torch.int32)
    cov_gpu = cov_cpu.to(card)
    args = tuple(t.to(card) for t in (flat, ids, valid))
    for _ in range(8):
        u = torch.argmax(occur)
        want = ref.shard_flat_step_ref(flat, ids, valid, cov_cpu, u.view(1),
                                       n=n)
        got = ops.shard_flat_step(*args, cov_gpu, u.view(1).to(card), n=n)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(cov_gpu.cpu(), cov_cpu)
        occur -= want[:n]


@pytest.mark.cuda
def test_shard_wrappers_check_inputs(card):
    flat, ids, valid = (t.to(card) for t in _shard_pool(10, 20, 3))
    cov_words = torch.zeros(1, dtype=torch.int32, device=card)
    u = torch.zeros(1, dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        ops.occur_flat(flat.to(torch.int64), valid, n=20)
    with pytest.raises(ValueError):
        ops.shard_flat_step(flat, ids, valid, cov_words, u.cpu(), n=20)
    with pytest.raises(ValueError):
        ops.shard_flat_step(flat, ids, valid, cov_words,
                            u.to(torch.int32), n=20)
    with pytest.raises(ValueError):
        ops.shard_flat_step(flat, ids[:-1], valid, cov_words, u, n=20)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,b", [(2, 256), (8, 64)])
def test_queue_bfs_row0_block_is_the_rounds_rows(card, ranks, b):
    g = csr.coalesce_ic(csr.reverse(_graph(card)))
    seed32 = round_seed(0, 1)
    whole = ops.queue_bfs(g.offsets, g.indices, g.weights, seed32,
                          ranks * b, qcap=g.n_nodes, ec=128)
    for d in range(ranks):
        block = ops.queue_bfs(g.offsets, g.indices, g.weights, seed32, b,
                              qcap=g.n_nodes, ec=128, row0=d * b)
        for got, want in zip(block, whole):
            assert torch.equal(got, want[d * b:(d + 1) * b])


@pytest.mark.cuda
def test_one_rank_mesh_solve_on_card_equals_no_mesh(card, tmp_path):
    """A one-rank gloo mesh on the card: the sharded protocol's flat,
    bitset and CELF solves equal the solve without a mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sample_mesh
    g = _graph(card)
    p = IMProblem(k=8, eps=0.5)
    want = IMMSolver(g, batch=256, seed=0, device=card).solve(p)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        mesh = make_sample_mesh(device=card)
        for sel in ("fused", "bitset", "celf"):
            ops.reset_launch_counts()
            got = IMMSolver(g, batch=256, seed=0, selection=sel,
                            mesh=mesh).solve(p)
            assert got.seeds.tolist() == want.seeds.tolist(), sel
            assert got.gains.tolist() == want.gains.tolist(), sel
            assert got.frac == want.frac and got.spread == want.spread
            if sel == "fused":
                counts = ops.launch_counts()
                assert counts["occur_flat"] and counts["shard_flat_step"]
                assert counts["greedy_flat"] == 0
    finally:
        dist.destroy_process_group()
