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
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.core.rrset import sample_rrsets_queue, to_lists
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import bitset as tbitset, ops, ref
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
    assert counts["sketch_scatter_or"] > 0
    assert counts["sketch_union_popcount"] > 0
    np.testing.assert_array_equal(approx.seeds, bit.seeds)
    np.testing.assert_array_equal(approx.gains, bit.gains)
    assert approx.frac == bit.frac
    lo, hi = approx.spread_bounds
    assert lo == hi == pytest.approx(approx.spread, rel=1e-6)
