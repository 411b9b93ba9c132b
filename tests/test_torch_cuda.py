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

from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.core.rrset import sample_rrsets_queue, to_lists
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import bitset as tbitset, ops, ref

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
    assert all(v > 0 for v in ops.launch_counts().values())
    np.testing.assert_array_equal(gpu.seeds, cpu.seeds)
    np.testing.assert_array_equal(gpu.gains, cpu.gains)
    assert gpu.frac == cpu.frac and gpu.stats.theta == cpu.stats.theta
