"""The Occur kernels' bit-plane counting (``csrc/occur.cu``), emulated on
the CPU, against the plain versions and the JAX reference.

``emulate_occur`` repeats the kernel's arithmetic in numpy on uint32 words:
the same chunks of ``rows_per_chunk`` rows, the same 16-row Harley-Seal
tree of carry-save adders into the planes of weight 1, 2, 4 and 8, the
same ripple of its carry into planes 4 .. 15, the masked form's
compaction of 256-row windows into 16-row groups padded with zero words,
and the readout of L = ``occur_planes(rows_per_chunk)`` planes.  The
kernel itself runs only on a card (``tests/test_torch_cuda.py``); this
file holds its counting scheme.  Every comparison is exact.  The
reference's Pallas kernels run in interpret mode on the CPU, called
directly, outside ``shard_map``.

The same file checks the pad-and-slice arithmetic that
``ops.flash_attention`` uses on a card for a head dim the kernel lacks.
"""
import math
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import bitset as tbitset
from repro_torch.kernels import flashattn as tflash
from repro_torch.kernels import ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

RNG = np.random.default_rng(16)
OCCUR_CU = (Path(tbitset.__file__).resolve().parent / "csrc" / "occur.cu")
GROUP = 16          # kGroup
LOW_PLANES = 4      # kLowPlanes
MAX_PLANES = 16     # kMaxPlanes
WINDOW = 256        # kWindow


def _words(b, w, ones=False):
    """(b, w) uint32 words: all ones, or random with bit 31 set in about
    half of them."""
    if ones:
        return np.full((b, w), 0xFFFFFFFF, np.uint32)
    return RNG.integers(0, 1 << 32, size=(b, w), dtype=np.int64).astype(
        np.uint32)


def _t(x):
    return torch.tensor(x.view(np.int32))


def _csa(a, b, c):
    """(carry, sum) of three uint32 word vectors, bit by bit."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def _add_group(x, p):
    """The kernel's add_group: 16 words (rows of x) into the planes p."""
    twos_a, p[0] = _csa(p[0], x[0], x[1])
    twos_b, p[0] = _csa(p[0], x[2], x[3])
    fours_a, p[1] = _csa(p[1], twos_a, twos_b)
    twos_a, p[0] = _csa(p[0], x[4], x[5])
    twos_b, p[0] = _csa(p[0], x[6], x[7])
    fours_b, p[1] = _csa(p[1], twos_a, twos_b)
    eights_a, p[2] = _csa(p[2], fours_a, fours_b)
    twos_a, p[0] = _csa(p[0], x[8], x[9])
    twos_b, p[0] = _csa(p[0], x[10], x[11])
    fours_a, p[1] = _csa(p[1], twos_a, twos_b)
    twos_a, p[0] = _csa(p[0], x[12], x[13])
    twos_b, p[0] = _csa(p[0], x[14], x[15])
    fours_b, p[1] = _csa(p[1], twos_a, twos_b)
    eights_b, p[2] = _csa(p[2], fours_a, fours_b)
    carry, p[3] = _csa(p[3], eights_a, eights_b)
    for k in range(LOW_PLANES, MAX_PLANES):
        carry, p[k] = p[k] & carry, p[k] ^ carry
    assert not carry.any(), "a count outgrew the planes"


def _readout(p, planes):
    """(W, 32) counts from the first ``planes`` planes."""
    b = np.arange(32, dtype=np.uint32)
    counts = np.zeros((p.shape[1], 32), np.int64)
    for k in range(planes):
        counts += (((p[k][:, None] >> b) & 1) << k).astype(np.int64)
    return counts


def _groups(r0, r1, mask):
    """The row groups of one chunk, as the kernel forms them."""
    if mask is None:
        return [np.arange(g, min(g + GROUP, r1)) for g in range(r0, r1, GROUP)]
    out = []
    for win in range(r0, r1, WINDOW):
        rows = np.arange(win, min(win + WINDOW, r1))
        sel = rows[mask[rows] != 0]
        out += [sel[g:g + GROUP] for g in range(0, len(sel), GROUP)]
    return out


def emulate_occur(words, mask=None, per=None):
    """occur.cu's counting of (B, W) uint32 words (over the rows with
    ``mask != 0`` when a mask is given) -> (W*32,) int32; also returns the
    largest count a chunk reached and the top plane it set."""
    b, w = words.shape
    per = tbitset.rows_per_chunk(b, w) if per is None else per
    planes = tbitset.occur_planes(per)
    occur = np.zeros((w, 32), np.int64)
    top, peak = 0, 0
    for r0 in range(0, b, per):
        p = np.zeros((MAX_PLANES, w), np.uint32)
        for rows in _groups(r0, min(r0 + per, b), mask):
            x = np.zeros((GROUP, w), np.uint32)
            x[:len(rows)] = words[rows]
            _add_group(x, p)
        assert not p[planes:].any(), "a count reached past the L planes"
        used = [k for k in range(MAX_PLANES) if p[k].any()]
        top = max(top, used[-1] if used else 0)
        counts = _readout(p, planes)
        peak = max(peak, int(counts.max()))
        occur += counts
    return occur.reshape(-1).astype(np.int32), peak, top


def test_emulation_uses_the_kernels_constants():
    src = OCCUR_CU.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kGroup"]) == GROUP == tbitset._GROUP
    assert int(consts["kLowPlanes"]) == LOW_PLANES
    assert int(consts["kMaxPlanes"]) == MAX_PLANES == tbitset._MAX_PLANES
    assert int(consts["kWindow"]) == WINDOW
    assert int(consts["kThreads"]) == tbitset._THREADS


@pytest.mark.parametrize("b", [1, 15, 16, 17, 33, 100, 300])
@pytest.mark.parametrize("w", [1, 3])
def test_emulated_occur_equals_plain_and_reference(b, w):
    x = _words(b, w)
    assert (x >> 31).any()
    got, _, _ = emulate_occur(x)
    want = tref.occur_from_bitset_ref(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jops.occur_from_bitset(jnp.asarray(x))))


@pytest.mark.parametrize("per", [1, 15, 16, 17, 48, 512])
def test_emulated_occur_at_chunk_boundaries(per):
    """Chunks of any size: rows not a multiple of the group or of the
    chunk, several chunks a column."""
    x = _words(1100, 2)
    got, _, _ = emulate_occur(x, per=per)
    np.testing.assert_array_equal(got,
                                  tref.occur_from_bitset_ref(_t(x)).numpy())


@pytest.mark.parametrize("b,per", [(1, None), (16, None), (17, None),
                                   (1000, None), (1024, 512), (100, 48),
                                   (47, 47)])
def test_all_ones_fill_the_top_plane(b, per):
    """All-ones rows: every count of a full chunk is rows_per_chunk, so
    the top plane L - 1 is set and nothing lands past it."""
    x = _words(b, 2, ones=True)
    got, peak, top = emulate_occur(x, per=per)
    per = tbitset.rows_per_chunk(b, 2) if per is None else per
    assert peak == min(per, b)
    assert top == min(per, b).bit_length() - 1
    if b >= per:
        assert top == tbitset.occur_planes(per) - 1
    np.testing.assert_array_equal(got, np.full(64, b, np.int32))
    np.testing.assert_array_equal(got,
                                  tref.occur_from_bitset_ref(_t(x)).numpy())


def _masks(b):
    sparse = np.zeros(b, np.int32)
    sparse[RNG.choice(b, size=max(1, b // 7), replace=False)] = 1
    return {"none": np.zeros(b, np.int32), "all": np.ones(b, np.int32),
            "sparse": sparse,
            "half": RNG.integers(0, 2, size=b).astype(np.int32)}


@pytest.mark.parametrize("kind", ["none", "all", "sparse", "half"])
@pytest.mark.parametrize("dtype", ["int32", "bool"])
@pytest.mark.parametrize("b,per", [(1, None), (17, None), (300, None),
                                   (700, 512), (1100, 48)])
def test_emulated_masked_occur_equals_plain_and_reference(b, per, dtype,
                                                          kind):
    """Masks all-false, all-true, sparse and half, in bool and int32; at
    700 and 1100 rows a chunk spans several of the kernel's 256-row
    compaction windows."""
    x = _words(b, 3)
    mask = _masks(b)[kind]
    m = mask.astype(dtype)
    got, _, _ = emulate_occur(x, m, per=per)
    want = tref.occur_from_bitset_masked_ref(_t(x), torch.tensor(m)).numpy()
    np.testing.assert_array_equal(got, want)
    if b <= 300:
        np.testing.assert_array_equal(got, np.asarray(
            jops.occur_from_bitset_masked(jnp.asarray(x), jnp.asarray(mask))))


def test_masked_all_ones_selected_rows_fill_the_top_plane():
    b = 1100
    x = _words(b, 2, ones=True)
    mask = np.zeros(b, bool)
    mask[:600] = True          # 600 selected rows in the first chunk of 1024
    got, peak, top = emulate_occur(x, mask, per=1024)
    assert peak == 600 and top == 600 .bit_length() - 1
    np.testing.assert_array_equal(got, np.full(64, 600, np.int32))


@pytest.mark.parametrize("rows,cols", [
    (0, 1), (1, 1), (15, 1), (16, 2372), (17, 2372), (16384, 2372),
    (131072, 2372), (65535 * 512, 1), (65535 * 512 + 1, 1), (10 ** 7, 1),
    (5, 10 ** 5), (65535 * 65520, 1)])
def test_rows_per_chunk_and_planes_at_the_grid_limits(rows, cols):
    """A multiple of the group, at most the rows (rounded up to a group),
    chunks within the grid's y limit, and 2^L > rows_per_chunk with L
    within the kernel's planes."""
    per = tbitset.rows_per_chunk(rows, cols)
    planes = tbitset.occur_planes(per)
    assert per >= 1 and per % GROUP == 0
    assert per <= max(16, -(-rows // GROUP) * GROUP)
    assert -(-rows // per) <= 65535
    assert 2 ** planes > per >= 2 ** (planes - 1)
    assert planes <= MAX_PLANES


@pytest.mark.parametrize("rows,per,blocks", [(16384, 512, 608),
                                             (131072, 592, 4218)])
def test_rows_per_chunk_fills_the_card_at_the_paths_shapes(rows, per,
                                                           blocks):
    """At the exact path's bit matrix and the larger random one: chunks of
    at least _MIN_CHUNK rows, at least 4 blocks for each of 132 SMs, at
    most _TARGET_BLOCKS (rounded up by a chunk's blocks)."""
    assert tbitset.rows_per_chunk(rows, 2372) == per
    assert -(-2372 // tbitset._THREADS) * -(-rows // per) == blocks
    assert 4 * 132 <= blocks <= tbitset._TARGET_BLOCKS + 19
    assert per >= tbitset._MIN_CHUNK


def test_rows_per_chunk_refuses_what_the_planes_cannot_hold():
    with pytest.raises(ValueError, match="bit planes"):
        tbitset.rows_per_chunk(65535 * 65536, 1)
    assert [tbitset.occur_planes(n) for n in (1, 15, 16, 17, 65535)] == \
        [1, 4, 5, 5, 16]


@pytest.mark.parametrize("d,width", [(32, 64), (80, 128), (1, 8), (9, 16),
                                     (200, 256)])
def test_padded_head_dim(d, width):
    assert tflash.padded_head_dim(d) == width
    assert tflash.padded_head_dim(width) == width


def test_padded_head_dim_names_the_limit():
    """Past the one-pass kernels' limit of 256 (``MAX_SINGLE_PASS``), D
    rounds up to a multiple of the column-split kernel's 64-column chunk;
    a D below 1 raises."""
    assert tflash.MAX_SINGLE_PASS == 256 and tflash.SPLIT_CHUNK == 64
    assert [tflash.padded_head_dim(d) for d in (256, 257, 320, 321, 512,
                                                1000)] == \
        [256, 320, 320, 384, 512, 1024]
    with pytest.raises(ValueError, match="at least 1"):
        tflash.padded_head_dim(0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [32, 80])
def test_flash_pad_and_slice_equals_the_true_head_dim(d, causal):
    """Zero columns add nothing to q . k and give zero output columns: the
    plain version at the padded D, with q scaled by sqrt(D_pad / D) so that
    its 1/sqrt(D_pad) becomes the true 1/sqrt(D), then sliced to D, equals
    the plain version at D."""
    width = tflash.padded_head_dim(d)
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.standard_normal((2, 48, 3, d)),
                            dtype=torch.float32) for _ in range(3))
    pad = [torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v)]
    pad[0] = pad[0] * math.sqrt(width / d)
    got = tref.flash_attention_ref(*pad, causal)
    assert got.shape == (2, 48, 3, width)
    assert not got[..., d:].any()
    torch.testing.assert_close(got[..., :d],
                               tref.flash_attention_ref(q, k, v, causal),
                               atol=2e-6, rtol=1e-5)
