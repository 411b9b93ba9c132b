"""CUDA wrappers of the bit-set kernels: the Occur histograms
(``csrc/occur.cu``) and the dense sampler's bit operations
(``csrc/bitops.cu``).

``occur_from_bitset``, ``occur_from_bitset_masked``, ``pack_bits``,
``bitset_or``, ``bitset_andnot`` and ``popcount_words`` replace the Pallas
kernels of the same names in ``repro.kernels.bitset``;
``frontier_update`` is the dense level's ``bitset_andnot`` and
``bitset_or`` in one launch.  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to ``ref.py``.

A wrapper checks all its inputs in one pass over the common case (the
detailed messages come from a second pass that runs only when the first
fails), allocates its output with one ``empty``, and calls its C entry
point through a :class:`_build.Kernel` with the card's index and the raw
handle of PyTorch's current stream of that card
(:func:`_build.raw_stream`); the entry point makes the card current only
when it is not.  The Occur entry points zero their output on that stream
themselves.  A wrapper raises on a launch error and adds one to its entry
in :data:`LAUNCHES`.

The Occur histograms split the rows into chunks of :func:`rows_per_chunk`
rows and count each chunk in :func:`occur_planes` bit planes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"occur_from_bitset": 0, "occur_from_bitset_masked": 0,
            "pack_bits": 0, "bitset_or": 0, "bitset_andnot": 0,
            "popcount_words": 0, "frontier_update": 0}

_THREADS = 128          # word columns a block (kThreads in occur.cu)
_GROUP = 16             # rows a carry-save tree adds (kGroup)
_MAX_PLANES = 16        # bit planes a thread holds (kMaxPlanes)
_TARGET_BLOCKS = 4224   # 32 blocks of 128 threads for each of 132 SMs
#                         (about 3 waves: at 1 wave the last blocks run alone)
_MIN_CHUNK = 512        # rows: the readout's 32 x L extractions a column
#                         cost under 2 instructions a word read
_MAX_CHUNK = (1 << _MAX_PLANES) - _GROUP   # the most rows the planes hold
_MAX_GRID_Y = 65535
_MASK_BYTES = {torch.bool: 1, torch.int32: 4}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_OCCUR = _build.Kernel("occur", "occur_from_bitset",
                       (_vp, _i64, _i64, _i64, _int, _vp, _int, _vp))
_OCCUR_MASKED = _build.Kernel(
    "occur", "occur_from_bitset_masked",
    (_vp, _vp, _int, _i64, _i64, _i64, _int, _vp, _int, _vp))
_PACK = _build.Kernel("bitops", "pack_bits", (_vp, _i64, _i64, _vp, _int, _vp))
_BINARY = {name: _build.Kernel("bitops", name,
                               (_vp, _vp, _i64, _vp, _int, _vp))
           for name in ("bitset_or", "bitset_andnot")}
_FRONTIER = _build.Kernel("bitops", "frontier_update",
                          (_vp, _vp, _i64, _vp, _int, _vp))
_POPCOUNT = _build.Kernel("bitops", "popcount_words",
                          (_vp, _i64, _vp, _int, _vp))


def rows_per_chunk(rows: int, cols: int) -> int:
    """Rows each thread of the Occur kernels walks: enough chunks for about
    :data:`_TARGET_BLOCKS` blocks, at least :data:`_MIN_CHUNK` rows (or all
    of them, rounded up to a group) and at most :data:`_MAX_CHUNK` unless
    the grid's y limit needs more, a multiple of the 16-row group.  Raises
    when the chunks that the grid allows outgrow the bit planes."""
    blocks_x = -(-cols // _THREADS)
    chunks = max(1, _TARGET_BLOCKS // max(blocks_x, 1))
    per = min(max(-(-rows // chunks), _MIN_CHUNK), _MAX_CHUNK)
    per = max(per, -(-rows // _MAX_GRID_Y))
    per = min(-(-per // _GROUP), -(-max(rows, 1) // _GROUP)) * _GROUP
    if occur_planes(per) > _MAX_PLANES:
        raise ValueError(f"{rows} rows need chunks of {per} rows, more than "
                         f"{_MAX_PLANES} bit planes hold")
    return per


def occur_planes(rows_per_chunk: int) -> int:
    """Bit planes L that hold a chunk's counts: the least L with
    ``2**L > rows_per_chunk``."""
    return int(rows_per_chunk).bit_length()


@functools.lru_cache(maxsize=64)
def _split(rows: int, cols: int) -> tuple[int, int]:
    per = rows_per_chunk(rows, cols)
    return per, occur_planes(per)


def _card(words: torch.Tensor, other: torch.Tensor | None = None,
          op: str = "") -> int:
    """The index of the card that holds ``words``, a contiguous 2-D int32
    matrix, and ``other`` (if given), one of the same shape on the same
    card.  Raises what ``_build.check_words`` and the shape check raise."""
    if (words.is_cuda and words.dtype == torch.int32 and words.dim() == 2
            and words.is_contiguous()):
        dev = words.get_device()
        if other is None or (other.is_cuda and other.dtype == torch.int32
                             and other.is_contiguous()
                             and other.shape == words.shape
                             and other.get_device() == dev):
            return dev
    if other is None:
        _build.check_words(words)
        raise AssertionError("unreachable: check_words raised")
    _build.check_words(words, "a")
    _build.check_words(other, "b")
    raise ValueError(f"{op} wants two word matrices of one shape on one "
                     f"card, got {tuple(words.shape)} on {words.device} and "
                     f"{tuple(other.shape)} on {other.device}")


def occur_from_bitset(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words on the card -> (W*32,) int32 Occur."""
    dev = _card(words)
    b, w = words.shape
    per, planes = _split(b, w)
    occur = words.new_empty(w * 32)
    err = _OCCUR(words.data_ptr(), b, w, per, planes, occur.data_ptr(), dev,
                 _build.raw_stream(dev))
    _build.raise_on(err, "occur_from_bitset")
    LAUNCHES["occur_from_bitset"] += 1
    return occur


def occur_from_bitset_masked(words: torch.Tensor,
                             rowmask: torch.Tensor) -> torch.Tensor:
    """Occur over the rows with ``rowmask[r] != 0``; rowmask is (B,) int32
    or bool on the same card (a bool mask is read as bytes)."""
    dev = _card(words)
    b, w = words.shape
    if not (rowmask.is_cuda and rowmask.get_device() == dev
            and rowmask.dtype in _MASK_BYTES and rowmask.shape == (b,)):
        if rowmask.device != words.device:
            raise ValueError("rowmask must lie on the words' device")
        raise TypeError(f"rowmask must be ({b},) int32 or bool, got "
                        f"{tuple(rowmask.shape)} {rowmask.dtype}")
    if not rowmask.is_contiguous():
        rowmask = rowmask.contiguous()
    per, planes = _split(b, w)
    occur = words.new_empty(w * 32)
    err = _OCCUR_MASKED(words.data_ptr(), rowmask.data_ptr(),
                        _MASK_BYTES[rowmask.dtype], b, w, per, planes,
                        occur.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, "occur_from_bitset_masked")
    LAUNCHES["occur_from_bitset_masked"] += 1
    return occur


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) bool on the card, n % 32 == 0 -> (B, n/32) int32 words, LSB
    first (bit j of word w is ``bits[:, w*32 + j]``)."""
    if not (bits.is_cuda and bits.dtype == torch.bool and bits.dim() == 2
            and bits.is_contiguous()):
        if bits.device.type != "cuda":
            raise ValueError(f"CUDA kernel given a tensor on {bits.device}")
        if bits.dtype != torch.bool:
            raise TypeError(f"bits must be bool, got {bits.dtype}")
        raise ValueError(f"bits must be a contiguous 2-D tensor, got "
                         f"{tuple(bits.shape)}")
    b, n = bits.shape
    if n % 32:
        raise ValueError("n must be a multiple of 32 (pad first)")
    dev = bits.get_device()
    words = bits.new_empty((b, n // 32), dtype=torch.int32)
    err = _PACK(bits.data_ptr(), b, n, words.data_ptr(), dev,
                _build.raw_stream(dev))
    _build.raise_on(err, "pack_bits")
    LAUNCHES["pack_bits"] += 1
    return words


def _binary(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dev = _card(a, b, name)
    out = torch.empty_like(a)
    err = _BINARY[name](a.data_ptr(), b.data_ptr(), a.numel(),
                        out.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def bitset_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a | b`` on (B, W) int32 words on the card."""
    return _binary("bitset_or", a, b)


def bitset_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & ~b`` on (B, W) int32 words on the card."""
    return _binary("bitset_andnot", a, b)


def frontier_update(a: torch.Tensor, visited: torch.Tensor) -> torch.Tensor:
    """``a & ~visited``, and ``visited |= a`` in place, on (B, W) int32
    words on the card: one launch for ``bitset_andnot`` and ``bitset_or``
    (``visited`` ends as ``visited | (a & ~visited)``)."""
    dev = _card(a, visited, "frontier_update")
    out = torch.empty_like(a)
    err = _FRONTIER(a.data_ptr(), visited.data_ptr(), a.numel(),
                    out.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, "frontier_update")
    LAUNCHES["frontier_update"] += 1
    return out


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount: (B, W) int32 words on the card -> (B, W) int32."""
    dev = _card(words)
    out = torch.empty_like(words)
    err = _POPCOUNT(words.data_ptr(), words.numel(), out.data_ptr(), dev,
                    _build.raw_stream(dev))
    _build.raise_on(err, "popcount_words")
    LAUNCHES["popcount_words"] += 1
    return out
