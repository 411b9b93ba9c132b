"""CUDA wrappers of the bit-set kernels: the Occur histograms
(``csrc/occur.cu``) and the dense sampler's bit operations
(``csrc/bitops.cu``).

``occur_from_bitset``, ``occur_from_bitset_masked``, ``pack_bits``,
``bitset_or``, ``bitset_andnot`` and ``popcount_words`` replace the Pallas
kernels of the same names in ``repro.kernels.bitset``.  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to ``ref.py``.
Each wrapper checks its inputs, allocates its output, launches on
PyTorch's current stream of the tensor's card, raises on a launch error
and adds one to its entry in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"occur_from_bitset": 0, "occur_from_bitset_masked": 0,
            "pack_bits": 0, "bitset_or": 0, "bitset_andnot": 0,
            "popcount_words": 0}

_THREADS = 128          # threads per block (kThreads in occur.cu)
_TARGET_BLOCKS = 2112   # 16 blocks of 128 threads on each of 132 SMs
_MAX_GRID_Y = 65535

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("occur")
    lib.occur_from_bitset.argtypes = [_vp, _i64, _i64, _i64, _vp, _vp]
    lib.occur_from_bitset.restype = ctypes.c_int
    lib.occur_from_bitset_masked.argtypes = [_vp, _vp, _i64, _i64, _i64,
                                             _vp, _vp]
    lib.occur_from_bitset_masked.restype = ctypes.c_int
    return lib


@functools.cache
def _bitops() -> ctypes.CDLL:
    lib = _build.load("bitops")
    lib.pack_bits.argtypes = [_vp, _i64, _i64, _vp, _vp]
    for name in ("bitset_or", "bitset_andnot"):
        getattr(lib, name).argtypes = [_vp, _vp, _i64, _vp, _vp]
    lib.popcount_words.argtypes = [_vp, _i64, _vp, _vp]
    for name in ("pack_bits", "bitset_or", "bitset_andnot", "popcount_words"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def rows_per_chunk(rows: int, cols: int) -> int:
    """Rows each thread walks: enough chunks to fill the card, and never
    more than the grid's y limit."""
    blocks_x = -(-cols // _THREADS)
    chunks = max(1, min(_TARGET_BLOCKS // max(blocks_x, 1), rows))
    per = -(-rows // chunks)
    return max(per, -(-rows // _MAX_GRID_Y), 1)


def occur_from_bitset(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words on the card -> (W*32,) int32 Occur."""
    _build.check_words(words)
    b, w = words.shape
    occur = torch.zeros(w * 32, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = _lib().occur_from_bitset(
            words.data_ptr(), b, w, rows_per_chunk(b, w), occur.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "occur_from_bitset")
    LAUNCHES["occur_from_bitset"] += 1
    return occur


def occur_from_bitset_masked(words: torch.Tensor,
                             rowmask: torch.Tensor) -> torch.Tensor:
    """Occur over the rows with ``rowmask[r] != 0``; rowmask is (B,) int32
    or bool on the same card."""
    _build.check_words(words)
    b, w = words.shape
    if rowmask.device != words.device:
        raise ValueError("rowmask must lie on the words' device")
    if rowmask.dtype == torch.bool:
        rowmask = rowmask.to(torch.int32)
    if rowmask.dtype != torch.int32 or rowmask.shape != (b,):
        raise TypeError(f"rowmask must be ({b},) int32 or bool, got "
                        f"{tuple(rowmask.shape)} {rowmask.dtype}")
    rowmask = rowmask.contiguous()
    occur = torch.zeros(w * 32, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = _lib().occur_from_bitset_masked(
            words.data_ptr(), rowmask.data_ptr(), b, w, rows_per_chunk(b, w),
            occur.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "occur_from_bitset_masked")
    LAUNCHES["occur_from_bitset_masked"] += 1
    return occur


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) bool on the card, n % 32 == 0 -> (B, n/32) int32 words, LSB
    first (bit j of word w is ``bits[:, w*32 + j]``)."""
    if bits.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {bits.device}")
    if bits.dtype != torch.bool:
        raise TypeError(f"bits must be bool, got {bits.dtype}")
    if bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(f"bits must be a contiguous 2-D tensor, got "
                         f"{tuple(bits.shape)}")
    b, n = bits.shape
    if n % 32:
        raise ValueError("n must be a multiple of 32 (pad first)")
    words = torch.empty(b, n // 32, dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device):
        err = _bitops().pack_bits(bits.data_ptr(), b, n, words.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "pack_bits")
    LAUNCHES["pack_bits"] += 1
    return words


def _binary(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _build.check_words(a, "a")
    _build.check_words(b, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"{name} wants two word matrices of one shape on "
                         f"one card, got {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = getattr(_bitops(), name)(
            a.data_ptr(), b.data_ptr(), a.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def bitset_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a | b`` on (B, W) int32 words on the card."""
    return _binary("bitset_or", a, b)


def bitset_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & ~b`` on (B, W) int32 words on the card."""
    return _binary("bitset_andnot", a, b)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount: (B, W) int32 words on the card -> (B, W) int32."""
    _build.check_words(words)
    out = torch.empty_like(words)
    with torch.cuda.device(words.device):
        err = _bitops().popcount_words(
            words.data_ptr(), words.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "popcount_words")
    LAUNCHES["popcount_words"] += 1
    return out
