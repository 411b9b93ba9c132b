"""CUDA wrappers of the Occur kernels (``csrc/occur.cu``).

``occur_from_bitset`` and ``occur_from_bitset_masked`` replace the Pallas
kernels of the same names in ``repro.kernels.bitset``.  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to ``ref.py``.
Each wrapper checks its inputs, allocates the zeroed output, launches on
PyTorch's current stream of the tensor's card, raises on a launch error
and adds one to its entry in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"occur_from_bitset": 0, "occur_from_bitset_masked": 0}

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
