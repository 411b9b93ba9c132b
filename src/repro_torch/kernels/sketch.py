"""CUDA wrappers of the coverage-sketch kernels (``csrc/sketch.cu``).

``sketch_scatter_or`` and ``sketch_union_popcount`` replace the Pallas
kernels of the same names in ``repro.kernels.sketch``.  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to ``ref.py``.
Each wrapper checks its inputs, launches on PyTorch's current stream of the
tensor's card, raises on a launch error and adds one to its entry in
:data:`LAUNCHES`.

``sketch_scatter_or`` updates ``words`` in place (the store folds every
batch into its own words; the plain version does the same) and returns it.
It reads back one int32 flag after the launch, so that a bucket outside
``[0, 32W)`` raises: one device sync per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"sketch_scatter_or": 0, "sketch_union_popcount": 0}

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sketch")
    lib.sketch_scatter_or.argtypes = [_vp, _vp, _vp, _i64, _i64, _i64, _vp,
                                      _vp]
    lib.sketch_scatter_or.restype = ctypes.c_int
    lib.sketch_union_popcount.argtypes = [_vp, _vp, _i64, _i64, _vp, _vp]
    lib.sketch_union_popcount.restype = ctypes.c_int
    return lib


def _int32_vector(x: torch.Tensor, like: torch.Tensor, name: str,
                  size: int | None = None) -> torch.Tensor:
    if x.device != like.device:
        raise ValueError(f"{name} must lie on the words' device")
    if x.dim() != 1 or (size is not None and x.shape[0] != size):
        raise ValueError(f"{name} must be 1-D"
                         + ("" if size is None else f" of length {size}")
                         + f", got {tuple(x.shape)}")
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be an integer tensor, got {x.dtype}")
    return x.to(torch.int32).contiguous()


def sketch_scatter_or(words: torch.Tensor, v: torch.Tensor,
                      bucket: torch.Tensor) -> torch.Tensor:
    """``words[v, bucket >> 5] |= 1 << (bucket & 31)`` in place on the
    card; (R, W) int32 words, (E,) int32/int64 ``v`` and ``bucket``.
    Pairs with ``v`` outside ``[0, R)`` are dropped.  Returns ``words``."""
    _build.check_words(words)
    r, w = words.shape
    v = _int32_vector(v, words, "v")
    bucket = _int32_vector(bucket, words, "bucket", v.shape[0])
    bad = torch.zeros(1, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = _lib().sketch_scatter_or(
            words.data_ptr(), v.data_ptr(), bucket.data_ptr(), v.shape[0], r,
            w, bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "sketch_scatter_or")
    LAUNCHES["sketch_scatter_or"] += 1
    if int(bad) != 0:
        raise ValueError(f"bucket outside [0, {32 * w})")
    return words


def sketch_union_popcount(words: torch.Tensor,
                          cov: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_w popcount(words[r, w] | cov[w])`` on the card:
    (R, W) int32 words and a (W,) int32 ``cov`` -> (R,) int32."""
    _build.check_words(words)
    r, w = words.shape
    if cov.device != words.device or cov.dtype != torch.int32 or \
            cov.shape != (w,):
        raise ValueError(f"cov must be ({w},) int32 on the words' device, "
                         f"got {tuple(cov.shape)} {cov.dtype} on {cov.device}")
    cov = cov.contiguous()
    out = torch.empty(r, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = _lib().sketch_union_popcount(
            words.data_ptr(), cov.data_ptr(), r, w, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "sketch_union_popcount")
    LAUNCHES["sketch_union_popcount"] += 1
    return out
