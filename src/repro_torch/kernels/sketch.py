"""CUDA wrappers of the coverage-sketch kernels (``csrc/sketch.cu``).

``sketch_scatter_or`` and ``sketch_union_popcount`` replace the Pallas
kernels of the same names in ``repro.kernels.sketch``.  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to ``ref.py``.
Each wrapper checks its inputs, calls its C entry point through a
:class:`_build.Kernel` with the card's index and the raw handle of
PyTorch's current stream of that card (:func:`_build.raw_stream`), as
``kernels/bitset.py`` does, raises on a launch error and adds one to its
entry in :data:`LAUNCHES`.

``sketch_scatter_or`` updates ``words`` in place (the store folds every
batch into its own words; the plain version does the same) and returns it.
A bucket outside ``[0, 32W)`` sets an int32 flag in the kernel.  Given the
caller's flag (``bad``, as ``SketchRRStore`` passes its own) the wrapper
reads nothing back and the caller checks the flag in a host read it makes
anyway; without one it reads its own flag after the launch and raises: one
device sync per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"sketch_scatter_or": 0, "sketch_union_popcount": 0}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SCATTER = _build.Kernel("sketch", "sketch_scatter_or",
                         (_vp, _vp, _vp, _i64, _i64, _i64, _vp, _int, _vp))
_UNION = _build.Kernel("sketch", "sketch_union_popcount",
                       (_vp, _vp, _i64, _i64, _vp, _int, _vp))


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
                      bucket: torch.Tensor,
                      bad: torch.Tensor | None = None) -> torch.Tensor:
    """``words[v, bucket >> 5] |= 1 << (bucket & 31)`` in place on the
    card; (R, W) int32 words, (E,) int32/int64 ``v`` and ``bucket``.
    Pairs with ``v`` outside ``[0, R)`` are dropped.  A bucket outside
    ``[0, 32W)`` raises, or, given a (1,) int32 flag ``bad`` on the words'
    card, sets it nonzero with no host read.  Returns ``words``."""
    _build.check_words(words)
    r, w = words.shape
    v = _int32_vector(v, words, "v")
    bucket = _int32_vector(bucket, words, "bucket", v.shape[0])
    if bad is None:
        flag = torch.zeros(1, dtype=torch.int32, device=words.device)
    elif (bad.device != words.device or bad.dtype != torch.int32
          or bad.shape != (1,)):
        raise ValueError(f"bad must be a (1,) int32 flag on {words.device}, "
                         f"got {tuple(bad.shape)} {bad.dtype} on "
                         f"{bad.device}")
    else:
        flag = bad
    dev = words.get_device()
    err = _SCATTER(words.data_ptr(), v.data_ptr(), bucket.data_ptr(),
                   v.shape[0], r, w, flag.data_ptr(), dev,
                   _build.raw_stream(dev))
    _build.raise_on(err, "sketch_scatter_or")
    LAUNCHES["sketch_scatter_or"] += 1
    if bad is None and int(flag) != 0:
        raise ValueError(f"bucket outside [0, {32 * w})")
    return words


def sketch_union_popcount(words: torch.Tensor,
                          cov: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_w popcount(words[r, w] | cov[w])`` on the card:
    (R, W) int32 words and a (W,) int32 ``cov`` -> (R,) int32."""
    if not (words.is_cuda and words.dtype == torch.int32 and words.dim() == 2
            and words.is_contiguous() and cov.is_cuda
            and cov.dtype == torch.int32 and cov.dim() == 1
            and cov.shape[0] == words.shape[1]
            and cov.get_device() == words.get_device()):
        _build.check_words(words)
        raise ValueError(f"cov must be ({words.shape[1]},) int32 on the "
                         f"words' device, got {tuple(cov.shape)} {cov.dtype} "
                         f"on {cov.device}")
    if not cov.is_contiguous():
        cov = cov.contiguous()
    r, w = words.shape
    dev = words.get_device()
    out = words.new_empty(r)
    err = _UNION(words.data_ptr(), cov.data_ptr(), r, w, out.data_ptr(), dev,
                 _build.raw_stream(dev))
    _build.raise_on(err, "sketch_union_popcount")
    LAUNCHES["sketch_union_popcount"] += 1
    return out
