"""CUDA wrapper of the flash-attention kernel (``csrc/flashattn.cu``).

``flash_attention`` replaces the Pallas kernel of the same name in
``repro.kernels.flashattn``.  The wrapper takes CUDA tensors only;
``kernels/ops.py`` checks the reference's block contract
(:func:`check_blocks`) and routes CPU tensors to ``ref.py``.  It checks its
inputs, allocates the output, launches on PyTorch's current stream of the
tensor's card, raises on a launch error and adds one to its entry in
:data:`LAUNCHES`.

The wrapper takes the kernel's layouts only: contiguous, 16-byte aligned
tensors with D in :data:`HEAD_DIMS` or a multiple of :data:`SPLIT_CHUNK`
above :data:`MAX_SINGLE_PASS` (the column-split kernel).
``ops.flash_attention`` takes any layout and any D, as the reference does:
it copies an input the kernel cannot read (:func:`kernel_layout`) and
zero-pads D to :func:`padded_head_dim` (zero columns add nothing to
q . k, and the output's padding columns are sliced off), passing the true
D's scale.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (8, 16, 64, 128, 256)     # the one-pass kernels' instantiations
WGMMA_HEAD_DIMS = (64, 128, 256)      # the tensor-core kernel's
MAX_SINGLE_PASS = HEAD_DIMS[-1]
SPLIT_CHUNK = 64                      # kSplitDC: D > 256 is a multiple of it
SPLIT_COLUMNS = 256                   # kSplitDV: output columns a block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TMA_ALIGN = 16                       # bytes, TMA's base alignment


def _takes(d: int) -> bool:
    return d in HEAD_DIMS or (d > MAX_SINGLE_PASS and d % SPLIT_CHUNK == 0)


def design(dtype: torch.dtype, d: int) -> str:
    """The kernel that ``flash_attention`` launches for (dtype, D), the same
    choice as ``csrc/flashattn.cu``: ``"wgmma"`` (tensor cores fed by TMA)
    for bfloat16 and float16 at D in :data:`WGMMA_HEAD_DIMS`;
    ``"simt_split"`` (float32 FMAs, output columns split over blocks) for
    every dtype at D above :data:`MAX_SINGLE_PASS`, a multiple of
    :data:`SPLIT_CHUNK`; else ``"simt"`` (float32 FMAs; float32 at D up to
    256, 16 bits at D = 8, 16)."""
    if dtype not in _DTYPE_CODE or not _takes(d):
        raise ValueError(f"no flash kernel for {dtype} at head dim {d}")
    if d > MAX_SINGLE_PASS:
        return "simt_split"
    if dtype != torch.float32 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def padded_head_dim(d: int) -> int:
    """The head dim the kernel runs for a true ``d``: the least of
    :data:`HEAD_DIMS` at or above it, or, past :data:`MAX_SINGLE_PASS`,
    ``d`` rounded up to a multiple of :data:`SPLIT_CHUNK`."""
    if d < 1:
        raise ValueError(f"head dim {d} must be at least 1")
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // SPLIT_CHUNK) * SPLIT_CHUNK


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it (contiguous, 16-byte
    aligned), else one copy into a fresh allocation."""
    if t.is_contiguous() and t.data_ptr() % _TMA_ALIGN == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flashattn")
    lib.flash_attention.argtypes = [_vp, _vp, _vp, _vp, _i64, _i64, _i64,
                                    _i64, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, _vp]
    lib.flash_attention.restype = ctypes.c_int
    return lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def check_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bq: int, bk: int) -> None:
    """The reference's contract: q, k, v of one (B, S, H, D) shape (repeat
    the KV heads beforehand for GQA), and S a multiple of ``min(bq, S)``
    and ``min(bk, S)``."""
    _check_shapes(q, k, v)
    s = q.shape[1]
    if s % min(bq, s) or s % min(bk, s):
        raise ValueError("S must be a multiple of the block sizes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over (B, S, H, D) q, k, v on the card, computed in float32,
    returned in q's dtype.  All three contiguous, 16-byte aligned, of one
    shape and dtype (float32, bfloat16 or float16), with D in
    :data:`HEAD_DIMS` or a multiple of :data:`SPLIT_CHUNK` above
    :data:`MAX_SINGLE_PASS`; the kernel is :func:`design`'s.  The logits are
    scaled by ``scale``, ``1/sqrt(D)`` when None."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"CUDA kernel given {name} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32, bfloat16 or float16 "
                            f"like q, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, S, H, D)")
        if t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"{name} must start on a {_TMA_ALIGN}-byte "
                             f"boundary")
    _check_shapes(q, k, v)
    b, s, h, d = q.shape
    if not _takes(d):
        raise ValueError(f"head dim {d} not supported; the kernel takes "
                         f"{HEAD_DIMS} and multiples of {SPLIT_CHUNK} above "
                         f"{MAX_SINGLE_PASS}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
            d, _DTYPE_CODE[q.dtype], int(bool(causal)), float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
