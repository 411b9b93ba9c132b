"""CUDA wrapper of the RR-set membership scan (``csrc/membership.cu``).

``membership_rows`` replaces the Pallas kernel of the same name in
``repro.kernels.membership``.  The wrapper takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to ``ref.py``.  It checks its inputs,
launches on PyTorch's current stream of the tensor's card, raises on a
launch error and adds one to its entry in :data:`LAUNCHES`.

``u`` may be a Python int or a 0-d / 1-element integer tensor on the rows'
card; the kernel reads it from device memory, so a ``u`` that an argmax
left on the card costs no host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"membership_rows": 0}

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("membership")
    lib.membership_rows.argtypes = [_vp, _vp, _vp, _i64, _i64, _vp, _vp]
    lib.membership_rows.restype = ctypes.c_int
    return lib


def _device_u(u, rows: torch.Tensor) -> torch.Tensor:
    """``u`` as a 1-element int32 tensor on the rows' card."""
    if not isinstance(u, torch.Tensor):
        return torch.tensor([int(u)], dtype=torch.int32, device=rows.device)
    if u.device != rows.device:
        raise ValueError(f"u must lie on the rows' device {rows.device}, "
                         f"got {u.device}")
    if u.numel() != 1:
        raise ValueError(f"u must hold one value, got {tuple(u.shape)}")
    if u.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"u must be an integer tensor, got {u.dtype}")
    return u.reshape(1).to(torch.int32).contiguous()


def membership_rows(rows: torch.Tensor, lengths: torch.Tensor,
                    u) -> torch.Tensor:
    """``hit[r] = any(rows[r, :lengths[r]] == u)`` on the card: (R, L)
    contiguous int32 rows, (R,) int32/int64 lengths -> (R,) bool."""
    _build.check_words(rows, "rows")
    r, l = rows.shape
    if lengths.device != rows.device or lengths.shape != (r,):
        raise ValueError(f"lengths must be ({r},) on the rows' device, got "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lengths must be an integer tensor, got "
                        f"{lengths.dtype}")
    lengths = lengths.to(torch.int32).contiguous()
    u_dev = _device_u(u, rows)
    hit = torch.empty(r, dtype=torch.bool, device=rows.device)
    with torch.cuda.device(rows.device):
        err = _lib().membership_rows(
            rows.data_ptr(), lengths.data_ptr(), u_dev.data_ptr(), r, l,
            hit.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "membership_rows")
    LAUNCHES["membership_rows"] += 1
    return hit
