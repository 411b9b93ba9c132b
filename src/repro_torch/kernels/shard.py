"""CUDA wrappers of the sharded pool's flat selection (``csrc/shard.cu``):
:func:`occur_flat`, the Occur histogram of a rank's shard, and
:func:`shard_flat_step`, one seed step of the sharded fused scan on it.
Neither replaces a Pallas kernel: the reference's sharded fused scan is
XLA inside ``shard_map`` (``src/repro/core/coverage.py:1359``).

Each computes what its plain version in ``kernels/ref.py`` computes
(``occur_flat_ref``, ``shard_flat_step_ref``), byte for byte.  The
wrappers take CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to
the plain versions.  Each checks its inputs, allocates its output,
launches through a :class:`_build.Kernel` on PyTorch's current stream of
the tensors' card (:func:`_build.raw_stream`), raises on a launch error
and adds one to its entry in :data:`LAUNCHES`.  Nothing is read back: the
step takes its seed from a device tensor, so a step makes no host sync.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.celf import _check_pool
from repro_torch.kernels.queue import _check

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"occur_flat": 0, "shard_flat_step": 0}

_vp, _i32, _i64, _int = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_int)
_OCCUR = _build.Kernel("shard", "occur_flat",
                       (_vp, _vp, _i64, _i32, _vp, _int, _vp))
_STEP = _build.Kernel("shard", "shard_flat_step",
                      (_vp, _vp, _vp, _i64, _vp, _i64, _vp, _i32, _vp, _int,
                       _vp))


def _check_n(n: int) -> int:
    n = int(n)
    if not 1 <= n < 2 ** 31 - 1:
        raise ValueError(f"need 1 <= n < 2^31 - 1, got {n}")
    return n


def occur_flat(flat: torch.Tensor, valid: torch.Tensor, *,
               n: int) -> torch.Tensor:
    """The valid elements of each node of a shard on the card: (t,) int32
    ``flat`` and bool ``valid`` -> (n,) int32."""
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    _check(flat, "flat", torch.int32, dev)
    _check(valid, "valid", torch.bool, dev)
    if valid.shape != flat.shape:
        raise ValueError("valid must match flat in length")
    n = _check_n(n)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    index = flat.get_device()
    err = _OCCUR(flat.data_ptr(), valid.data_ptr(), flat.shape[0], n,
                 out.data_ptr(), index, _build.raw_stream(index))
    _build.raise_on(err, "occur_flat")
    LAUNCHES["occur_flat"] += 1
    return out


def shard_flat_step(flat: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, cov_words: torch.Tensor,
                    u: torch.Tensor, *, n: int) -> torch.Tensor:
    """One seed step on a shard, on the card: (t,) int32 ``flat`` and
    ``ids`` (rows contiguous runs of equal ids) and bool ``valid``, the
    (rows/32,) int32 Covered words ``cov_words`` (updated in place), the
    seed ``u`` as a one-element int64 tensor on the card -> the (n + 1,)
    int32 decrement, the new rows' count in slot n."""
    _check_pool(flat, ids, valid, cov_words)
    dev = flat.device
    if u.device != dev or u.dtype != torch.int64 or u.numel() != 1:
        raise ValueError(f"u must be one int64 on {dev}, got "
                         f"{tuple(u.shape)} {u.dtype} on {u.device}")
    n = _check_n(n)
    u = u.contiguous()
    dec = torch.empty(n + 1, dtype=torch.int32, device=dev)
    index = flat.get_device()
    err = _STEP(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                flat.shape[0], cov_words.data_ptr(), cov_words.shape[0],
                u.data_ptr(), n, dec.data_ptr(), index,
                _build.raw_stream(index))
    _build.raise_on(err, "shard_flat_step")
    LAUNCHES["shard_flat_step"] += 1
    return dec
