"""CUDA wrapper of the LT walk sampler (``csrc/lt.cu``): one launch runs a
whole sampling round, the lanes' row seeds and roots and every lane's
reverse walk to its end.

:func:`lt_walk` computes what ``kernels/ref.py::lt_round_ref`` computes,
byte for byte (the kernel's note says how).  It takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain version.  It checks its
inputs (an alias table's ``prob`` and ``alias`` too, when the roots are
weighted), allocates the outputs (the kernel writes every byte of them,
the zeros of the walk rows included), launches through a
:class:`_build.Kernel` on PyTorch's current stream of the tensors' card
(:func:`_build.raw_stream`), raises on a launch error and adds one to its
entry in :data:`LAUNCHES`.  It reads nothing back: the caller makes the
round's one host read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue import _check

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"lt_walk": 0}

# csrc/lt.cu: a warp walks a lane, LANES lanes a block of THREADS threads
# (which write the walks' zeros together), and each walking warp keeps its
# walk's first MIRROR nodes in shared memory
LANES, THREADS = 4, 512
MIRROR = 1024

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
_WALK = _build.Kernel("lt", "lt_walk",
                      (_vp, _vp, _vp, ctypes.c_uint32, _i64, ctypes.c_int32,
                       ctypes.c_int32, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                       ctypes.c_int, _vp))


def lt_walk(offsets: torch.Tensor, indices: torch.Tensor,
            rowcum: torch.Tensor, seed32: int, batch: int, *, qcap: int,
            table=None):
    """One round of the LT walk sampler on the card.

    ``offsets`` (n+1,) int32, ``indices`` (m,) int32 and ``rowcum`` (m,)
    float32 (``core/lt.py::row_cumweights``) are a reverse CSR, n >= 1;
    ``seed32`` the round's seed (taken mod 2^32), ``batch`` the lanes;
    ``table`` None (uniform roots) or an alias table ``(prob (n,) float32,
    alias (n,) int32)``.  Returns ``(walk (B, qcap) int32, lengths (B,)
    int32, overflowed (B,) bool, steps (B,) int64, roots (B,) int32)``, as
    ``ref.lt_round_ref``.
    """
    dev = offsets.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    for t, name, dtype in ((offsets, "offsets", torch.int32),
                           (indices, "indices", torch.int32),
                           (rowcum, "rowcum", torch.float32)):
        _check(t, name, dtype, dev)
    n, m = offsets.shape[0] - 1, indices.shape[0]
    if rowcum.shape[0] != m:
        raise ValueError("rowcum must match indices in length")
    if m >= 1 << 31:
        raise ValueError("int32 offsets hold at most 2^31 - 1 edges")
    batch, qcap = int(batch), int(qcap)
    if not 1 <= n < 1 << 31 or not 0 <= batch < 1 << 31:
        raise ValueError(f"need 1 <= n < 2^31 and 0 <= batch < 2^31, got "
                         f"n {n}, batch {batch}")
    if not 1 <= qcap < 1 << 31:
        raise ValueError(f"need 1 <= qcap < 2^31, got {qcap}")
    prob = alias = None
    if table is not None:
        prob, alias = table
        _check(prob, "prob", torch.float32, dev)
        _check(alias, "alias", torch.int32, dev)
        if prob.shape[0] != n or alias.shape[0] != n:
            raise ValueError(f"an alias table over {n} nodes wants (n,) "
                             f"prob and alias, got {tuple(prob.shape)} and "
                             f"{tuple(alias.shape)}")
    walk = torch.empty(batch, qcap, dtype=torch.int32, device=dev)
    roots = torch.empty(batch, dtype=torch.int32, device=dev)
    lengths = torch.empty(batch, dtype=torch.int32, device=dev)
    overflowed = torch.empty(batch, dtype=torch.bool, device=dev)
    steps = torch.empty(batch, dtype=torch.int64, device=dev)
    if batch:
        index = offsets.get_device()
        err = _WALK(offsets.data_ptr(), indices.data_ptr(), rowcum.data_ptr(),
                    int(seed32) & 0xFFFFFFFF, batch, n, qcap,
                    walk.data_ptr(), roots.data_ptr(), lengths.data_ptr(),
                    overflowed.data_ptr(), steps.data_ptr(),
                    None if prob is None else prob.data_ptr(),
                    None if alias is None else alias.data_ptr(), index,
                    _build.raw_stream(index))
        _build.raise_on(err, "lt_walk")
        LAUNCHES["lt_walk"] += 1
    return walk, lengths, overflowed, steps, roots
