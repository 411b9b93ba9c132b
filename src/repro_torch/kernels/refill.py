"""CUDA wrapper of gIM's persistent-lane sampler (``csrc/refill.cu``): one
launch samples a round's ``quota`` RR sets on ``lanes`` persistent lanes.

:func:`refill_bfs` computes the rows of ``kernels/ref.py::refill_round_ref``
byte for byte where no lane overflows (the kernel's note says how; which
lane holds which row depends on the schedule of the blocks).  It takes
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to the plain
version.  It checks its inputs as ``kernels/queue.py`` does, allocates the
outputs (the kernel writes every byte of them) and the claim counter,
which it zeroes on PyTorch's current stream of the tensors' card, puts the
visited bits in shared memory when they fit and else allocates a global
scratch, launches through a :class:`_build.Kernel` on that stream, raises
on a launch error and adds one to its entry in :data:`LAUNCHES`.  It
reads nothing back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue import check_csr, dedup_code, visited_in_shared

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"refill_bfs": 0}

_vp, _i32 = ctypes.c_void_p, ctypes.c_int32
_REFILL = _build.Kernel("refill", "refill_bfs",
                        (_vp, _vp, _vp, ctypes.c_uint32, ctypes.c_int64, _i32,
                         _i32, ctypes.c_int64, _i32, _i32, _vp, _vp, _vp,
                         _vp, _vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_int,
                         ctypes.c_int, _vp))


def refill_bfs(offsets: torch.Tensor, indices: torch.Tensor,
               weights: torch.Tensor, seed32: int, lanes: int, *,
               quota: int, out_cap: int, max_sets: int, ec: int,
               table=None, dedup: str = "none"):
    """One persistent-lane round on the card: rows ``0 .. quota - 1`` of
    round seed ``seed32`` (each the RR set of ``queue_bfs``'s lane of the
    same index) on ``lanes`` lanes of ``out_cap`` int32 and ``max_sets``
    slots each, on the reverse CSR of :func:`kernels.queue.queue_bfs` (the
    same ``table`` and ``dedup``).  Returns ``(flat (L, out_cap) int32,
    lengths (L, S) int32, n_done (L,) int32, overflowed (L,) bool, rows (L,
    S) int32, row_steps (L, S) int64)``: lane l's j-th set is ``flat[l,
    sum(lengths[l, :j]) :][:lengths[l, j]]``, root first, of row
    ``rows[l, j]`` with ``row_steps[l, j]`` lock-step micro-steps at chunk
    width ``ec``; slots past ``n_done[l]`` hold 0, -1 and 0.
    """
    dev, n, _, prob, alias = check_csr(offsets, indices, weights, table)
    lanes, quota, out_cap = int(lanes), int(quota), int(out_cap)
    max_sets, ec, code = int(max_sets), int(ec), dedup_code(dedup)
    if not 1 <= n < 1 << 31 or not 0 <= lanes < 1 << 31:
        raise ValueError(f"need 1 <= n < 2^31 and 0 <= lanes < 2^31, got "
                         f"n {n}, lanes {lanes}")
    if not 1 <= out_cap < 1 << 31 or ec < 1 or not 1 <= max_sets < 1 << 31 \
            or not 0 <= quota < 1 << 31:
        raise ValueError(f"need 1 <= out_cap < 2^31, ec >= 1, 1 <= max_sets "
                         f"< 2^31 and 0 <= quota < 2^31, got out_cap "
                         f"{out_cap}, ec {ec}, max_sets {max_sets}, quota "
                         f"{quota}")
    if lanes * max_sets >= 1 << 31:
        raise ValueError("lanes * max_sets slots must stay below 2^31")
    flat = torch.empty(lanes, out_cap, dtype=torch.int32, device=dev)
    visited = None if visited_in_shared(n) else torch.empty(
        lanes, (n + 31) // 32, dtype=torch.int32, device=dev)
    lengths = torch.empty(lanes, max_sets, dtype=torch.int32, device=dev)
    rows = torch.empty(lanes, max_sets, dtype=torch.int32, device=dev)
    row_steps = torch.empty(lanes, max_sets, dtype=torch.int64, device=dev)
    n_done = torch.empty(lanes, dtype=torch.int32, device=dev)
    overflowed = torch.empty(lanes, dtype=torch.bool, device=dev)
    if lanes:
        index = offsets.get_device()
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        err = _REFILL(offsets.data_ptr(), indices.data_ptr(),
                      weights.data_ptr(), int(seed32) & 0xFFFFFFFF, lanes, n,
                      out_cap, ec, quota, max_sets, flat.data_ptr(),
                      None if visited is None else visited.data_ptr(),
                      counter.data_ptr(), lengths.data_ptr(),
                      n_done.data_ptr(), overflowed.data_ptr(),
                      rows.data_ptr(), row_steps.data_ptr(),
                      None if prob is None else prob.data_ptr(),
                      None if alias is None else alias.data_ptr(), code,
                      index, _build.raw_stream(index))
        _build.raise_on(err, "refill_bfs")
        LAUNCHES["refill_bfs"] += 1
    return flat, lengths, n_done, overflowed, rows, row_steps
