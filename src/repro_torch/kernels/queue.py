"""CUDA wrapper of gIM's queue sampler (``csrc/queue.cu``): one launch
runs a whole sampling round, the lanes' row seeds and roots and every
lane's BFS to its end.

:func:`queue_bfs` computes what ``kernels/ref.py::queue_round_ref``
computes, byte for byte (the kernel's note says how).  It takes CUDA
tensors only; ``kernels/ops.py`` routes CPU tensors to the plain version.
It checks its inputs (an alias table's ``prob`` and ``alias`` too, when
the roots are weighted), allocates the outputs (the kernel writes every byte
of them, the zeros of the queue rows included), puts the visited bits in
shared memory when they fit (:func:`visited_in_shared`) and else allocates
a global scratch, launches through a :class:`_build.Kernel` on PyTorch's
current stream of the tensors' card (:func:`_build.raw_stream`), raises on
a launch error and adds one to its entry in :data:`LAUNCHES`.  It reads
nothing back: the caller makes the round's one host read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"queue_bfs": 0}

# csrc/queue.cu: a block of WARPS warps runs a lane and ranks a long row
# SEGMENT_EDGES edges at a time (WARPS warps x 32 tiles x 32 edges)
WARPS = 16
SEGMENT_EDGES = WARPS * 32 * 32
# csrc/queue.cu kMaxSharedVisitedBytes: the 232,448 bytes of shared memory
# a block can opt in to on sm_90, less 2,048 for the kernel's static arrays
MAX_SHARED_VISITED_BYTES = 232_448 - 2_048

# csrc/bfs_lane.cuh Dedup: the chunk dedup of core/rrset.py::detect_dedup_mode
DEDUP_MODES = {"none": 0, "segmented": 1, "sort": 2}

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
_BFS = _build.Kernel("queue", "queue_bfs",
                     (_vp, _vp, _vp, ctypes.c_uint32, _i64, ctypes.c_int32,
                      ctypes.c_int32, _i64, _vp, _vp, _vp, _vp, _vp, _vp,
                      _vp, _vp, ctypes.c_int, ctypes.c_int32, ctypes.c_uint32,
                      ctypes.c_int, _vp))


def visited_in_shared(n: int) -> bool:
    """Whether a lane's ceil(n / 32) visited words fit in a block's shared
    memory (n up to 1,843,200); else they go to a global scratch."""
    return 4 * ((n + 31) // 32) <= MAX_SHARED_VISITED_BYTES


def dedup_code(dedup: str) -> int:
    """The kernel's code of a dedup mode; an unknown mode raises."""
    try:
        return DEDUP_MODES[dedup]
    except KeyError:
        raise ValueError(f"unknown dedup mode {dedup!r}") from None


def check_csr(offsets: torch.Tensor, indices: torch.Tensor,
              weights: torch.Tensor, table):
    """Check a reverse CSR on a card (and an alias table over its nodes
    when one is given) -> (device, n, m, prob or None, alias or None)."""
    dev = offsets.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    for t, name, dtype in ((offsets, "offsets", torch.int32),
                           (indices, "indices", torch.int32),
                           (weights, "weights", torch.float32)):
        _check(t, name, dtype, dev)
    n, m = offsets.shape[0] - 1, indices.shape[0]
    if weights.shape[0] != m:
        raise ValueError("weights must match indices in length")
    if m >= 1 << 31:
        raise ValueError("int32 offsets hold at most 2^31 - 1 edges")
    prob = alias = None
    if table is not None:
        prob, alias = table
        _check(prob, "prob", torch.float32, dev)
        _check(alias, "alias", torch.int32, dev)
        if prob.shape[0] != n or alias.shape[0] != n:
            raise ValueError(f"an alias table over {n} nodes wants (n,) "
                             f"prob and alias, got {tuple(prob.shape)} and "
                             f"{tuple(alias.shape)}")
    return dev, n, m, prob, alias


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} must lie on {dev}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                         f"{tuple(t.shape)}")


def queue_bfs(offsets: torch.Tensor, indices: torch.Tensor,
              weights: torch.Tensor, seed32: int, batch: int, *, qcap: int,
              ec: int, table=None, dedup: str = "none", root_tile: int = 1,
              row0: int = 0):
    """One round of the queue sampler on the card.

    ``offsets`` (n+1,) int32, ``indices`` (m,) int32 and ``weights`` (m,)
    float32 are a reverse CSR, n >= 1, whose rows repeat no destination
    unless ``dedup`` is ``"segmented"`` (rows sorted by destination) or
    ``"sort"``; ``seed32`` the round's seed (taken mod 2^32), ``batch`` the
    lanes; ``table`` None (uniform roots) or an alias table ``(prob (n,)
    float32, alias (n,) int32)`` (``core/roots.py``) whose weights the roots
    follow; ``root_tile`` T >= 1 gives lanes ``[tT, tT + T)`` the root that
    lane tT draws (MRIM); lane i samples row ``row0 + i`` of the round (its
    row seed ``counter_uniform_u32(seed32, row0 + i)``, row numbers mod
    2^32): 0 for a whole round, ``d·b`` for rank d's b lanes of a round
    that D ranks share.  Returns ``(queue (B, qcap) int32, lengths (B,)
    int32, overflowed (B,) bool, steps (B,) int64, roots (B,) int32)``:
    lane b's RR set is ``queue[b, :lengths[b]]`` in visit order, zeros
    after it, from root ``roots[b]``; ``steps[b]`` is its lock-step count
    at chunk width ``ec``.
    """
    dev, n, m, prob, alias = check_csr(offsets, indices, weights, table)
    batch, qcap, ec = int(batch), int(qcap), int(ec)
    code, root_tile = dedup_code(dedup), int(root_tile)
    if not 1 <= n < 1 << 31 or not 0 <= batch < 1 << 31:
        raise ValueError(f"need 1 <= n < 2^31 and 0 <= batch < 2^31, got "
                         f"n {n}, batch {batch}")
    if not 1 <= qcap < 1 << 31 or ec < 1:
        raise ValueError(f"need 1 <= qcap < 2^31 and ec >= 1, got qcap "
                         f"{qcap}, ec {ec}")
    if not 1 <= root_tile < 1 << 31:
        raise ValueError(f"need 1 <= root_tile < 2^31, got {root_tile}")
    queue = torch.empty(batch, qcap, dtype=torch.int32, device=dev)
    visited = None if visited_in_shared(n) else torch.empty(
        batch, (n + 31) // 32, dtype=torch.int32, device=dev)
    roots = torch.empty(batch, dtype=torch.int32, device=dev)
    lengths = torch.empty(batch, dtype=torch.int32, device=dev)
    overflowed = torch.empty(batch, dtype=torch.bool, device=dev)
    steps = torch.empty(batch, dtype=torch.int64, device=dev)
    if batch:
        index = offsets.get_device()
        err = _BFS(offsets.data_ptr(), indices.data_ptr(), weights.data_ptr(),
                   int(seed32) & 0xFFFFFFFF, batch, n, qcap, ec,
                   queue.data_ptr(),
                   None if visited is None else visited.data_ptr(),
                   roots.data_ptr(), lengths.data_ptr(),
                   overflowed.data_ptr(), steps.data_ptr(),
                   None if prob is None else prob.data_ptr(),
                   None if alias is None else alias.data_ptr(), code,
                   root_tile, int(row0) & 0xFFFFFFFF, index,
                   _build.raw_stream(index))
        _build.raise_on(err, "queue_bfs")
        LAUNCHES["queue_bfs"] += 1
    return queue, lengths, overflowed, steps, roots
