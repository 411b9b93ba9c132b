"""CUDA wrappers of the fused greedy max-coverage (``csrc/greedy.cu``): one
cooperative launch runs all k seed steps of the ``flat`` selection (paper
Alg. 7) on the exact pool (:func:`greedy_flat`), of the problem variants'
greedy on the same pool (:func:`greedy_flat_variant`), or of the
approximate mode's greedy on the coverage sketch (:func:`greedy_sketch`).

:func:`greedy_flat` computes what ``kernels/ref.py::greedy_flat_ref``
computes, seeds and gains byte for byte (the kernel's note says how).  It
takes CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to the
plain version.  It checks the pool, allocates the outputs and one scratch
buffer (:func:`flat_scratch_bytes`; the kernel writes every byte it reads
of them and builds the pool's indices inside the launch), launches through
a :class:`_build.Kernel` on PyTorch's current stream of the tensors' card
(:func:`_build.raw_stream`), raises on a launch error and adds one to its
entry in :data:`LAUNCHES`.  It reads nothing back, so a selection makes
no host sync and one device operation.  :func:`greedy_flat_variant` does
the same for ``kernels/ref.py::greedy_flat_variant_ref``, with the
candidate bytes, costs and budget, and the groups' quotas, and
:func:`greedy_stacked` for ``kernels/ref.py::greedy_stacked_ref``: R of
those selections on one pool in one launch, each request's operands a row
(:func:`stacked_scratch_bytes` sizes its scratch).

:func:`greedy_sketch` computes what ``kernels/ref.py::greedy_sketch_ref``
computes, byte for byte, likewise on CUDA tensors only: it checks the
sketch before it builds anything, chooses where the rows live and their
lane groups (:func:`sketch_layout`), allocates the outputs and the scratch
(:func:`sketch_scratch_bytes`) and launches; nothing is read back.

:func:`grid_barriers` launches the same grid (a block of 512 threads on
each SM, the grid of both kernels) with nothing but the grid barriers in
it: the floor of either kernel's time (:func:`sketch_barriers` counts
``greedy_sketch``'s).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"greedy_flat": 0, "greedy_flat_variant": 0,
            "greedy_flat_variant[weighted]": 0, "greedy_stacked": 0,
            "greedy_sketch": 0}

# csrc/greedy.cu: threads a block; the grid is a block on every SM
THREADS = 512

_vp, _i32, _i64, _int = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_int)
_GREEDY = _build.Kernel("greedy", "greedy_flat",
                        (_vp, _vp, _vp, _i64, _i32, _i64, _i32, _vp, _i64,
                         _vp, _int, _vp))
_VARIANT = _build.Kernel("greedy", "greedy_flat_variant",
                         (_vp, _vp, _vp, _i64, _i32, _i64, _i32, _vp, _vp,
                          ctypes.c_float, _i32, _i32, _i32, _vp, _vp, _i64,
                          _vp, _vp, _int, _vp))
_STACKED = _build.Kernel("greedy", "greedy_stacked",
                         (_vp, _vp, _vp, _i64, _i32, _i64, _i32, _i32, _vp,
                          _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp,
                          _i64, _vp, _vp, _int, _vp))
_STACKED_GRID = _build.Kernel("greedy", "greedy_stacked_grid",
                              (_int, ctypes.POINTER(_int),
                               ctypes.POINTER(_i64)))
_FLAT_GRID = _build.Kernel("greedy", "greedy_flat_grid",
                           (_int, ctypes.POINTER(_int),
                            ctypes.POINTER(_i64)))
_BARRIERS = _build.Kernel("greedy", "greedy_grid_barriers", (_i32, _int, _vp))
_SKETCH = _build.Kernel("greedy", "greedy_sketch",
                        (_vp, _i32, _i32, _int, _int, _int, _int, _i32, _vp,
                         _vp, _vp, _int, _vp))
_SKETCH_GRID = _build.Kernel("greedy", "greedy_sketch_grid",
                             (_int, ctypes.POINTER(_int),
                              ctypes.POINTER(_i64)))


class FlatLayout(NamedTuple):
    """Where :func:`greedy_flat`'s per-block state lives: block b owns the
    nodes [b * slots, (b + 1) * slots) below n, and keeps their list
    starts and Occur and a Covered of ``cov_words`` words (and, in
    :func:`greedy_flat_variant`, its :func:`variant_words`) in dynamic
    shared memory when ``shared``, else in the scratch."""
    slots: int
    cov_words: int
    shared: bool


def variant_words(slots: int, n_group: int | None,
                  n_groups: int) -> tuple[int, int]:
    """A block's extra words in :func:`greedy_flat_variant` (none without
    groups): a blocked bit a slice node, and the quotas of the groups a
    slice of ``slots`` nodes meets (at most ``(slots - 1) // n_group +
    2``)."""
    if n_group is None:
        return 0, 0
    return -(-slots // 32), min(n_groups, (slots - 1) // n_group + 2)


def flat_layout(n: int, num_rows: int, blocks: int, shared_bytes: int,
                n_group: int | None = None, n_groups: int = 1) -> FlatLayout:
    """:class:`FlatLayout` on a grid of ``blocks`` whose dynamic shared
    memory holds ``shared_bytes``: shared when the blocks' base table (4
    bytes a block), a block's list starts (slots + 1), Occur (slots) and
    Covered words (4 bytes each) fit, with, given the variant's groups of
    ``n_group`` ids, its :func:`variant_words`."""
    slots = -(-n // blocks)
    cov_words = -(-num_rows // 32)
    extra = sum(variant_words(slots, n_group, n_groups))
    shared = 4 * (blocks + 2 * slots + 1 + cov_words + extra) <= shared_bytes
    return FlatLayout(slots, cov_words, shared)


def flat_scratch_bytes(n: int, num_rows: int, t: int, k: int, blocks: int,
                       shared_bytes: int, n_group: int | None = None,
                       n_groups: int = 1, weighted: bool = False) -> int:
    """Scratch of one :func:`greedy_flat` launch over ``t`` elements (or
    :func:`greedy_flat_variant`'s, given its groups): the blocks' step
    records (16 bytes a block a step, 24 in the variant), the t list
    entries' row spans (8 bytes each), count and cursor (n int32 each),
    row_start (num_rows + 1), nodes and inv_rows (t each) and the blocks'
    sums (one each), in the ``weighted`` form a float Occur a node and a
    weight a row, then, when the blocks' state is not in shared memory,
    each block's list starts, Occur and Covered words (and the variant's
    words)."""
    lay = flat_layout(n, num_rows, blocks, shared_bytes, n_group, n_groups)
    record = 16 if n_group is None else 24
    fixed = record * k * blocks + 8 * t + 4 * (2 * n + num_rows + 1 + 2 * t
                                               + blocks)
    if weighted:
        fixed += 4 * (n + num_rows)
    return fixed if lay.shared else \
        fixed + 4 * blocks * (2 * lay.slots + 1 + lay.cov_words
                              + sum(variant_words(lay.slots, n_group,
                                                  n_groups)))


def _check(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, *,
           n: int, num_rows: int, k: int) -> None:
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    for t, name, dtype in ((flat, "flat", torch.int32),
                           (ids, "ids", torch.int32),
                           (valid, "valid", torch.bool)):
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape != flat.shape:
            raise ValueError(f"{name} must be 1-D of flat's length "
                             f"{flat.shape[0]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= n < (1 << 31) - 1 or k < 1:
        raise ValueError(f"need 1 <= n < 2^31 - 1 and k >= 1, got n {n}, "
                         f"k {k}")
    if not 1 <= num_rows < 1 << 31 or flat.shape[0] >= 1 << 31:
        raise ValueError(f"need 1 <= num_rows < 2^31 and fewer than 2^31 "
                         f"elements, got {num_rows}, {flat.shape[0]}")


def greedy_flat(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                *, n: int, num_rows: int, k: int):
    """``k`` greedy steps on the card: (t,) int32 ``flat`` and ``ids`` (rows
    contiguous and in row order, row ids below ``num_rows``) and bool
    ``valid`` -> ``(seeds (k,) int32, gains (k,) int32)``, as
    ``ref.greedy_flat_ref``."""
    n, num_rows, k = int(n), int(num_rows), int(k)
    _check(flat, ids, valid, n=n, num_rows=num_rows, k=k)
    index = flat.get_device()
    blocks, shared_bytes = _flat_grid(index)
    t = flat.shape[0]
    out = torch.empty(2, k, dtype=torch.int32, device=flat.device)
    size = flat_scratch_bytes(n, num_rows, t, k, blocks, shared_bytes)
    scratch = torch.empty(size, dtype=torch.uint8, device=flat.device)
    err = _GREEDY(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(), t, n,
                  num_rows, k, scratch.data_ptr(), size, out.data_ptr(),
                  index, _build.raw_stream(index))
    _build.raise_on(err, "greedy_flat")
    LAUNCHES["greedy_flat"] += 1
    return out[0], out[1]


def greedy_flat_variant(flat: torch.Tensor, ids: torch.Tensor,
                        valid: torch.Tensor, *, n: int, num_rows: int, k: int,
                        cand: torch.Tensor, costs: torch.Tensor | None,
                        budget: float, n_group: int, n_groups: int,
                        group_quota: int, ew: torch.Tensor | None = None):
    """``k`` steps of the problem variants' greedy on the card:
    :func:`greedy_flat`'s pool, an (n,) bool candidate mask ``cand``, (n,)
    float32 ``costs`` or None (no budget), the float32 ``budget`` and
    groups of ``n_group`` ids (``n_group * n_groups >= n``) of
    ``group_quota`` seeds each -> ``(seeds (k,) int32, gains (k,) int32,
    spent () float32)``, as ``ref.greedy_flat_variant_ref``.  With ``ew``,
    the (t,) float32 element weights, the weighted form (gains float32),
    counted under ``greedy_flat_variant[weighted]``."""
    n, num_rows, k = int(n), int(num_rows), int(k)
    n_group, n_groups, quota = int(n_group), int(n_groups), int(group_quota)
    _check(flat, ids, valid, n=n, num_rows=num_rows, k=k)
    dev = flat.device
    if cand.device != dev or cand.dtype != torch.bool or \
            cand.shape != (n,) or not cand.is_contiguous():
        raise ValueError(f"cand must be a contiguous ({n},) bool tensor on "
                         f"{dev}")
    if costs is not None and (costs.device != dev or
                              costs.dtype != torch.float32 or
                              costs.shape != (n,) or
                              not costs.is_contiguous()):
        raise ValueError(f"costs must be a contiguous ({n},) float32 tensor "
                         f"on {dev}")
    if not 1 <= n_group < 1 << 31 or not 1 <= n_groups < 1 << 31 or \
            n_group * n_groups < n or not 0 <= quota < 1 << 31:
        raise ValueError(f"groups of {n_group} ids x {n_groups} must cover "
                         f"{n} nodes, quota {quota} >= 0")
    if ew is not None and (ew.device != dev or ew.dtype != torch.float32 or
                           ew.shape != flat.shape or
                           not ew.is_contiguous()):
        raise ValueError(f"ew must be a contiguous {tuple(flat.shape)} "
                         f"float32 tensor on {dev}")
    index = flat.get_device()
    blocks, shared_bytes = _flat_grid(index)
    t = flat.shape[0]
    out = torch.empty(2 * k + 1, dtype=torch.int32, device=dev)
    spent = out[2 * k:].view(torch.float32)
    size = flat_scratch_bytes(n, num_rows, t, k, blocks, shared_bytes,
                              n_group, n_groups, weighted=ew is not None)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    err = _VARIANT(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(), t, n,
                   num_rows, k, cand.data_ptr(),
                   None if costs is None else costs.data_ptr(),
                   float(budget), n_group, n_groups, quota,
                   None if ew is None else ew.data_ptr(),
                   scratch.data_ptr(), size, out.data_ptr(), spent.data_ptr(),
                   index, _build.raw_stream(index))
    _build.raise_on(err, "greedy_flat_variant")
    if ew is None:
        LAUNCHES["greedy_flat_variant"] += 1
        return out[:k], out[k:2 * k], spent[0]
    LAUNCHES["greedy_flat_variant[weighted]"] += 1
    return out[:k], out[k:2 * k].view(torch.float32), spent[0]


def stacked_layout(n: int, num_rows: int, blocks: int, n_group: int,
                   n_groups: int) -> tuple[int, int, int]:
    """``(slots, blocked_words, group_words)`` of :func:`greedy_stacked` on
    a grid of ``blocks``: a block's slice of nodes, and its blocked bits and
    group quotas for each row (:func:`variant_words`)."""
    slots = -(-n // blocks)
    return (slots, *variant_words(slots, n_group, n_groups))


def stacked_scratch_bytes(n: int, num_rows: int, t: int, rows: int,
                          blocks: int, n_group: int, n_groups: int) -> int:
    """Scratch of one :func:`greedy_stacked` launch of ``rows`` requests
    over ``t`` elements: the step records (16 bytes a row a block), the t
    list entries' row spans (8 bytes each), count, cursor and list start
    (n int32 each), row_start (num_rows + 1), nodes and inv_rows (t each)
    and the blocks' sums, then the rows' Occur (n int32 each) and Covered
    (a word for 32 of ``num_rows``), and each row's blocked bits and group
    quotas in each block."""
    _, blocked, groups = stacked_layout(n, num_rows, blocks, n_group,
                                        n_groups)
    return 16 * rows * blocks + 8 * t + 4 * (
        3 * n + num_rows + 1 + 2 * t + blocks
        + rows * (n + -(-num_rows // 32))
        + rows * blocks * (blocked + groups))


def stacked_shared_bytes(rows: int, blocks: int) -> int:
    """Dynamic shared memory of one :func:`greedy_stacked` launch: the
    blocks' bases and seven words a row (the row's node, gain, list span,
    first cover chunk, spent and done flag), and one more."""
    return 4 * (blocks + 7 * rows + 1)


def greedy_stacked(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                   *, n: int, num_rows: int, k_max: int, cand: torch.Tensor,
                   costs: torch.Tensor, budget: torch.Tensor,
                   ks: torch.Tensor, quota: torch.Tensor, plain: torch.Tensor,
                   use_costs: torch.Tensor, n_group: int, n_groups: int):
    """R selections on :func:`greedy_flat`'s pool in one launch: row r of
    the (R, n) bool ``cand`` and float32 ``costs`` and of the (R,) float32
    ``budget``, int32 ``ks`` (its steps, at most ``k_max``) and ``quota``
    and bool ``plain`` and ``use_costs`` is request r's; the groups of
    ``n_group`` ids (``n_group * n_groups >= n``) are the batch's ->
    ``(seeds (R, k_max) int32, gains (R, k_max) int32, spent (R,)
    float32)``, as ``ref.greedy_stacked_ref``."""
    n, num_rows, k_max = int(n), int(num_rows), int(k_max)
    n_group, n_groups = int(n_group), int(n_groups)
    _check(flat, ids, valid, n=n, num_rows=num_rows, k=k_max)
    dev = flat.device
    rows = ks.shape[0] if ks.dim() == 1 else -1
    for name, x, dtype, shape in (
            ("cand", cand, torch.bool, (rows, n)),
            ("costs", costs, torch.float32, (rows, n)),
            ("budget", budget, torch.float32, (rows,)),
            ("ks", ks, torch.int32, (rows,)),
            ("quota", quota, torch.int32, (rows,)),
            ("plain", plain, torch.bool, (rows,)),
            ("use_costs", use_costs, torch.bool, (rows,))):
        if x.device != dev or x.dtype != dtype or x.shape != shape or \
                not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if rows < 1 or not 1 <= n_group < 1 << 31 or \
            not 1 <= n_groups < 1 << 31 or n_group * n_groups < n:
        raise ValueError(f"need at least one row and groups of {n_group} "
                         f"ids x {n_groups} covering {n} nodes")
    index = flat.get_device()
    blocks, shared_bytes = stacked_grid(dev)
    if stacked_shared_bytes(rows, blocks) > shared_bytes:
        raise ValueError(f"{rows} rows need more shared memory than a block "
                         f"of the card has ({shared_bytes} bytes)")
    t = flat.shape[0]
    out = torch.empty(2, rows, k_max, dtype=torch.int32, device=dev)
    spent = torch.empty(rows, dtype=torch.float32, device=dev)
    size = stacked_scratch_bytes(n, num_rows, t, rows, blocks, n_group,
                                 n_groups)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    err = _STACKED(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(), t, n,
                   num_rows, rows, k_max, cand.data_ptr(), costs.data_ptr(),
                   budget.data_ptr(), ks.data_ptr(), quota.data_ptr(),
                   plain.data_ptr(), use_costs.data_ptr(), n_group, n_groups,
                   scratch.data_ptr(), size, out.data_ptr(), spent.data_ptr(),
                   index, _build.raw_stream(index))
    _build.raise_on(err, "greedy_stacked")
    LAUNCHES["greedy_stacked"] += 1
    return out[0], out[1], spent


def stacked_grid(device) -> tuple[int, int]:
    """``(blocks, shared_bytes)`` of :func:`greedy_stacked`'s grid on card
    ``device``: a block on each SM, and the dynamic shared memory a block
    may take; read from the card once."""
    return _stacked_grid(device_index(device))


@functools.cache
def _stacked_grid(index: int) -> tuple[int, int]:
    blocks, nbytes = _int(0), _i64(0)
    _build.raise_on(_STACKED_GRID(index, ctypes.byref(blocks),
                                  ctypes.byref(nbytes)),
                    "greedy_stacked_grid")
    return blocks.value, nbytes.value


def device_index(device) -> int:
    """The index of card ``device`` (the current card when it has none)."""
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def flat_grid(device) -> tuple[int, int]:
    """``(blocks, shared_bytes)`` of :func:`greedy_flat`'s grid on card
    ``device``: a block on each SM, and the dynamic shared memory a block
    may take; read from the card once."""
    return _flat_grid(device_index(device))


@functools.cache
def _flat_grid(index: int) -> tuple[int, int]:
    blocks, nbytes = _int(0), _i64(0)
    _build.raise_on(_FLAT_GRID(index, ctypes.byref(blocks),
                               ctypes.byref(nbytes)), "greedy_flat_grid")
    return blocks.value, nbytes.value


def grid_blocks(device) -> int:
    """The blocks of :func:`greedy_flat`'s grid on card ``device``."""
    return flat_grid(device)[0]


def grid_barriers(count: int, device) -> None:
    """One cooperative launch of :func:`greedy_flat`'s grid on card
    ``device`` that runs ``count`` grid barriers and nothing else (not
    counted in :data:`LAUNCHES`)."""
    index = device_index(device)
    _build.raise_on(_BARRIERS(int(count), index, _build.raw_stream(index)),
                    "greedy_grid_barriers")


# csrc/greedy.cu: kMaxRegRows, the rows a thread of greedy_sketch holds in
# registers; the forms of its rows (SketchForm)
REG_ROWS = 2
SKETCH_FORMS = ("registers", "shared", "global")
# bytes of one block's record of one greedy_sketch step (SketchRecord); a
# launch keeps two steps' records
SKETCH_RECORD_BYTES = 32


class SketchLayout(NamedTuple):
    """How :func:`greedy_sketch` reads the rows: ``lanes`` lanes a row
    (16-byte loads when ``vector``), and where a block's slice of rows
    lives for the launch (``form``): in registers, ``rows`` a thread (W <=
    4: a thread a row), in shared memory after cov, or read from global
    memory every step."""
    lanes: int
    vector: bool
    form: str
    rows: int


def row_lanes(cols: int, aligned: bool) -> tuple[int, bool]:
    """``(lanes, vector)`` of a sketch row of ``cols`` words: ``vector``
    when the rows take 16-byte loads (``cols % 4 == 0`` and the words
    16-byte ``aligned``); ``lanes`` = 1 (a thread a row) at ``cols <=
    4``, else the least power of two at or above the row's loads, at most
    32.  ``celf_select``'s sweep takes the same."""
    vector = cols % 4 == 0 and aligned
    loads = cols // 4 if vector else cols
    lanes = 1
    if cols > 4:
        while lanes < 32 and lanes < loads:
            lanes *= 2
    return lanes, vector


def sketch_layout(cols: int, aligned: bool, *, n: int, blocks: int,
                  shared_words: int) -> SketchLayout:
    """:class:`SketchLayout` of :func:`greedy_sketch` at ``cols`` words a
    row and ``n`` nodes on a grid of ``blocks`` whose dynamic shared memory
    holds ``shared_words`` words: block b owns ceil(n / blocks) rows;
    ``"registers"`` at ``cols <= 4`` while a thread holds at most
    :data:`REG_ROWS` of them (``rows``, a power of two), else
    ``"shared"`` while cov (rounded up to 4 words), the slice and its
    picked bits (a word for 32 rows) fit, else ``"global"``."""
    lanes, vector = row_lanes(cols, aligned)
    slots = -(-n // blocks)
    need = -(-slots // THREADS)
    if cols <= 4 and need <= REG_ROWS:
        rows = 1
        while rows < need:
            rows *= 2
        return SketchLayout(lanes, vector, "registers", rows)
    if -(-cols // 4) * 4 + slots * cols + -(-slots // 32) <= shared_words:
        return SketchLayout(lanes, vector, "shared", 1)
    return SketchLayout(lanes, vector, "global", 1)


def sketch_scratch_bytes(n: int, cols: int, blocks: int, shared_words: int,
                         form: str) -> int:
    """Scratch of one :func:`greedy_sketch` launch: the blocks' records of
    two steps (:data:`SKETCH_RECORD_BYTES` each) and each block's picked
    bits (a word for 32 of its ceil(n / blocks) rows), then, in the
    ``"global"`` form when a row's ``cols`` words (rounded up to 4) exceed
    ``shared_words``, each block's copy of cov from the next 16-byte
    boundary."""
    slots = -(-n // blocks)
    fixed = 2 * SKETCH_RECORD_BYTES * blocks + 4 * blocks * -(-slots // 32)
    stride = -(-cols // 4) * 4
    if form != "global" or stride <= shared_words:
        return fixed
    return -(-fixed // 16) * 16 + 4 * blocks * stride


def sketch_barriers(steps: int, k: int) -> int:
    """Grid barriers of one :func:`greedy_sketch` launch that took
    ``steps`` of ``k`` steps: the prologue's, and one a step run (the steps
    taken and, below k, the one that found no node)."""
    return 1 + min(steps + 1, k)


def sketch_grid(device) -> tuple[int, int]:
    """``(blocks, shared_words)`` of :func:`greedy_sketch`'s grid on card
    ``device``: a block on each SM, and the dynamic shared memory in words
    that a block may take; read from the card once."""
    return _sketch_grid(device_index(device))


@functools.cache
def _sketch_grid(index: int) -> tuple[int, int]:
    blocks, words = _int(0), _i64(0)
    _build.raise_on(_SKETCH_GRID(index, ctypes.byref(blocks),
                                 ctypes.byref(words)), "greedy_sketch_grid")
    return blocks.value, words.value


def greedy_sketch(words: torch.Tensor, *, n: int, k: int,
                  cand: torch.Tensor | None = None):
    """``k`` steps of the approximate mode's greedy on the card: a
    contiguous (R, W) int32 sketch whose rows ``v < n`` are the nodes',
    and an (n,) bool candidate mask ``cand`` or None -> ``(seeds (k,),
    gains (k,), steps (1,))`` int32, as ``ref.greedy_sketch_ref``."""
    n, k = int(n), int(k)
    _build.check_words(words, "sketch words")
    r, w = words.shape
    if not 1 <= n <= r or n >= (1 << 31) - 1 or k < 1 or w >= 1 << 26:
        raise ValueError(f"need 1 <= n <= {r} rows, n < 2^31 - 1, k >= 1 "
                         f"and fewer than 2^26 words a row, got n {n}, k "
                         f"{k}, {w} words")
    if cand is not None and (cand.device != words.device or
                             cand.dtype != torch.bool or
                             cand.shape != (n,) or
                             not cand.is_contiguous()):
        raise ValueError(f"cand must be a contiguous ({n},) bool tensor on "
                         f"{words.device}")
    index = words.get_device()
    blocks, shared_words = _sketch_grid(index)
    lay = sketch_layout(w, words.data_ptr() % 16 == 0, n=n, blocks=blocks,
                        shared_words=shared_words)
    out = torch.empty(2 * k + 1, dtype=torch.int32, device=words.device)
    scratch = torch.empty(sketch_scratch_bytes(n, w, blocks, shared_words,
                                               lay.form),
                          dtype=torch.uint8, device=words.device)
    err = _SKETCH(words.data_ptr(), n, w, lay.lanes, int(lay.vector),
                  SKETCH_FORMS.index(lay.form), lay.rows, k,
                  None if cand is None else cand.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), index,
                  _build.raw_stream(index))
    _build.raise_on(err, "greedy_sketch")
    LAUNCHES["greedy_sketch"] += 1
    return out[:k], out[k:2 * k], out[2 * k:]
