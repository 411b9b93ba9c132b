"""CUDA wrappers of the CELF lazy greedy (``csrc/celf.cu``):
:func:`celf_select` runs one whole selection, all k seeds, in one
cooperative launch; :func:`celf_eval` scores a batch of candidates against
a packed Covered bitset and :func:`celf_apply` commits a seed into it, one
launch each (the CELF variant's host loop launches them; given row
weights, their weighted forms sum the newly covered rows' weights).  None
replaces a Pallas kernel: the reference runs CELF as a host loop whose
evaluations are XLA (``select_seeds_celf``, ``eval_batch`` and
``apply_seed`` of ``repro.core.coverage``).

Each computes what its plain version in ``kernels/ref.py`` computes
(``celf_select_ref``, ``celf_eval_ref``, ``celf_apply_ref``), byte for
byte.  The wrappers take CUDA tensors only; ``kernels/ops.py`` routes CPU
tensors to the plain versions.  Each checks its inputs, allocates its
outputs and scratch, launches through a :class:`_build.Kernel` on
PyTorch's current stream of the tensors' card (:func:`_build.raw_stream`),
raises on a launch error (a grid that cannot be launched cooperatively
among them: there is no fallback) and adds one to its entry in
:data:`LAUNCHES`.  Nothing is read back, so a call makes no host sync.

:func:`celf_eval` launches once for every :data:`MAX_CANDS` candidates
(once at any ``eval_batch`` up to 2,048); :func:`celf_select` evaluates
larger batches in chunks of that many inside its launch.  Its grid, a
block of 512 threads on each SM, is ``greedy_flat``'s, so
``greedy.grid_barriers`` gives the floor of its time.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.greedy import device_index, row_lanes

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"celf_eval": 0, "celf_apply": 0, "celf_eval[weighted]": 0,
            "celf_apply[weighted]": 0, "celf_select": 0}

# csrc/celf.cu: kMaxCands, the candidates of one celf_eval launch
MAX_CANDS = 2048

_vp, _i32, _i64, _int = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_int)
_EVAL = _build.Kernel("celf", "celf_eval",
                      (_vp, _vp, _vp, _i64, _vp, _i64, _vp, _int, _vp, _vp,
                       _int, _vp))
_APPLY = _build.Kernel("celf", "celf_apply",
                       (_vp, _vp, _vp, _i64, _vp, _i64, _i32, _vp, _vp, _int,
                        _vp))
_SELECT = _build.Kernel("celf", "celf_select",
                        (_vp, _vp, _vp, _i64, _i32, _i64, _i32, _i32, _vp,
                         _i32, _int, _int, _vp, _i64, _vp, _int, _vp))
_SELECT_GRID = _build.Kernel("celf", "celf_select_grid",
                             (_int, ctypes.POINTER(_int),
                              ctypes.POINTER(_i64)))
# csrc/celf.cu: kBins, the bins of one histogram of the radix pick, and
# kList, the keys of a block's top list (batches of c <= LIST are merged
# from the blocks' top lists)
HIST_BINS = 2048
LIST = 32


def _check_pool(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                cov_words: torch.Tensor) -> None:
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
        if t.dim() != 1 or t.shape != flat.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and 1-D of flat's "
                             f"length {flat.shape[0]}, got {tuple(t.shape)}")
    if cov_words.device != dev or cov_words.dtype != torch.int32 or \
            cov_words.dim() != 1 or cov_words.shape[0] < 1 or \
            not cov_words.is_contiguous():
        raise ValueError(f"cov_words must be a contiguous non-empty 1-D int32 "
                         f"tensor on {dev}, got {tuple(cov_words.shape)} "
                         f"{cov_words.dtype} on {cov_words.device}")


def _check_roww(roww, cov_words: torch.Tensor) -> None:
    """Raise unless ``roww`` is None or the (32 * len(cov_words),) float32
    row weights on the pool's card."""
    rows = 32 * cov_words.shape[0]
    if roww is not None and (roww.device != cov_words.device or
                             roww.dtype != torch.float32 or
                             roww.shape != (rows,) or
                             not roww.is_contiguous()):
        raise ValueError(f"roww must be a contiguous ({rows},) float32 "
                         f"tensor on {cov_words.device}")


def celf_eval(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
              cov_words: torch.Tensor, cands: torch.Tensor,
              roww: torch.Tensor | None = None) -> torch.Tensor:
    """Rows not in Covered that hold each candidate, on the card: (t,)
    int32 ``flat`` and ``ids`` and bool ``valid``, (num_rows/32,) int32
    ``cov_words``, (c,) int32/int64 ``cands`` -> (c,) int32; with the
    (num_rows,) float32 row weights ``roww``, the weighted form: the
    float32 sums of their weights, counted under ``celf_eval[weighted]``."""
    _check_pool(flat, ids, valid, cov_words)
    _check_roww(roww, cov_words)
    if cands.device != flat.device or cands.dim() != 1 or \
            cands.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"cands must be a 1-D integer tensor on "
                         f"{flat.device}, got {tuple(cands.shape)} "
                         f"{cands.dtype} on {cands.device}")
    cands = cands.to(torch.int32).contiguous()
    c, nw = cands.shape[0], cov_words.shape[0]
    dev = flat.get_device()
    stream = _build.raw_stream(dev)
    outs = []
    for i0 in range(0, c, MAX_CANDS):
        part = cands[i0:i0 + MAX_CANDS]
        cc = part.shape[0]
        buf = torch.empty(cc * (1 + nw), dtype=torch.int32,
                          device=flat.device)
        err = _EVAL(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                    flat.shape[0], cov_words.data_ptr(), nw, part.data_ptr(),
                    cc, None if roww is None else roww.data_ptr(),
                    buf.data_ptr(), dev, stream)
        _build.raise_on(err, "celf_eval")
        LAUNCHES["celf_eval" if roww is None else "celf_eval[weighted]"] += 1
        outs.append(buf[:cc] if roww is None
                    else buf[:cc].view(torch.float32))
    if len(outs) == 1:
        return outs[0]
    if outs:
        return torch.cat(outs)
    return torch.zeros(0, dtype=torch.int32 if roww is None
                       else torch.float32, device=flat.device)


def celf_apply(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
               cov_words: torch.Tensor, u: int,
               roww: torch.Tensor | None = None) -> torch.Tensor:
    """OR the rows that hold node ``u`` (a host int) into ``cov_words`` in
    place on the card -> the rows that were new, a 0-d int32 tensor; with
    ``roww``, the float32 sum of their weights (``celf_apply[weighted]``)."""
    _check_pool(flat, ids, valid, cov_words)
    _check_roww(roww, cov_words)
    u = int(u)
    if not -(1 << 31) <= u < 1 << 31:
        raise ValueError(f"u must fit int32, got {u}")
    gain = torch.empty(1, dtype=torch.int32, device=flat.device)
    dev = flat.get_device()
    err = _APPLY(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                 flat.shape[0], cov_words.data_ptr(), cov_words.shape[0], u,
                 None if roww is None else roww.data_ptr(),
                 gain.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, "celf_apply")
    if roww is None:
        LAUNCHES["celf_apply"] += 1
        return gain[0]
    LAUNCHES["celf_apply[weighted]"] += 1
    return gain.view(torch.float32)[0]


class SelectLayout(NamedTuple):
    """The form of one :func:`celf_select` launch (``csrc/celf.cu``'s
    ``select_layout``): ``list`` keys in each block's top list
    (:data:`LIST` at c <= LIST, 0 for the radix pick of larger batches or
    where the merge buffers do not fit the shared memory); ``shared``, the
    sketch union in shared memory; ``pool_on_chip``, the block's (node,
    row) pairs in shared memory; ``rows_on_chip``, the sketch rows of the
    block's nodes in shared memory (read once, not once a seed); the
    launch's dynamic shared memory and scratch in bytes."""
    list: int
    shared: bool
    pool_on_chip: bool
    rows_on_chip: bool
    dynamic_bytes: int
    scratch_bytes: int


def select_layout(n: int, num_rows: int, c: int, cols: int, blocks: int,
                  shared_words: int, t: int) -> SelectLayout:
    """:class:`SelectLayout` of a launch over ``t`` elements on a grid of
    ``blocks`` whose dynamic shared memory holds ``shared_words`` words.
    Shared memory: the sketch union (``cols`` rounded up to 4 words), the
    merge buffers (the blocks' lists and half as many again, at least 24
    lists of 8-byte keys), the slice's sel (4 bytes a node, to 16 bytes),
    the block's ceil(t / blocks) pairs (8 bytes each, to 16 bytes) and
    the slice's sketch rows (``cols`` words a node), the last three each
    while it fits.  Scratch: the blocks' records
    (two sweeps x 16 bytes a block), their lists (two sweeps x ``list``
    keys a block), the pairs (8 bytes an element, when not on chip), the
    ring of three pairs of :data:`HIST_BINS`-bin histograms, cand (8 bytes
    a node), two lists of the bitmap words a call set first (8 bytes an
    element each), ub, stamp and sel (4 bytes a node each), the counts of a
    batch (c), the blocks' tie counts, four counters, Covered (num_rows /
    32 words) and the scratch bitmaps (min(c, :data:`MAX_CANDS`) x
    num_rows / 32 words); then, when the sketch union is not in shared
    memory, each block's copy of it from the next 16-byte boundary."""
    limit = 4 * shared_words
    stride = -(-cols // 4) * 4
    lst = LIST if c <= LIST else 0
    merge = 8 * lst * max(blocks + -(-blocks // 2), 24) if lst else 0
    if merge > limit:
        lst, merge = 0, 0
    cov_bytes = 4 * stride if cols else 0
    shared = cov_bytes + merge <= limit
    end = (cov_bytes if shared else 0) + merge
    sel_bytes = -(-4 * -(-n // blocks) // 16) * 16
    if lst and end + sel_bytes <= limit:
        end += sel_bytes
    epb = -(-t // blocks)
    pool_on_chip = bool(lst) and end + 8 * epb <= limit
    end += -(-8 * epb // 16) * 16 if pool_on_chip else 0
    rows_bytes = 4 * -(-n // blocks) * cols
    rows_on_chip = bool(lst) and cols > 0 and end + rows_bytes <= limit
    dynamic = end + (rows_bytes if rows_on_chip else 0)
    nw = num_rows // 32
    end = (32 * blocks + 16 * blocks * lst
           + (8 * t if lst and not pool_on_chip else 0)
           + 4 * 6 * HIST_BINS + 8 * n + 16 * t + 12 * n + 4 * c
           + 4 * blocks + 16 + 4 * nw + 4 * min(c, MAX_CANDS) * nw)
    scratch = end if shared else -(-end // 16) * 16 + 4 * blocks * stride
    return SelectLayout(lst, shared, pool_on_chip, rows_on_chip, dynamic,
                        scratch)


def list_barriers(k: int, calls: int) -> int:
    """Grid barriers of one :func:`celf_select` launch on the top-list path
    that ran ``calls`` eval calls for ``k`` seeds: two in the prologue, two
    an eval call (its sweep's and its evaluation's) and one for each
    seed's last sweep, the one that finds the seed fresh."""
    return 2 + k + 2 * calls


def select_scratch_bytes(n: int, num_rows: int, c: int, cols: int,
                         blocks: int, shared_words: int, t: int) -> int:
    """Scratch of one :func:`celf_select` launch (:func:`select_layout`)."""
    return select_layout(n, num_rows, c, cols, blocks, shared_words,
                         t).scratch_bytes


def select_grid(device) -> tuple[int, int]:
    """``(blocks, shared_words)`` of :func:`celf_select`'s grid on card
    ``device``: a block of 512 threads on each SM, and the widest sketch
    row in words that its shared memory holds (the entry point reads them
    from the card once)."""
    blocks, words = _int(0), _i64(0)
    index = device_index(device)
    _build.raise_on(_SELECT_GRID(index, ctypes.byref(blocks),
                                 ctypes.byref(words)), "celf_select_grid")
    return blocks.value, words.value


def celf_select(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                *, n: int, num_rows: int, k: int, c: int,
                sketch: torch.Tensor | None = None):
    """One CELF selection on the card: (t,) int32 ``flat`` and ``ids`` (row
    ids below ``num_rows``, a multiple of 32) and bool ``valid``, ``c`` (1
    <= c <= n) candidates an exact evaluation, the (R >= n, W) int32
    ``sketch`` or None -> ``(seeds (k,) int32, gains (k,) int32, stats (2,)
    int64, barriers (1,) int64)``: the first three as
    ``ref.celf_select_ref``, then the grid barriers the launch ran."""
    n, num_rows, k, c = int(n), int(num_rows), int(k), int(c)
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
        if t.dim() != 1 or t.shape != flat.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and 1-D of flat's "
                             f"length {flat.shape[0]}, got {tuple(t.shape)}")
    if not (1 <= n < (1 << 31) - 1 and k >= 1 and 1 <= c <= n
            and 32 <= num_rows < 1 << 31 and num_rows % 32 == 0
            and flat.shape[0] < 1 << 31):
        raise ValueError(f"need 1 <= n < 2^31 - 1, k >= 1, 1 <= c <= n, "
                         f"num_rows a multiple of 32 in [32, 2^31) and "
                         f"fewer than 2^31 elements, got n {n}, k {k}, c "
                         f"{c}, num_rows {num_rows}, {flat.shape[0]}")
    cols, lanes, vector, sk_ptr = 0, 1, False, None
    if sketch is not None:
        _build.check_words(sketch, "sketch")
        if sketch.device != dev or sketch.shape[0] < n or \
                sketch.shape[1] >= 1 << 26:
            raise ValueError(f"sketch must lie on {dev} with at least n = "
                             f"{n} rows and fewer than 2^26 words a row, "
                             f"got {tuple(sketch.shape)} on {sketch.device}")
        cols = sketch.shape[1]
        lanes, vector = row_lanes(cols, sketch.data_ptr() % 16 == 0)
        sk_ptr = sketch.data_ptr()
    index = flat.get_device()
    blocks, shared_words = select_grid(index)
    size = select_scratch_bytes(n, num_rows, c, cols, blocks, shared_words,
                                flat.shape[0])
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    out = torch.empty(2 * k + 6, dtype=torch.int32, device=dev)
    err = _SELECT(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                  flat.shape[0], n, num_rows, k, c, sk_ptr, cols, lanes,
                  int(vector), scratch.data_ptr(), size, out.data_ptr(),
                  index, _build.raw_stream(index))
    _build.raise_on(err, "celf_select")
    LAUNCHES["celf_select"] += 1
    counts = out[2 * k:].view(torch.int64)
    return out[:k], out[k:2 * k], counts[:2], counts[2:]
