"""CUDA wrappers of the coverage-sketch kernels (``csrc/sketch.cu``), and
the bucket arithmetic that the fold shares with its plain version.

``sketch_scatter_or`` and ``sketch_union_popcount`` replace the Pallas
kernels of the same names in ``repro.kernels.sketch``;
``sketch_fold_rows`` replaces ``sketch_scatter_or`` on its path, the fold
of a padded batch (the reference builds the batch's pairs in XLA, then
scatters them with that kernel).  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to ``ref.py``.
Each wrapper checks its inputs, calls its C entry point through a
:class:`_build.Kernel` with the card's index and the raw handle of
PyTorch's current stream of that card (:func:`_build.raw_stream`), as
``kernels/bitset.py`` does, raises on a launch error and adds one to its
entry in :data:`LAUNCHES`.

``sketch_fold_rows`` folds the sampler's batch as it lies: a (B, W) view
with any row stride is read in place, and the row ids and buckets are
computed in the launch; given a (2,) int64 ``counts`` on the words' card it
writes the batch's valid lanes and non-empty rows there, so a store's
append is one launch and one host read.  Its buckets are always in range,
so it has no flag.

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
from repro_torch.kernels.bernoulli import MASK32, mul_u32

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"sketch_scatter_or": 0, "sketch_union_popcount": 0,
            "sketch_fold_rows": 0}

MIX_MULTIPLIER = 2654435761    # multiplicative hash of the "mix" bucketing
MODES = ("mod", "mix")

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SCATTER = _build.Kernel("sketch", "sketch_scatter_or",
                         (_vp, _vp, _vp, _i64, _i64, _i64, _vp, _int, _vp))
_UNION = _build.Kernel("sketch", "sketch_union_popcount",
                       (_vp, _vp, _i64, _i64, _vp, _int, _vp))
_FOLD = _build.Kernel("sketch", "sketch_fold_rows",
                      (_vp, _vp, _i64, _vp, _i64, _i64, _i64, _i64,
                       ctypes.c_uint32, ctypes.c_uint32, _int, _vp, _int,
                       _vp))


def bucket_of(row_ids: torch.Tensor, k: int, mode: str = "mod") -> torch.Tensor:
    """Bucket of each RR row id as int32.  Row ids are taken mod 2^32 as
    the reference's uint32 cast does; ``"mix"`` multiplies by 2654435761
    mod 2^32 before the modulo."""
    rid = row_ids.to(torch.int64) & MASK32
    if mode == "mix":
        rid = mul_u32(rid, MIX_MULTIPLIER)
    elif mode != "mod":
        raise ValueError(f"unknown sketch hash mode {mode!r}")
    return (rid % k).to(torch.int32)


def canonical_row_ids(lens: torch.Tensor, row_base: int) -> torch.Tensor:
    """Batch-order RR ids: non-empty rows are numbered from ``row_base``;
    an empty row shares its predecessor's id and adds no pair."""
    return row_base + (lens.to(torch.int64) > 0).cumsum(0) - 1


def frontier_pairs(nodes: torch.Tensor, lens: torch.Tensor,
                   row_ids: torch.Tensor, *, n_rows: int, k: int, mode: str):
    """Flat (v, bucket) int32 pairs of a padded batch: entries past a row's
    length get ``v = n_rows`` (dropped by the scatter)."""
    r, w = nodes.shape
    lens = lens.to(torch.int64).clamp(0, w)
    mask = torch.arange(w, device=nodes.device)[None, :] < lens[:, None]
    b = bucket_of(row_ids, k, mode)[:, None].expand(r, w).reshape(-1)
    v = torch.where(mask, nodes.to(torch.int32), n_rows).reshape(-1)
    return v, b


def check_fold(words: torch.Tensor, nodes: torch.Tensor, lens: torch.Tensor,
               *, k: int, mode: str) -> None:
    """Raise unless ``nodes`` is (B, W), ``lens`` (B,), ``mode`` a
    bucketing and ``k`` in ``[1, 32 x words' columns]`` (both routes)."""
    if nodes.dim() != 2 or lens.shape != (nodes.shape[0],):
        raise ValueError(f"fold wants padded (B, W) nodes and (B,) lengths, "
                         f"got {tuple(nodes.shape)} and {tuple(lens.shape)}")
    if mode not in MODES:
        raise ValueError(f"unknown sketch hash mode {mode!r}")
    if not 1 <= k <= 32 * words.shape[1]:
        raise ValueError(f"k must lie in [1, {32 * words.shape[1]}], got {k}")


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


def sketch_fold_rows(words: torch.Tensor, nodes: torch.Tensor,
                     lens: torch.Tensor, row_base: int, *, k: int, mode: str,
                     counts: torch.Tensor | None = None) -> torch.Tensor:
    """Fold a padded batch into ``words`` in place on the card, as
    ``ref.sketch_fold_rows_ref``: (R, W) contiguous int32 words, (B, W')
    int32/int64 ``nodes`` (any row stride), (B,) integer ``lens``, rows
    numbered from ``row_base`` in batch order; given a (2,) int64
    ``counts`` on the words' card, the batch's valid lanes and non-empty
    rows go there.  Returns ``words``."""
    k = int(k)
    _build.check_words(words)
    check_fold(words, nodes, lens, k=k, mode=mode)
    for t, name in ((nodes, "nodes"), (lens, "lens")):
        if t.device != words.device:
            raise ValueError(f"{name} must lie on the words' device "
                             f"{words.device}, got {t.device}")
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be an integer tensor, got "
                            f"{t.dtype}")
    if counts is not None and (counts.device != words.device
                               or counts.dtype != torch.int64
                               or counts.shape != (2,)
                               or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous (2,) int64 tensor on "
                         f"{words.device}, got {tuple(counts.shape)} "
                         f"{counts.dtype} on {counts.device}")
    b, w = nodes.shape
    if nodes.dtype != torch.int32:
        nodes = nodes.to(torch.int32)
    if w > 1 and nodes.stride(1) != 1:
        nodes = nodes.contiguous()
    if lens.dtype != torch.int32:
        lens = lens.clamp(0, w).to(torch.int32)
    lens = lens.contiguous()
    if b == 0:
        if counts is not None:
            counts.zero_()
        return words
    r, cols = words.shape
    dev = words.get_device()
    err = _FOLD(words.data_ptr(), nodes.data_ptr(), nodes.stride(0),
                lens.data_ptr(), b, w, r, cols, int(row_base) & MASK32, k,
                int(mode == "mix"),
                None if counts is None else counts.data_ptr(), dev,
                _build.raw_stream(dev))
    _build.raise_on(err, "sketch_fold_rows")
    LAUNCHES["sketch_fold_rows"] += 1
    return words
