"""Packing helpers: padded-row packing of masks (``pack_rows`` on the
host, ``pack_rows_device`` on a tensor's device), the rank-to-position
search of the pool's append and the int32 bit words of visited sets and
bit matrices."""
from __future__ import annotations

import numpy as np
import torch


def pack_rows(values, mask):
    """Left-compact the masked elements of each row into a padded matrix
    (host numpy, as ``repro.core.packing.pack_rows``).

    values, mask: (B, C).  Returns (rows (B, W), lengths (B,) int64) where W
    is the largest row count (at least 1); column order is kept and the
    tail is zero.
    """
    mask = np.asarray(mask, bool)
    values = np.asarray(values)
    lens = mask.sum(axis=1).astype(np.int64)
    width = max(int(lens.max()) if lens.size else 0, 1)
    out = np.zeros((mask.shape[0], width), values.dtype)
    rank = mask.cumsum(axis=1) - 1
    r, c = np.nonzero(mask)
    out[r, rank[r, c]] = values[r, c]
    return out, lens


def pack_rows_device(values: torch.Tensor, mask: torch.Tensor,
                     width: int | None = None):
    """Tensor twin of :func:`pack_rows` on the mask's device, as
    ``repro.core.packing.pack_rows_device``.

    The output width is ``width`` (default: the mask's column count, the
    reference's static width); rows are left-compacted in column order and
    the tail is zero.  A row with more than ``width`` elements keeps its
    first ``width``.  Returns (rows (B, width), lengths (B,) int32).
    """
    b, c = mask.shape
    width = c if width is None else int(width)
    m32 = mask.to(torch.int32)
    lens = m32.sum(dim=1, dtype=torch.int32)
    rank = m32.cumsum(dim=1, dtype=torch.int32) - 1
    dest = torch.where(mask & (rank < width), rank, width).to(torch.int64)
    out = torch.zeros(b, width + 1, dtype=values.dtype, device=mask.device)
    out.scatter_(1, dest, values.expand(b, c))       # column width: dropped
    return out[:, :width], lens


def rank_positions(csum: torch.Tensor, width: int, size: int) -> torch.Tensor:
    """Positions of the 1st..``width``-th set elements of a flat mask, given
    its inclusive prefix sum ``csum`` (length ``size``).

    A vectorized lower-bound binary search (log2(size) gather steps, no
    scatter and no host sync), as ``repro.core.packing.rank_positions``.
    Entries beyond the true count converge to ``size - 1``; callers mask
    by count.
    """
    dev = csum.device
    tgt = torch.arange(1, width + 1, dtype=csum.dtype, device=dev)
    lo = torch.zeros(width, dtype=torch.int64, device=dev)
    hi = torch.full((width,), size - 1, dtype=torch.int64, device=dev)
    for _ in range(max((max(size, 2) - 1).bit_length(), 1)):
        mid = (lo + hi) >> 1
        go_right = csum[mid] < tgt
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo.clamp(0, size - 1)


def bit_values(device) -> torch.Tensor:
    """(32,) int32: the value of a word with only bit b set (bit 31 is
    negative).  Packed words are int32, bit b of word w is item w*32 + b."""
    bits = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    return torch.from_numpy(bits.view(np.int32).copy()).to(device)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
