"""Packing helpers: the rank-to-position search of the pool's append and
the int32 bit words of visited sets and bit matrices."""
from __future__ import annotations

import numpy as np
import torch


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
