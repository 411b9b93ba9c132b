"""Row seeds and uniform RR roots from the counter hash.

Row r of a round with seed ``round_seed`` has the 32-bit row seed
``counter_uniform_u32(round_seed, r)`` (:func:`row_seeds`).  A row's root
is ``(counter_uniform_u32(row_seed, 0xFFFFFFFF) * n) >> 32`` in int64:
the top 32 bits of a 32x32-bit product, an integer map of the
hash onto ``[0, n)`` (bias below n / 2^32).  The counter 0xFFFFFFFF is
reserved for the root; edge trials use the edge index, so graphs need
``m < 2^32 - 1``.  Weighted roots (alias tables) come with weighted
problems (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bernoulli import counter_uniform_u32

ROOT_COUNTER = 0xFFFFFFFF


def row_seeds(seed32: int, batch: int, device) -> torch.Tensor:
    """(batch,) int64 row seeds of one round."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)
    return counter_uniform_u32(seed32, rows)


def draw_roots(row_seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) int64 row seeds -> (B,) int32 roots, uniform over [0, n)."""
    u = counter_uniform_u32(row_seeds, ROOT_COUNTER)
    return ((u * n) >> 32).to(torch.int32)
