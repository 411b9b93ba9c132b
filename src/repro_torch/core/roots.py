"""Row seeds and RR roots from the counter hash: uniform, or in proportion
to node weights through a Walker alias table.

Row r of a round with seed ``round_seed`` has the 32-bit row seed
``counter_uniform_u32(round_seed, r)`` (:func:`row_seeds`); a block of
lanes that starts at row ``row0`` of a larger round (a rank's share of a
sharded round) draws rows ``row0``, ``row0 + 1``, ...  A row's
bucket is ``(counter_uniform_u32(row_seed, 0xFFFFFFFF) * n) >> 32`` in
int64: the top 32 bits of a 32x32-bit product, an integer map of the hash
onto ``[0, n)`` (bias below n / 2^32).  Without a table the bucket is the
root.  With a table (weighted IM, :func:`build_alias_table`) a second
draw on the counter 0xFFFFFFFE decides between the bucket and its alias:
the root is the bucket iff ``float32(counter_uniform_u32(row_seed,
0xFFFFFFFE)) * 2^-32 < prob[bucket]``, else ``alias[bucket]``, so roots
come out ∝ the weights.  The two counters are reserved for the roots; edge
trials use the edge index, so graphs need ``m < 2^32 - 2``.

The reference draws its roots with threefry keys, so the two packages'
roots agree in distribution, not draw for draw; the alias tables they
build from one weight vector agree byte for byte.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bernoulli import counter_uniform_u32

ROOT_COUNTER = 0xFFFFFFFF
ALIAS_COUNTER = 0xFFFFFFFE
# edges take the counters below the reserved ones
MAX_EDGES = ALIAS_COUNTER
_U01 = 2.0 ** -32


class AliasTable(NamedTuple):
    """Walker alias table: ``prob[i]`` is bucket i's acceptance
    probability, ``alias[i]`` the node drawn when it is refused."""
    prob: torch.Tensor     # (n,) float32 in [0, 1]
    alias: torch.Tensor    # (n,) int32


def alias_arrays(weights) -> tuple[np.ndarray, np.ndarray]:
    """Walker's O(n) construction from non-negative weights on the host:
    ``(prob (n,) float32, alias (n,) int32)``, the reference's
    ``repro.core.roots.build_alias_table`` byte for byte (float64
    arithmetic, the same list pops, the same cleanup, cast at the end)."""
    w = np.asarray(weights, np.float64)
    if w.ndim != 1:
        raise ValueError("root weights must be a 1-D vector")
    if (w < 0).any() or not np.isfinite(w).all() or w.sum() <= 0:
        raise ValueError("root weights must be non-negative, finite, and "
                         "not all zero")
    n = w.shape[0]
    p = w * (n / w.sum())
    prob = np.ones(n)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] -= 1.0 - p[s]
        (small if p[l] < 1.0 else large).append(l)
    # rounding leftovers: both lists drain to probability-1 buckets
    for i in large + small:
        prob[i] = 1.0
        alias[i] = i
    return prob.astype(np.float32), alias.astype(np.int32)


def build_alias_table(weights, device="cuda") -> AliasTable:
    """:func:`alias_arrays` as tensors on ``device``."""
    prob, alias = alias_arrays(weights)
    dev = resolve_device(device)
    return AliasTable(prob=torch.from_numpy(prob).to(dev),
                      alias=torch.from_numpy(alias).to(dev))


def row_seeds(seed32: int, batch: int, device, row0: int = 0) -> torch.Tensor:
    """(batch,) int64 row seeds of rows ``row0 .. row0 + batch - 1`` of a
    round: lane i draws ``counter_uniform_u32(seed32, row0 + i)`` (row
    numbers taken mod 2^32).  ``row0 = 0`` is a whole round; rank d of D
    ranks that share a round of D·b rows samples ``row0 = d·b``."""
    rows = torch.arange(batch, dtype=torch.int64, device=device) + int(row0)
    return counter_uniform_u32(seed32, rows)


def draw_roots(row_seeds: torch.Tensor, n: int,
               table: AliasTable | None = None) -> torch.Tensor:
    """(B,) int64 row seeds -> (B,) int32 roots: uniform over [0, n), or
    ∝ the weights of ``table``, an :class:`AliasTable` or a ``(prob,
    alias)`` pair (see the module docstring)."""
    u = counter_uniform_u32(row_seeds, ROOT_COUNTER)
    idx = (u * n) >> 32
    if table is None:
        return idx.to(torch.int32)
    prob, alias = table
    h = counter_uniform_u32(row_seeds, ALIAS_COUNTER)
    accept = h.to(torch.float32) * _U01 < prob[idx]
    return torch.where(accept, idx,
                       alias[idx].to(torch.int64)).to(torch.int32)
