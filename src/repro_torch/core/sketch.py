"""Packed coverage sketches of the approximate (pool-free) mode: the part of
``repro.core.sketch`` that the approximate solve runs.

Every node v keeps a k-bucket occupancy bitmap: bucket ``h(row_id) mod k``
is set iff some RR row containing v hashed there.  The bitmaps are packed
into an (R, k/32) int32 matrix (bit b of word w is bucket w*32 + b; bit 31
makes a word negative), the layout of the Covered bitset and the bit
matrix.  A union is a bitwise OR and its occupancy a popcount.

* The fold of a batch (:func:`fold_frontier_packed`, the stores' append)
  is ``kernels.ops.sketch_fold_rows``, in place on the store's words: on
  the card one launch that numbers the rows, buckets them and commits each
  lane with ``atomicOr``; on the CPU the batch's (node, bucket) pairs
  through the plain dedup-and-add scatter-OR.  A batch under arbitrary row
  ids (:func:`fold_frontier_rows`) commits its pairs through
  ``kernels.ops.sketch_scatter_or``.
* The sweep (:func:`union_gains`) scores every node at once through
  ``kernels.ops.sketch_union_popcount``: ``Δocc(v | S) = popcount(sketch_v
  | cov) − popcount(cov)``, the second term through
  ``kernels.ops.popcount_words``.  New buckets need new rows, so Δocc never
  exceeds v's exact marginal coverage.  The store's greedy
  (``core/coverage.py::select_seeds_sketch``) runs all its sweeps inside
  one ``kernels.ops.greedy_sketch`` launch instead.
* With ``"mod"`` bucketing and at most k rows the bucketing is injective
  and Δocc *is* the exact marginal gain.

Cardinality comes from linear counting, ``k · ln(k / (k − occ))``, with a
z-sigma relative error bound (Whang et al.); these are host-side numpy, as
in the reference, so both packages give the same floats.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops as kops
# the bucket arithmetic lives beside the fold kernel that computes it
from repro_torch.kernels.sketch import bucket_of, frontier_pairs


def resolve_sketch_k(k: int) -> int:
    """Round the bucket count up to a whole number of 32-bit words."""
    if k <= 0:
        raise ValueError("sketch_k must be positive")
    return ((k + 31) // 32) * 32


def scatter_or_bits(words: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """``words[v] |= 1 << b`` on a copy of ``words``; pairs with ``v``
    outside ``[0, R)`` are dropped.  The reference returns a new array, and
    so does this."""
    return kops.sketch_scatter_or(words.clone(), v, b)


def fold_frontier_rows(words: torch.Tensor, nodes: torch.Tensor,
                       lens: torch.Tensor, row_ids: torch.Tensor, *, k: int,
                       mode: str, bad: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Fold a padded batch into ``words`` in place, row i under the global
    RR id ``row_ids[i]``; rows of length 0 are padding.  A bucket outside
    the sketch raises, or sets the (1,) int32 flag ``bad`` when one is
    given (``kernels.ops.sketch_scatter_or``).  Returns ``words``."""
    v, b = frontier_pairs(nodes, lens, row_ids, n_rows=words.shape[0], k=k,
                          mode=mode)
    return kops.sketch_scatter_or(words, v, b, bad)


def fold_frontier_packed(words: torch.Tensor, nodes: torch.Tensor,
                         lens: torch.Tensor, row_base: int, *, k: int,
                         mode: str, counts: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Fold a padded batch into ``words`` in place under canonical
    batch-order row ids (``row_base`` = rows folded before this batch), as
    :func:`fold_frontier_rows` would with those ids, through
    ``kernels.ops.sketch_fold_rows``: one launch on the card, which reads
    the batch as it lies and numbers its rows itself.  A (2,) int64
    ``counts`` gets the batch's valid lanes and non-empty rows.  Returns
    ``words``."""
    return kops.sketch_fold_rows(words, nodes, lens, row_base, k=k,
                                 mode=mode, counts=counts)


def sketch_packed_from_flat(flat: torch.Tensor, ids: torch.Tensor,
                            valid: torch.Tensor, *, n_rows: int, k: int,
                            mode: str) -> torch.Tensor:
    """Packed (n_rows, k/32) words of an existing flat pool (element i is
    node ``flat[i]`` in row ``ids[i]``); invalid elements are dropped."""
    words = torch.zeros((n_rows, k // 32), dtype=torch.int32,
                        device=flat.device)
    v = torch.where(valid, flat.to(torch.int32), n_rows)
    return kops.sketch_scatter_or(words, v, bucket_of(ids, k, mode))


def pack_sketch(occ: torch.Tensor, *, words: int) -> torch.Tensor:
    """(R, k) bool occupancy -> (R, k/32) int32 packed words through the
    ``pack_bits`` kernel (LSB first, the layout of every packed word here).
    """
    if occ.shape[1] != words * 32:
        raise ValueError("occupancy width must be words * 32")
    return kops.pack_bits(occ)


def union_row(cov_words: torch.Tensor, sk_words: torch.Tensor,
              u) -> torch.Tensor:
    """``cov | sketch[u]``: fold one selected seed into the union sketch."""
    return cov_words | sk_words[u]


def union_gains(sk_words: torch.Tensor, cov_words: torch.Tensor) -> torch.Tensor:
    """Δocc(v | S) for every sketch row, in one kernel sweep: (R,) int32."""
    base = kops.popcount_words(cov_words.reshape(1, -1)).sum(
        dtype=torch.int32)
    return kops.sketch_union_popcount(sk_words, cov_words) - base


def linear_count(occupied, k: int):
    """Linear-counting cardinality estimate from bucket occupancy, capped at
    ``k · ln(k)`` for a full row."""
    occ = np.asarray(occupied, dtype=np.float64)
    occ = np.clip(occ, 0.0, k - 1.0)
    est = k * np.log(k / (k - occ))
    return np.where(np.asarray(occupied) >= k, k * np.log(k), est)


def linear_count_saturated(occupied, k: int):
    """:func:`linear_count` plus a per-entry ``saturated`` flag (a full row
    carries no information beyond its ``k · ln(k)`` ceiling)."""
    sat = np.asarray(occupied) >= k
    return linear_count(occupied, k), sat


def linear_count_rel_error(est, k: int, *, z: float = 3.0):
    """z-sigma relative error of the linear-counting estimate at load
    ``t = est / k``: ``z · sqrt(e^t − t − 1) / (t · sqrt(k))``."""
    t = np.maximum(np.asarray(est, dtype=np.float64) / k, 1e-9)
    se = np.sqrt(np.maximum(np.expm1(t) - t, 0.0)) / (t * np.sqrt(k))
    return z * se


def auto_sketch_k(eps: float, n: int, *, z: float = 3.0) -> int:
    """Bucket count whose z-sigma error at load 1 is ``eps / 2``:
    ``k >= (2 z sqrt(e − 2) / eps)^2``, clamped to ``[64, n]`` and rounded
    to whole words."""
    if not (0.0 < eps < 1.0):
        raise ValueError("eps must lie in (0, 1)")
    c = math.sqrt(math.e - 2.0)
    k = math.ceil((2.0 * z * c / eps) ** 2)
    k = max(64, min(k, max(int(n), 64)))
    return resolve_sketch_k(k)
