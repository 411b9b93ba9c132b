"""Packed coverage sketches of the approximate (pool-free) mode: the part of
``repro.core.sketch`` that the approximate solve runs.

Every node v keeps a k-bucket occupancy bitmap: bucket ``h(row_id) mod k``
is set iff some RR row containing v hashed there.  The bitmaps are packed
into an (R, k/32) int32 matrix (bit b of word w is bucket w*32 + b; bit 31
makes a word negative), the layout of the Covered bitset and the bit
matrix.  A union is a bitwise OR and its occupancy a popcount.

* The fold (:func:`fold_frontier_rows`) commits a batch's raw (node,
  bucket) pairs through ``kernels.ops.sketch_scatter_or``, in place on the
  store's words: the CUDA kernel's ``atomicOr`` on the card, the plain
  dedup-and-add version on the CPU.
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
from repro_torch.kernels.bernoulli import MASK32, mul_u32

_KNUTH = 2654435761    # multiplicative hash of the "mix" bucketing


def resolve_sketch_k(k: int) -> int:
    """Round the bucket count up to a whole number of 32-bit words."""
    if k <= 0:
        raise ValueError("sketch_k must be positive")
    return ((k + 31) // 32) * 32


def bucket_of(row_ids: torch.Tensor, k: int, mode: str = "mod") -> torch.Tensor:
    """Bucket of each RR row id as int32.  Row ids are taken mod 2^32 as
    the reference's uint32 cast does; ``"mix"`` multiplies by 2654435761
    mod 2^32 before the modulo."""
    rid = row_ids.to(torch.int64) & MASK32
    if mode == "mix":
        rid = mul_u32(rid, _KNUTH)
    elif mode != "mod":
        raise ValueError(f"unknown sketch hash mode {mode!r}")
    return (rid % k).to(torch.int32)


def scatter_or_bits(words: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """``words[v] |= 1 << b`` on a copy of ``words``; pairs with ``v``
    outside ``[0, R)`` are dropped.  The reference returns a new array, and
    so does this."""
    return kops.sketch_scatter_or(words.clone(), v, b)


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


def canonical_row_ids(lens: torch.Tensor, row_base: int) -> torch.Tensor:
    """Batch-order RR ids: non-empty rows are numbered from ``row_base``;
    an empty row shares its predecessor's id and adds no pair."""
    return row_base + (lens.to(torch.int64) > 0).cumsum(0) - 1


def fold_frontier_packed(words: torch.Tensor, nodes: torch.Tensor,
                         lens: torch.Tensor, row_base: int, *, k: int,
                         mode: str, bad: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """:func:`fold_frontier_rows` with canonical batch-order row ids
    (``row_base`` = rows folded before this batch)."""
    return fold_frontier_rows(words, nodes, lens,
                              canonical_row_ids(lens, row_base), k=k,
                              mode=mode, bad=bad)


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
