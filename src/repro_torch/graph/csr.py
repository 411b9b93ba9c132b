"""Compressed-sparse-row graph on a torch device (paper §3.2, Fig. 1).

Same layout as ``repro.graph.csr``: row offsets (n+1,) int32, column
indices (m,) int32 and edge weights (m,) float32, in input order.
Construction runs on the host in numpy (the arrays are identical to the
reference's); the finished arrays live on the graph's device.  Functions
that derive a graph from a graph (:func:`reverse`, :func:`coalesce_ic`, the
weight schemes) keep the input's device.

RR-set sampling runs a randomized BFS on the *transposed* graph (paper
§3.1), so :func:`reverse` builds the transpose with p_uv carried onto the
reversed edge (v -> u).
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class CSRGraph(NamedTuple):
    """CSR adjacency. ``offsets[i]:offsets[i+1]`` indexes node i's out-edges."""

    offsets: torch.Tensor  # (n+1,) int32
    indices: torch.Tensor  # (m,)  int32
    weights: torch.Tensor  # (m,)  float32

    @property
    def n_nodes(self) -> int:
        return int(self.offsets.shape[0]) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "CSRGraph":
        dev = resolve_device(device)
        return CSRGraph(self.offsets.to(dev), self.indices.to(dev),
                        self.weights.to(dev))

    def numpy(self):
        """(offsets, indices, weights) as host numpy arrays."""
        return tuple(t.cpu().numpy() for t in self)


def _from_numpy(offsets, indices, weights, device) -> CSRGraph:
    dev = resolve_device(device)
    return CSRGraph(
        offsets=torch.tensor(np.asarray(offsets, np.int32), device=dev),
        indices=torch.tensor(np.asarray(indices, np.int32), device=dev),
        weights=torch.tensor(np.asarray(weights, np.float32), device=dev))


def from_edges(src, dst, n: int, weights=None, sort: bool = True,
               sort_rows: bool = False, *, device="cuda") -> CSRGraph:
    """Build CSR from an edge list (host numpy, then placed on ``device``).

    ``sort=True`` groups edges by source (stable: input order is kept within
    a row).  ``sort_rows=True`` also orders each row by destination, so
    parallel edges become adjacent.  ``sort=False`` requires input already
    grouped by source (``src`` non-decreasing): offsets come from
    ``np.bincount(src)`` while indices stay in input order, so ungrouped
    input would pair one row's offsets with another row's destinations.  It
    raises ``ValueError`` instead.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    m = src.shape[0]
    if weights is None:
        weights = np.ones(m, dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    if m and (src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n):
        raise ValueError("edge endpoint out of range")
    if sort_rows and m:
        order = np.lexsort((dst, src))
        src, dst, weights = src[order], dst[order], weights[order]
    elif sort and m:
        order = np.argsort(src, kind="stable")
        src, dst, weights = src[order], dst[order], weights[order]
    elif m and not (np.diff(src) >= 0).all():
        raise ValueError(
            "from_edges(sort=False) requires source-grouped input (src "
            "non-decreasing); pass sort=True to group arbitrary edge lists")
    counts = np.bincount(src, minlength=n).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return _from_numpy(offsets, dst, weights, device)


def to_edges(g: CSRGraph):
    """Return (src, dst, w) numpy edge arrays."""
    offsets, indices, w = g.numpy()
    offsets = offsets.astype(np.int64)
    n = offsets.shape[0] - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    return src, indices.astype(np.int64), w


def reverse(g: CSRGraph) -> CSRGraph:
    """Transpose: edge (u,v,w) becomes (v,u,w).  RR sampling runs on this.
    Rows come back destination-sorted."""
    src, dst, w = to_edges(g)
    return from_edges(dst, src, g.n_nodes, weights=w, sort_rows=True,
                      device=g.device)


def coalesce_ic(g: CSRGraph) -> CSRGraph:
    """Merge parallel edges under the IC equivalence p' = 1 - ∏(1 - p_i).

    k parallel (u, v) edges activate exactly like one edge with p', so the
    merge is distribution-exact for every IC sampler.  Afterwards rows are
    simple and destination-sorted: within a row every destination is
    distinct, which the queue sampler relies on.  Returns ``g`` unchanged
    when it is already simple and destination-sorted.
    """
    offs, idx, w = g.numpy()
    offs = offs.astype(np.int64)
    idx = idx.astype(np.int64)
    w = w.astype(np.float64)
    n = len(offs) - 1
    if idx.size == 0:
        return g
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(offs))
    if rows_dst_sorted(g):
        r, d, p = row_of, idx, w
    else:
        order = np.lexsort((idx, row_of))
        r, d, p = row_of[order], idx[order], w[order]
    head = np.ones(len(r), bool)
    head[1:] = (r[1:] != r[:-1]) | (d[1:] != d[:-1])
    if head.all() and r is row_of:
        return g
    starts = np.nonzero(head)[0]
    # p = 1 makes log1p(-p) singular: clip for the product, then force
    # those groups to exactly 1
    has_one = np.maximum.reduceat(p, starts) >= 1.0
    lg = np.log1p(-np.clip(p, 0.0, 1.0 - 1e-12))
    merged_p = np.where(has_one, 1.0, -np.expm1(np.add.reduceat(lg, starts)))
    return from_edges(r[starts], d[starts], n,
                      weights=merged_p.astype(np.float32), sort_rows=True,
                      device=g.device)


def rows_dst_sorted(g: CSRGraph) -> bool:
    """Is every CSR row non-decreasing in destination?"""
    offs, idx, _ = g.numpy()
    offs = offs.astype(np.int64)
    idx = idx.astype(np.int64)
    if idx.size <= 1:
        return True
    nd = np.diff(idx) >= 0
    row_starts = offs[1:-1]
    inner = row_starts[(row_starts > 0) & (row_starts < idx.size)]
    nd[inner - 1] = True                     # decreases across rows are fine
    return bool(nd.all())


def graph_digest(g: CSRGraph) -> str:
    """Content hash: sha256 over dtype + shape + raw bytes of
    offsets/indices/weights.  Equal to ``repro.graph.csr.graph_digest`` of
    the same arrays, so both packages name a graph the same way."""
    h = hashlib.sha256(b"CSRGraph:")
    for name, a in zip(("offsets", "indices", "weights"), g.numpy()):
        h.update(name.encode())
        h.update(b"=")
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
        h.update(b";")
    return h.hexdigest()


def degrees(g: CSRGraph):
    """(out_degree, in_degree) as numpy int64 arrays."""
    offsets, indices, _ = g.numpy()
    offsets = offsets.astype(np.int64)
    out_deg = np.diff(offsets)
    in_deg = np.bincount(indices.astype(np.int64),
                         minlength=offsets.shape[0] - 1)
    return out_deg, in_deg
