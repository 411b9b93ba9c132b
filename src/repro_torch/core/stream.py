"""Streaming graph updates: edge deltas, versioned graphs, invalidation
(the reference's ``repro.core.stream``, on the port's CSR graph).

* :func:`apply_edge_deltas` — apply edge adds and removes to a
  :class:`~repro_torch.graph.csr.CSRGraph`.  Added parallels merge through
  :func:`~repro_torch.graph.csr.coalesce_ic` (p' = 1 − ∏(1 − p_i)), which
  is distribution-exact under IC, so the post-delta graph is a plain
  simple CSR that every engine handles.  The result lies on the input
  graph's device, and its offsets, indices, float32 weights and
  ``graph_digest`` equal the reference's.
* :func:`affected_nodes` — the invalidation frontier of a delta batch.  A
  forward edge u→v lives in row v of the *reverse* sampling graph, and an
  RR-BFS only examines the reverse-adjacency rows of the nodes it visits.
  So a pre-delta RR set that contains **no** destination of a changed edge
  examined only unchanged rows: its trajectory has the same probability
  under both graphs, and surviving rows are exact post-delta samples
  conditioned on avoiding the changed rows.
* :class:`VersionedGraph` — a graph with a monotone ``version`` and its
  content :func:`~repro_torch.graph.csr.graph_digest`.

The delta arithmetic is host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import (CSRGraph, coalesce_ic, from_edges,
                                   graph_digest, to_edges)


@dataclass(frozen=True)
class EdgeDeltas:
    """One batch of edge mutations against a CSR graph.

    ``add_src``/``add_dst``/``add_p`` — forward edges to insert with their
    IC probabilities (an edge that already exists merges IC-exactly:
    p' = 1 − (1 − p_old)(1 − p_new)).  ``rm_src``/``rm_dst`` — forward
    edges to delete; removal drops *every* parallel (u, v) edge, i.e. the
    IC-merged edge disappears entirely.
    """
    add_src: np.ndarray
    add_dst: np.ndarray
    add_p: np.ndarray
    rm_src: np.ndarray
    rm_dst: np.ndarray

    @property
    def n_adds(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def n_removes(self) -> int:
        return int(self.rm_src.shape[0])

    def __bool__(self) -> bool:
        return bool(self.n_adds or self.n_removes)


def make_deltas(adds=None, removes=None) -> EdgeDeltas:
    """Normalize delta specs into an :class:`EdgeDeltas`.

    ``adds`` — ``(src, dst, p)`` array triple; ``removes`` — ``(src, dst)``
    array pair.  Either may be ``None`` (empty).
    """
    if adds is None:
        a_s = a_d = np.zeros(0, np.int64)
        a_p = np.zeros(0, np.float32)
    else:
        a_s, a_d, a_p = (np.asarray(adds[0], np.int64).reshape(-1),
                         np.asarray(adds[1], np.int64).reshape(-1),
                         np.asarray(adds[2], np.float32).reshape(-1))
        if not (a_s.shape == a_d.shape == a_p.shape):
            raise ValueError("adds must be aligned (src, dst, p) arrays")
        if a_p.size and ((a_p < 0).any() or (a_p > 1).any()
                         or not np.isfinite(a_p).all()):
            raise ValueError("added edge probabilities must lie in [0, 1]")
    if removes is None:
        r_s = r_d = np.zeros(0, np.int64)
    else:
        r_s, r_d = (np.asarray(removes[0], np.int64).reshape(-1),
                    np.asarray(removes[1], np.int64).reshape(-1))
        if r_s.shape != r_d.shape:
            raise ValueError("removes must be aligned (src, dst) arrays")
    return EdgeDeltas(add_src=a_s, add_dst=a_d, add_p=a_p,
                      rm_src=r_s, rm_dst=r_d)


def as_deltas(deltas) -> EdgeDeltas:
    """Accept an :class:`EdgeDeltas` or an ``(adds, removes)`` pair."""
    if isinstance(deltas, EdgeDeltas):
        return deltas
    adds, removes = deltas
    return make_deltas(adds, removes)


def affected_nodes(deltas: EdgeDeltas) -> np.ndarray:
    """Sorted unique destinations of every changed forward edge — the
    nodes whose reverse-adjacency row the deltas touch.  An RR set
    containing none of them never examined a changed row (see the module
    docstring), so it survives ``IMMSolver.resolve_incremental``
    unchanged."""
    d = as_deltas(deltas)
    return np.unique(np.concatenate([d.add_dst, d.rm_dst]))


def apply_edge_deltas(g: CSRGraph, adds=None, removes=None,
                      *, strict: bool = True) -> CSRGraph:
    """Apply edge adds/removes to ``g``; returns a new coalesced CSR.

    Removal semantics are IC-merged: removing (u, v) deletes *all*
    parallel (u, v) edges.  Additions append and then coalesce —
    re-adding an existing edge strengthens it IC-exactly
    (p' = 1 − (1 − p_old)(1 − p_new)).  With ``strict`` (default), a
    removal naming an absent edge raises ``ValueError`` — a caller
    tracking graph state that disagrees with the graph is a bug worth
    surfacing; ``strict=False`` ignores such removals.
    """
    d = as_deltas((adds, removes)) if not isinstance(adds, EdgeDeltas) \
        else adds
    n = g.n_nodes
    for name, arr in (("add_src", d.add_src), ("add_dst", d.add_dst),
                      ("rm_src", d.rm_src), ("rm_dst", d.rm_dst)):
        if arr.size and ((arr < 0).any() or (arr >= n).any()):
            raise ValueError(f"{name} endpoint out of range [0, {n})")
    src, dst, w = to_edges(g)
    if d.n_removes:
        # pair-encode (u, v) -> u*n + v for a vectorized membership test
        keys = src * n + dst
        rm_keys = np.unique(d.rm_src * n + d.rm_dst)
        if strict:
            present = np.isin(rm_keys, keys)
            if not present.all():
                miss = rm_keys[~present][0]
                raise ValueError(
                    f"cannot remove absent edge "
                    f"({int(miss // n)}, {int(miss % n)}); pass "
                    "strict=False to ignore missing removals")
        keep = ~np.isin(keys, rm_keys)
        src, dst, w = src[keep], dst[keep], w[keep]
    if d.n_adds:
        src = np.concatenate([src, d.add_src])
        dst = np.concatenate([dst, d.add_dst])
        w = np.concatenate([w.astype(np.float32), d.add_p])
    return coalesce_ic(from_edges(src, dst, n, weights=w, sort_rows=True,
                                  device=g.device))


@dataclass(frozen=True)
class VersionedGraph:
    """A graph handle with a monotone version and its content digest."""
    g: CSRGraph
    version: int
    digest: str

    @classmethod
    def wrap(cls, g: CSRGraph, version: int = 0) -> "VersionedGraph":
        return cls(g=g, version=version, digest=graph_digest(g))

    def apply(self, deltas, *, strict: bool = True) -> "VersionedGraph":
        """Monotone step: apply a delta batch, bump the version, re-digest."""
        d = as_deltas(deltas) if not isinstance(deltas, EdgeDeltas) else deltas
        ng = apply_edge_deltas(self.g, d, strict=strict)
        return VersionedGraph(g=ng, version=self.version + 1,
                              digest=graph_digest(ng))


__all__ = ["EdgeDeltas", "VersionedGraph", "affected_nodes",
           "apply_edge_deltas", "as_deltas", "make_deltas"]
