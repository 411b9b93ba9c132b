"""Dense-frontier ("GraphBLAS") RR-set engine, the port of
``repro.core.dense``.

Level-synchronous BFS over *all* edges at every level, batched over B lanes
(one RR set per lane).  This is the formulation the paper argues against on
GPUs (§3.1: small frontiers starve SIMT warps); it trades one host sync per
BFS level for a sweep of every edge at every level.  The frontier is a set
(a mask), so a node enters it at most once and each reverse edge is tried
at most once per lane: the duplicate-frontier inflation 1-(1-p)^2 of §3.1
cannot occur.

Two samplers, each with the random-number rule of its reference function:

* :func:`sample_rrsets_dense` / :func:`_dense_round` (the ``dense`` engine)
  keep the queue sampler's per-row contract (:mod:`.rrset`): row r's seed
  is ``counter_uniform_u32(seed32, r)``, its root comes from
  ``draw_roots`` (∝ the node weights with an alias table), and edge e is
  live iff ``bernoulli_edges(w, row_seeds)[r, e]``.  Each node enters the frontier once, so each edge is
  tried once and the trial need not depend on the level: one (B, m) trial
  launch per round serves every level.  On a coalesced graph the rows
  therefore hold, set for set, what ``QueueEngine.sample(seed32)`` gives
  (dense rows are ascending).
* :func:`sample_rrsets_dense_packed` keeps the reference's bit-packed
  sampler bit for bit: visited and frontier sets are (B, ceil(n/32)) int32
  words kept by the ``pack_bits`` and ``frontier_update`` kernels (the
  reference's ``bitset_andnot`` and ``bitset_or`` in one launch),
  and lane b at level l draws its trials with the seed
  ``(base_seed * 2654435761 + b * 40503 + l) mod 2^32`` over the edge index
  of the (uncoalesced) reverse CSR.  Only the roots differ: the reference
  draws them with ``jax.random.randint``, this module with ``draw_roots``.
  Given the reference's roots, :func:`_sample_dense_packed` returns its
  words, Occur, sizes and roots exactly.

The scatter by destination (``new.at[:, edge_dst].max(live)`` in the
reference) writes True at the live (lane, destination) positions: every
write stores the same value, so the result does not depend on order.  Each
level reads ``frontier.any()`` and the live positions on the host: two
device syncs per level.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.core.packing import pack_rows, pack_rows_device
from repro_torch.core.roots import MAX_EDGES, draw_roots, row_seeds
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bernoulli import MASK32

_KNUTH = 2654435761     # base-seed multiplier of the packed sampler
_LANE_MUL = 40503       # lane multiplier of the packed sampler


class DenseSample(NamedTuple):
    membership: torch.Tensor  # (B, n) bool — RR-set membership per lane
    roots: torch.Tensor       # (B,) int32
    levels: int               # BFS levels executed


def _edge_src(g: CSRGraph) -> torch.Tensor:
    """(m,) int32 source node of every CSR edge, on the graph's device."""
    deg = g.offsets.to(torch.int64).diff()
    nodes = torch.arange(g.n_nodes, dtype=torch.int32, device=g.device)
    return torch.repeat_interleave(nodes, deg, output_size=g.n_edges)


def _check_edges(g: CSRGraph) -> None:
    if g.n_edges >= MAX_EDGES:
        raise ValueError("the counter hash needs m < 2^32 - 2 edges")


def _scatter_live(live: torch.Tensor, edge_dst: torch.Tensor,
                  width: int) -> torch.Tensor:
    """(B, width) bool: True at (b, edge_dst[e]) for every live (b, e)."""
    lane, e = live.nonzero(as_tuple=True)
    new = torch.zeros(live.shape[0], width, dtype=torch.bool,
                      device=live.device)
    new[lane, edge_dst[e]] = True
    return new


def _sample_dense(edge_src, edge_dst, keep, roots, *, n: int):
    """Frontier BFS of every lane to its end over the live edges ``keep``
    ((B, m) bool).  Returns (membership (B, n) bool, levels)."""
    batch = roots.shape[0]
    lane = torch.arange(batch, device=roots.device)
    src, dst = edge_src.to(torch.int64), edge_dst.to(torch.int64)
    visited = torch.zeros(batch, n, dtype=torch.bool, device=roots.device)
    visited[lane, roots.to(torch.int64)] = True
    frontier = visited.clone()
    levels = 0
    while bool(frontier.any()):
        live = frontier.index_select(1, src)           # (B, m)
        live &= keep
        new = _scatter_live(live, dst, n)
        del live
        new &= ~visited
        visited |= new
        frontier = new
        levels += 1
    return visited, levels


def sample_rrsets_dense(g_rev: CSRGraph, batch: int, seed32: int, *,
                        edge_src=None, table=None) -> DenseSample:
    """Sample one round of ``batch`` RR sets on the reverse CSR with round
    seed ``seed32``, on ``g_rev``'s device, roots ∝ the weights of the
    alias ``table`` when one is given.  Returns bool membership."""
    _check_edges(g_rev)
    n = g_rev.n_nodes
    if edge_src is None:
        edge_src = _edge_src(g_rev)
    seeds = row_seeds(seed32, batch, g_rev.device, row0=0)
    roots = draw_roots(seeds, n, table)
    keep = kops.bernoulli_edges(g_rev.weights, seeds)  # (B, m), every level
    membership, levels = _sample_dense(edge_src, g_rev.indices, keep, roots,
                                       n=n)
    return DenseSample(membership=membership, roots=roots, levels=levels)


def _dense_round(g_rev: CSRGraph, edge_src, seed32: int, batch: int,
                 table=None):
    """One round of the ``dense`` engine: trials, BFS and the padded rows.
    Rows hold ascending node ids and are trimmed to the longest set.
    Returns (nodes, lengths, roots, overflowed, levels)."""
    s = sample_rrsets_dense(g_rev, batch, seed32, edge_src=edge_src,
                            table=table)
    width = max(int(s.membership.sum(dim=1).max()), 1)
    cols = torch.arange(g_rev.n_nodes, dtype=torch.int32, device=g_rev.device)
    nodes, lens = pack_rows_device(cols, s.membership, width)
    overflow = torch.zeros(batch, dtype=torch.bool, device=g_rev.device)
    return nodes, lens, s.roots, overflow, s.levels


def membership_to_lists(membership) -> list[list[int]]:
    """(B, n) bool membership -> python RR-set lists (tests, oracles)."""
    mem = np.asarray(_host(membership), bool)
    return [np.nonzero(row)[0].tolist() for row in mem]


def membership_to_padded(membership):
    """(B, n) bool membership -> (nodes (B, W), lengths (B,)) on the host.
    W is the largest set size; rows are ascending node ids."""
    mem = np.asarray(_host(membership), bool)
    cols = np.broadcast_to(np.arange(mem.shape[1], dtype=np.int64),
                           mem.shape)
    return pack_rows(cols, mem)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# Bit-packed variant: visited and frontier are (B, ceil(n/32)) int32 words
# kept by the bit-set kernels; the edge trials come from the Bernoulli kernel,
# one (B, m) launch per level.
# ---------------------------------------------------------------------------

class PackedSample(NamedTuple):
    words: torch.Tensor   # (B, W) int32 packed membership
    occur: torch.Tensor   # (32W,) int32 per-node occurrence counts
    sizes: torch.Tensor   # (B,) int32 RR-set sizes
    roots: torch.Tensor   # (B,) int32
    levels: int           # BFS levels executed


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words -> (B, 32W) bool, bit j of word w at column
    w*32 + j (a (B, W, 32) temporary, never a (B, m) word gather)."""
    b, w = words.shape
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shift) & 1).to(torch.bool).reshape(b, w * 32)


def _sample_dense_packed(g_rev: CSRGraph, roots: torch.Tensor,
                         base_seed: int = 0) -> PackedSample:
    """The packed BFS of ``roots.shape[0]`` lanes from the given roots (the
    core of :func:`sample_rrsets_dense_packed`); lane b is the b-th root."""
    _check_edges(g_rev)
    n, dev = g_rev.n_nodes, g_rev.device
    n_pad = ((n + 31) // 32) * 32
    src = _edge_src(g_rev).to(torch.int64)
    dst = g_rev.indices.to(torch.int64)
    roots = roots.to(device=dev, dtype=torch.int32)
    batch = roots.shape[0]
    lane = torch.arange(batch, dtype=torch.int64, device=dev)
    visited0 = torch.zeros(batch, n_pad, dtype=torch.bool, device=dev)
    visited0[lane, roots.to(torch.int64)] = True
    visited = kops.pack_bits(visited0)
    del visited0
    frontier = visited
    base = ((int(base_seed) & MASK32) * _KNUTH) & MASK32
    lane_seed = base + lane * _LANE_MUL
    level = 0
    while bool((frontier != 0).any()):
        keep = kops.bernoulli_edges(g_rev.weights,
                                    (lane_seed + level) & MASK32)
        live = _unpack_bits(frontier).index_select(1, src)   # (B, m)
        live &= keep
        del keep
        new_bool = _scatter_live(live, dst, n_pad)
        del live
        # visited is updated in place; on the first level frontier *is*
        # visited, which _unpack_bits above has already read
        frontier = kops.frontier_update(kops.pack_bits(new_bool), visited)
        level += 1
    occur = kops.occur_from_bitset(visited)
    sizes = kops.popcount_words(visited).sum(dim=1, dtype=torch.int32)
    return PackedSample(words=visited, occur=occur, sizes=sizes, roots=roots,
                        levels=level)


def sample_rrsets_dense_packed(g_rev: CSRGraph, batch: int, seed32: int,
                               base_seed: int = 0,
                               table=None) -> PackedSample:
    """Sample ``batch`` RR sets with the packed sampler on ``g_rev``'s
    device: roots from ``draw_roots(row_seeds(seed32, batch), n, table)``,
    edge trials from ``base_seed`` as the reference draws them."""
    seeds = row_seeds(seed32, batch, g_rev.device, row0=0)
    return _sample_dense_packed(
        g_rev, draw_roots(seeds, g_rev.n_nodes, table), base_seed)
