"""Queue-based RR-set sampler — the gIM decomposition (paper Alg. 3/6) in
plain PyTorch.

B lanes sample B RR sets at once.  Each lane keeps one queue row: in BFS the
dequeued prefix *is* the RR set, so gIM's shared queue, reservoir and RR_tmp
collapse into one (B, qcap) array plus (head, tail) cursors.  One micro-step
handles EC edges of each lane's current node (the paper's
``for i = tx; i < deg; i += N_th`` loop); visited sets are packed bits,
(B, ceil(n/32)) int32.  A lane whose queue would pass ``qcap`` keeps the
first entries and raises its ``overflowed`` flag (``qcap`` defaults to n,
which never overflows).

Random numbers come from the counter hash of
:mod:`repro_torch.kernels.bernoulli`, not from a generator with state:

* row r of a round with seed ``round_seed`` has the 32-bit row seed
  ``counter_uniform_u32(round_seed, r)``;
* its root is ``(counter_uniform_u32(row_seed, 0xFFFFFFFF) * n) >> 32``
  (:func:`repro_torch.core.roots.draw_roots`);
* edge e of the coalesced reverse CSR is live for that row iff
  ``float32(counter_uniform_u32(row_seed, e)) * 2^-32 < w[e]``, the trial
  of ``repro.kernels.ref.bernoulli_edges_ref``.

Why the RR set depends on nothing but (row seed, graph): whether an edge is
live is a pure function of (row seed, edge index).  Each node enters the
queue once (the visited bit is set when it is enqueued) and is expanded
once, so each of its edges is tried once.  The queue therefore ends
holding exactly the nodes reachable from the root over live edges.  That
set does not depend on EC, on the order in which the queue is drained, or
on which lane ran the row, as long as the lane did not overflow.  A CUDA
sampler that keeps this contract gives bit-identical RR sets as sets.

The sampler serves coalesced graphs (``repro_torch.graph.csr.coalesce_ic``):
rows are simple, so the destinations inside one chunk are distinct and
every accepted node of a chunk is new to the lane.  Graphs with parallel
edges need the reference's ``segmented``/``sort`` chunk dedup, which is not
ported yet (:func:`detect_dedup_mode` tells them apart).

The host loop reads ``(qhead < qtail).any()`` once per micro-step: one
device sync per step.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, rows_dst_sorted
from repro_torch.core.packing import bit_values
from repro_torch.core.roots import ROOT_COUNTER, draw_roots
from repro_torch.kernels.bernoulli import counter_uniform_u32

EC_DEFAULT = 128   # edge-chunk width (the reference's EC)
_U01 = 2.0 ** -32


class QueueSample(NamedTuple):
    nodes: torch.Tensor       # (B, W) int32 — visit-order node ids per lane
    lengths: torch.Tensor     # (B,) int32 — RR-set sizes (W = max length)
    roots: torch.Tensor       # (B,) int32
    overflowed: torch.Tensor  # (B,) bool — lane hit qcap (RR set truncated)
    steps: int                # micro-steps executed


def round_seed(seed: int, t: int) -> int:
    """32-bit seed of sampling round ``t`` of a solver seeded with ``seed``."""
    return int(counter_uniform_u32(seed, t))


def row_seeds(seed32: int, batch: int, device) -> torch.Tensor:
    """(batch,) int64 row seeds of one round."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)
    return counter_uniform_u32(seed32, rows)


def detect_dedup_mode(g_rev: CSRGraph) -> str:
    """Which in-chunk dedup the sampler needs for this graph (host check,
    as ``repro.core.rrset.detect_dedup_mode``): ``"none"`` when no row
    repeats a destination, ``"segmented"`` for repeats in destination-sorted
    rows, ``"sort"`` for repeats in unsorted rows."""
    offs, idx, _ = g_rev.numpy()
    offs = offs.astype(np.int64)
    idx = idx.astype(np.int64)
    if idx.size <= 1:
        return "none"
    if rows_dst_sorted(g_rev):
        eq = np.diff(idx) == 0
        inner = offs[1:-1]
        inner = inner[(inner > 0) & (inner < idx.size)]
        eq[inner - 1] = False                    # row boundaries don't count
        return "segmented" if eq.any() else "none"
    row_of = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    order = np.lexsort((idx, row_of))
    si, sr = idx[order], row_of[order]
    dup = (np.diff(si) == 0) & (np.diff(sr) == 0)
    return "sort" if dup.any() else "none"


def _sample_queue(offsets, indices, weights, seeds, roots, *, qcap: int,
                  ec: int):
    """BFS of every lane to its end.  Returns (nodes, lengths, overflowed,
    steps); ``nodes`` is trimmed to the longest RR set."""
    dev = roots.device
    batch = roots.shape[0]
    n = offsets.shape[0] - 1
    m = indices.shape[0]
    n_words = (n + 31) // 32
    bitval = bit_values(dev)
    offsets = offsets.to(torch.int64)
    lane = torch.arange(batch, device=dev)
    # one spare column absorbs the writes of entries that are not enqueued
    queue = torch.zeros(batch, qcap + 1, dtype=torch.int32, device=dev)
    queue[:, 0] = roots
    r64 = roots.to(torch.int64)
    visited = torch.zeros(batch, n_words, dtype=torch.int32, device=dev)
    visited[lane, r64 >> 5] = bitval[r64 & 31]
    qhead = torch.zeros(batch, dtype=torch.int64, device=dev)
    qtail = torch.ones(batch, dtype=torch.int64, device=dev)
    ecur = torch.zeros(batch, dtype=torch.int64, device=dev)
    overflow = torch.zeros(batch, dtype=torch.bool, device=dev)
    arange_ec = torch.arange(ec, dtype=torch.int64, device=dev)
    seeds = seeds[:, None]
    steps = 0
    while bool((qhead < qtail).any()):
        active = qhead < qtail
        u = queue.gather(1, qhead.clamp(max=qcap - 1)[:, None])[:, 0].long()
        s = offsets[u]
        deg = offsets[u + 1] - s
        pos = ecur[:, None] + arange_ec[None, :]                 # (B, EC)
        valid = (pos < deg[:, None]) & active[:, None]
        eidx = (s[:, None] + pos).clamp(0, max(m - 1, 0))
        nbr = indices[eidx]                                      # (B, EC)
        u01 = counter_uniform_u32(seeds, eidx).to(torch.float32) * _U01
        keep = (u01 < weights[eidx]) & valid                     # live edge
        nbr64 = nbr.to(torch.int64)
        word = nbr64 >> 5
        seen = (visited.gather(1, word) >> (nbr & 31)) & 1
        accept = keep & (seen == 0)
        # atomic_enqueue (Alg. 3 L21): rank-ordered append at the tail
        rank = accept.cumsum(dim=1) - 1
        cnt = rank[:, -1] + 1
        take = torch.minimum(cnt, (qcap - qtail).clamp(min=0))
        sel = accept & (rank < take[:, None])
        queue.scatter_(1, torch.where(sel, qtail[:, None] + rank, qcap), nbr)
        visited.scatter_add_(1, torch.where(sel, word, 0),
                             torch.where(sel, bitval[nbr64 & 31], 0))
        overflow |= cnt > take
        qtail = qtail + take
        # advance the edge cursor / pop the node (Alg. 3 L12)
        ecur2 = ecur + ec
        row_done = ecur2 >= deg
        qhead = torch.where(active & row_done, qhead + 1, qhead)
        ecur = torch.where(active & ~row_done, ecur2, 0)
        steps += 1
    width = max(int(qtail.max()), 1)
    return (queue[:, :width], qtail.to(torch.int32), overflow, steps)


def sample_rrsets_queue(g_rev: CSRGraph, batch: int, seed32: int, *,
                        qcap: int | None = None, ec: int = EC_DEFAULT,
                        dedup: str | None = None) -> QueueSample:
    """Sample one round of ``batch`` RR sets on the reverse CSR ``g_rev``
    with round seed ``seed32``, on ``g_rev``'s device.

    ``dedup=None`` runs :func:`detect_dedup_mode` on the host (engines
    coalesce once and pass ``"none"``); any other mode raises, since only
    simple rows are served yet (ROADMAP Queue 1 item 3)."""
    n, m = g_rev.n_nodes, g_rev.n_edges
    if m >= ROOT_COUNTER:
        raise ValueError("the counter hash needs m < 2^32 - 1 edges")
    if dedup is None:
        dedup = detect_dedup_mode(g_rev)
    if dedup != "none":
        raise NotImplementedError(
            f"dedup mode {dedup!r} is not ported (ROADMAP Queue 1 item 3); "
            "coalesce the graph with coalesce_ic first")
    qcap = n if qcap is None else int(qcap)
    seeds = row_seeds(seed32, batch, g_rev.device)
    roots = draw_roots(seeds, n)
    nodes, lengths, overflowed, steps = _sample_queue(
        g_rev.offsets, g_rev.indices, g_rev.weights, seeds, roots,
        qcap=qcap, ec=ec)
    return QueueSample(nodes=nodes, lengths=lengths, roots=roots,
                       overflowed=overflowed, steps=steps)


def to_lists(sample: QueueSample) -> list[list[int]]:
    nodes = sample.nodes.cpu().numpy()
    lens = sample.lengths.cpu().numpy()
    return [nodes[i, :lens[i]].tolist() for i in range(nodes.shape[0])]
