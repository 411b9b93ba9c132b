"""Queue-based RR-set sampler: the gIM decomposition (paper Alg. 3/6).

B lanes sample B RR sets at once.  Each lane keeps one queue row: in BFS the
dequeued prefix *is* the RR set, so gIM's shared queue, reservoir and RR_tmp
collapse into one (B, qcap) array plus (head, tail) cursors; visited sets
are packed bits, (B, ceil(n/32)) int32.  A lane whose queue would pass
``qcap`` keeps the first entries and raises its ``overflowed`` flag
(``qcap`` defaults to n, which never overflows).

Random numbers come from the counter hash of
:mod:`repro_torch.kernels.bernoulli`, not from a generator with state:

* row r of a round with seed ``round_seed`` has the 32-bit row seed
  ``counter_uniform_u32(round_seed, r)``
  (:func:`repro_torch.core.roots.row_seeds`);
* its root is ``(counter_uniform_u32(row_seed, 0xFFFFFFFF) * n) >> 32``,
  or with an alias table that bucket or its alias
  (:func:`repro_torch.core.roots.draw_roots`);
* edge e of the coalesced reverse CSR is live for that row iff
  ``float32(counter_uniform_u32(row_seed, e)) * 2^-32 < w[e]``, the trial
  of ``repro.kernels.ref.bernoulli_edges_ref``.

Why the RR set depends on nothing but (row seed, graph): whether an edge is
live is a pure function of (row seed, edge index).  Each node enters the
queue once (the visited bit is set when it is enqueued) and is expanded
once, so each of its edges is tried once.  The queue therefore ends
holding exactly the nodes reachable from the root over live edges.  That
set does not depend on the chunk width EC, on the order in which the queue
is drained, or on which lane ran the row, as long as the lane did not
overflow.  The visit order does not depend on EC either: the queue is
FIFO and each row's accepted destinations are appended in edge order.

The sampler serves coalesced graphs (``repro_torch.graph.csr.coalesce_ic``):
rows are simple, so the destinations inside one chunk are distinct and
every accepted node of a chunk is new to the lane.  Graphs with parallel
edges need the reference's ``segmented``/``sort`` chunk dedup, which is not
ported yet (:func:`detect_dedup_mode` tells them apart).

A round is one call of ``kernels.ops.queue_bfs``: on a card one launch of
the CUDA kernel ``csrc/queue.cu``, which draws every lane's row seed and
root and runs the lane to its end; on the CPU the plain version, which
draws them in torch and syncs once a micro-step.  Both return the same
bytes, the roots and each lane's lock-step count.  The round then makes
one host read, of the longest RR set and the most steps together.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, rows_dst_sorted
from repro_torch.core.roots import MAX_EDGES
from repro_torch.kernels import ops
from repro_torch.kernels.bernoulli import counter_uniform_u32

EC_DEFAULT = 128   # edge-chunk width (the reference's EC)


class QueueSample(NamedTuple):
    """One round.  ``steps`` is the lock-step count at chunk width EC: the
    most, over the lanes, of the sum over a lane's dequeued nodes of
    ``max(1, ceil(deg / EC))``.  The plain version runs that many
    micro-steps; the kernel, which ranks a row a block-wide tile at a
    time, computes the same count, so it is equal on a card and on the
    CPU."""
    nodes: torch.Tensor       # (B, W) int32 — visit-order node ids per lane
    lengths: torch.Tensor     # (B,) int32 — RR-set sizes (W = max length)
    roots: torch.Tensor       # (B,) int32
    overflowed: torch.Tensor  # (B,) bool — lane hit qcap (RR set truncated)
    steps: int                # lock-step micro-steps (see above)


def round_seed(seed: int, t: int) -> int:
    """32-bit seed of sampling round ``t`` of a solver seeded with ``seed``."""
    return int(counter_uniform_u32(seed, t))


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


def sample_rrsets_queue(g_rev: CSRGraph, batch: int, seed32: int, *,
                        qcap: int | None = None, ec: int = EC_DEFAULT,
                        dedup: str | None = None,
                        table=None) -> QueueSample:
    """Sample one round of ``batch`` RR sets on the reverse CSR ``g_rev``
    with round seed ``seed32``, on ``g_rev``'s device; roots ∝ the weights
    of the alias ``table`` (``core/roots.py``) when one is given.

    ``dedup=None`` runs :func:`detect_dedup_mode` on the host (engines
    coalesce once and pass ``"none"``); any other mode raises, since only
    simple rows are served yet (ROADMAP Queue 1 item 3)."""
    n, m = g_rev.n_nodes, g_rev.n_edges
    if m >= MAX_EDGES:
        raise ValueError("the counter hash needs m < 2^32 - 2 edges")
    if dedup is None:
        dedup = detect_dedup_mode(g_rev)
    if dedup != "none":
        raise NotImplementedError(
            f"dedup mode {dedup!r} is not ported (ROADMAP Queue 1 item 3); "
            "coalesce the graph with coalesce_ic first")
    qcap = n if qcap is None else int(qcap)
    queue, lengths, overflowed, lane_steps, roots = ops.queue_bfs(
        g_rev.offsets, g_rev.indices, g_rev.weights, seed32, batch,
        qcap=qcap, ec=ec, table=table)
    # the round's one host read
    width, steps = torch.stack((lengths.max().to(torch.int64),
                                lane_steps.max())).tolist()
    return QueueSample(nodes=queue[:, :max(width, 1)], lengths=lengths,
                       roots=roots, overflowed=overflowed, steps=steps)


def to_lists(sample: QueueSample) -> list[list[int]]:
    nodes = sample.nodes.cpu().numpy()
    lens = sample.lengths.cpu().numpy()
    return [nodes[i, :lens[i]].tolist() for i in range(nodes.shape[0])]
