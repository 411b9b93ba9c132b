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

Rows with parallel edges (a multigraph's reverse CSR as it is) need a
chunk dedup, as in the reference (:func:`detect_dedup_mode`): each edge
keeps its own trial, and a destination is accepted at its first live edge
of the row whose visited bit was clear at the row's start, in the order of
those first edges.  ``"segmented"`` serves rows sorted by destination (the
layout of ``repro_torch.graph.csr.reverse``), ``"sort"`` any order; on a
destination-sorted CSR the two give the same bytes.  The engines coalesce
instead (``repro_torch.graph.csr.coalesce_ic``: parallel edges merge to p'
= 1 - prod(1 - p), the same IC law) and pass ``"none"``.

A round is one call of ``kernels.ops.queue_bfs``: on a card one launch of
the CUDA kernel ``csrc/queue.cu``, which draws every lane's row seed and
root and runs the lane to its end; on the CPU the plain version, which
draws them in torch and syncs once a micro-step.  Both return the same
bytes, the roots and each lane's lock-step count.  The round then makes
one host read, of the longest RR set and the most steps together.
``root_tile`` T gives the T lanes of a sample one root (MRIM, ``core/
mrim.py``).

The persistent-lane sampler (paper Alg. 6's worker loop,
:func:`sample_rrsets_refill`) runs ``quota`` rows on fewer lanes, each lane
starting its next row as soon as its last ends, instead of waiting for the
round's longest lane.  Lanes claim row ids as they finish, and row r is the
RR set of row seed ``counter_uniform_u32(round_seed, r)``: the queue
round's lane r at ``batch = quota``.  So, where no lane overflows, the
refill round's rows in row-id order are the queue round's rows, and there
are exactly ``quota`` of them; the reference's lanes race for a global
count in lock step and emit ``quota`` to ``quota + lanes - 1`` sets, each
with the same law.  One round is one call of ``kernels.ops.refill_bfs``
(one launch of ``csrc/refill.cu`` on a card) and one host read.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple, Optional

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
                        dedup: str | None = None, table=None,
                        root_tile: int = 1, row0: int = 0) -> QueueSample:
    """Sample one round of ``batch`` RR sets on the reverse CSR ``g_rev``
    with round seed ``seed32``, on ``g_rev``'s device; roots ∝ the weights
    of the alias ``table`` (``core/roots.py``) when one is given, and lanes
    ``[tT, tT + T)`` on lane tT's root for ``root_tile`` T.  Lane i samples
    row ``row0 + i`` of the round: rank d of a round that D ranks share
    samples rows ``[d·b, (d+1)·b)`` with ``row0 = d·b``.

    ``dedup=None`` runs :func:`detect_dedup_mode` on the host (engines
    coalesce once and pass ``"none"``).  ``"segmented"`` needs rows sorted
    by destination and raises on others, where its runs miss duplicates."""
    n, m = g_rev.n_nodes, g_rev.n_edges
    _check_graph(g_rev, dedup)
    if dedup is None:
        dedup = detect_dedup_mode(g_rev)
    qcap = n if qcap is None else int(qcap)
    queue, lengths, overflowed, lane_steps, roots = ops.queue_bfs(
        g_rev.offsets, g_rev.indices, g_rev.weights, seed32, batch,
        qcap=qcap, ec=ec, table=table, dedup=dedup, root_tile=root_tile,
        row0=row0)
    # the round's one host read
    width, steps = torch.stack((lengths.max().to(torch.int64),
                                lane_steps.max())).tolist()
    return QueueSample(nodes=queue[:, :max(width, 1)], lengths=lengths,
                       roots=roots, overflowed=overflowed, steps=steps)


def _check_graph(g_rev: CSRGraph, dedup: str | None) -> None:
    if g_rev.n_edges >= MAX_EDGES:
        raise ValueError("the counter hash needs m < 2^32 - 2 edges")
    if dedup not in (None, "none", "segmented", "sort"):
        raise ValueError(f"unknown dedup mode {dedup!r}")
    if dedup == "segmented" and not rows_dst_sorted(g_rev):
        raise ValueError("dedup='segmented' needs rows sorted by "
                         "destination; use 'sort'")


def to_lists(sample: QueueSample) -> list[list[int]]:
    nodes = sample.nodes.cpu().numpy()
    lens = sample.lengths.cpu().numpy()
    return [nodes[i, :lens[i]].tolist() for i in range(nodes.shape[0])]


# ---------------------------------------------------------------------------
# Persistent-lane ("refill") sampler: the paper's Alg. 6 worker structure.
# ---------------------------------------------------------------------------

class RefillSample(NamedTuple):
    """One persistent-lane round, in the reference's layout: lane l's sets
    lie one after another in ``flat[l]``, root first, set j of length
    ``lengths[l, j]``, ``n_done[l]`` of them.  The port adds each slot's
    row id and lock-step count (None where the arrays come from
    elsewhere, as the reference's do); ``steps`` is
    :func:`refill_schedule_steps` of those counts."""
    flat: torch.Tensor         # (B, OutCap) int32 — concatenated RR sets
    lengths: torch.Tensor      # (B, S) int32 — per-set lengths
    n_done: torch.Tensor       # (B,) int32 — completed sets per lane
    overflowed: torch.Tensor   # (B,) bool — lane ran out of OutCap
    steps: int
    rows: Optional[torch.Tensor] = None       # (B, S) int32, -1 past n_done
    row_steps: Optional[torch.Tensor] = None  # (B, S) int64


def default_sets_per_lane(quota: int, lanes: int) -> int:
    """The reference's slots a lane: ``max(4 quota // lanes + 4, 4)``."""
    return max(4 * int(quota) // int(lanes) + 4, 4)


def refill_schedule_steps(counts, lanes: int, max_sets: int) -> int:
    """The lock-step micro-steps of the plain version's schedule, from the
    rows' own counts in row-id order: lanes ``0 .. lanes - 1`` start rows
    ``0 .. lanes - 1``, and a lane that finishes a row at step t (after its
    row's count of steps) claims the next row at t, lanes that finish at
    one step in lane order, while it has a free slot; the result is the
    step at which the last row ends."""
    counts = [int(c) for c in counts]
    first = min(int(lanes), len(counts))
    heap = [(counts[r], r) for r in range(first)]     # (free at, lane)
    heapq.heapify(heap)
    done, end = [1] * first, 0
    for r in range(first, len(counts)):
        while heap and done[heap[0][1]] >= max_sets:  # a full lane retires
            end = max(end, heapq.heappop(heap)[0])
        if not heap:
            break
        t, lane = heap[0]
        done[lane] += 1
        heapq.heapreplace(heap, (t + counts[r], lane))
    return max([end] + [t for t, _ in heap])


def _refill_round(g_rev: CSRGraph, batch: int, seed32: int, *, quota: int,
                  out_cap: int, max_sets_per_lane: int | None, ec: int,
                  dedup: str | None, table):
    """One refill round and its one host read -> (RefillSample, the
    longest set's length, :func:`refill_by_row`'s lengths, lanes and
    starts)."""
    _check_graph(g_rev, dedup)
    if dedup is None:
        dedup = detect_dedup_mode(g_rev)
    if max_sets_per_lane is None:
        max_sets_per_lane = default_sets_per_lane(quota, batch)
    flat, lengths, n_done, overflowed, rows, row_steps = ops.refill_bfs(
        g_rev.offsets, g_rev.indices, g_rev.weights, seed32, batch,
        quota=quota, out_cap=out_cap, max_sets=max_sets_per_lane, ec=ec,
        table=table, dedup=dedup)
    by_row = refill_by_row(lengths, rows, row_steps, quota)
    # the round's one host read: the longest set and the rows' counts
    host = torch.cat((by_row[0].max(dim=0, keepdim=True).values
                      if quota else by_row[0, :1], by_row[3])).tolist()
    counts = [c for c in host[1:] if c > 0]       # the emitted rows
    steps = refill_schedule_steps(counts, batch, max_sets_per_lane)
    sample = RefillSample(flat=flat, lengths=lengths, n_done=n_done,
                          overflowed=overflowed, steps=steps, rows=rows,
                          row_steps=row_steps)
    return sample, int(host[0]), by_row[:3]


def sample_rrsets_refill(g_rev: CSRGraph, batch: int, seed32: int, *,
                         quota: int, out_cap: int,
                         max_sets_per_lane: int | None = None,
                         ec: int = EC_DEFAULT, dedup: str | None = None,
                         table=None) -> RefillSample:
    """Persistent-lane sampling with a global quota on ``batch`` lanes:
    rows ``0 .. quota - 1`` of round seed ``seed32`` (the paper's Alg. 6
    worker loop; see the module docstring), each lane's sets in its
    ``out_cap`` row, at most ``max_sets_per_lane`` of them (default
    :func:`default_sets_per_lane`), roots ∝ the weights of ``table`` when
    one is given; ``dedup`` as :func:`sample_rrsets_queue`'s."""
    return _refill_round(g_rev, batch, seed32, quota=quota, out_cap=out_cap,
                         max_sets_per_lane=max_sets_per_lane, ec=ec,
                         dedup=dedup, table=table)[0]


def refill_by_row(lengths: torch.Tensor, rows: torch.Tensor,
                  row_steps: torch.Tensor, quota: int) -> torch.Tensor:
    """A refill round's slots in row-id order: (4, quota) int64 on the
    device, each row's length, lane, start in its lane's row of ``flat``
    and lock-step count (zeros for a row that was not emitted)."""
    b, s = lengths.shape
    dev = lengths.device
    # slot -> row id; an empty slot's writes land in the spare entry quota
    rid = torch.where(rows >= 0, rows, quota).to(torch.int64).reshape(1, -1)
    lens64 = lengths.to(torch.int64)
    values = torch.stack((lens64.reshape(-1),
                          torch.arange(b, device=dev).repeat_interleave(s),
                          (lens64.cumsum(dim=1) - lens64).reshape(-1),
                          row_steps.to(torch.int64).reshape(-1)))
    by_row = torch.zeros(4, quota + 1, dtype=torch.int64, device=dev)
    return by_row.scatter_(1, rid.expand(4, -1), values)[:, :quota]


def refill_rows_by_id(flat: torch.Tensor, by_row: torch.Tensor,
                      width: int):
    """The rows of a refill round in row-id order, padded to ``width``:
    ``by_row`` (3, Q) int64 holds each row's length, lane and start in its
    lane's row of ``flat`` (length 0 for a row that was not emitted) ->
    (nodes (Q, width) int32, zero past each length, lengths (Q,) int32)."""
    out_cap = flat.shape[1]
    lens, lane, start = by_row
    cols = torch.arange(width, device=flat.device)[None, :]
    idx = lane[:, None] * out_cap + (start[:, None] + cols).clamp(
        max=out_cap - 1)
    nodes = flat.reshape(-1)[idx]
    nodes = torch.where(cols < lens[:, None], nodes, 0)
    return nodes.to(torch.int32), lens.to(torch.int32)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def refill_to_lists(sample: RefillSample) -> list[list[int]]:
    """Every emitted set as a list, lane by lane, as the reference's."""
    flat, lengths, n_done = (_host(x) for x in sample[:3])
    out = []
    for b in range(flat.shape[0]):
        off = 0
        for i in range(int(n_done[b])):
            ln = int(lengths[b, i])
            out.append(flat[b, off:off + ln].tolist())
            off += ln
    return out


def refill_to_padded(sample: RefillSample):
    """Host unpack of a refill round, lane by lane as the reference's:
    (nodes (R, W) int64, lengths (R,) int64), R the emitted sets, W the
    longest (at least 1), zero past each length."""
    flat = _host(sample.flat)
    lengths = np.asarray(_host(sample.lengths), np.int64)   # (B, S)
    n_done = np.asarray(_host(sample.n_done), np.int64)     # (B,)
    b, s = lengths.shape
    set_valid = np.arange(s)[None, :] < n_done[:, None]
    if not set_valid.any():
        return np.zeros((0, 1), np.int64), np.zeros(0, np.int64)
    starts = np.concatenate(
        [np.zeros((b, 1), np.int64), lengths.cumsum(axis=1)[:, :-1]], axis=1)
    width = max(int(lengths[set_valid].max()), 1)
    idx = starts[:, :, None] + np.arange(width, dtype=np.int64)[None, None, :]
    rows = np.take_along_axis(flat[:, None, :],
                              np.clip(idx, 0, flat.shape[1] - 1), axis=2)
    col_valid = np.arange(width)[None, None, :] < lengths[:, :, None]
    rows = np.where(col_valid, rows, 0).reshape(b * s, width)
    keep = set_valid.reshape(b * s)
    return rows[keep].astype(np.int64), lengths[set_valid]


def refill_to_padded_device(flat: torch.Tensor, lengths: torch.Tensor,
                            n_done: torch.Tensor):
    """Device unpack of a refill round into fixed-shape rows, lane by lane
    as the reference's: (B, OutCap), (B, S), (B,) -> rows (B*S, OutCap)
    and lengths (B*S,); a slot past its lane's ``n_done`` is a row of
    length 0 (padding, which the store drops).  No host read."""
    b, s = lengths.shape
    out_cap = flat.shape[1]
    dev = flat.device
    set_valid = torch.arange(s, device=dev)[None, :] < n_done[:, None]
    lens = torch.where(set_valid, lengths, 0)
    starts = lengths.cumsum(dim=1) - lengths
    idx = starts[:, :, None].to(torch.int64) + torch.arange(
        out_cap, device=dev)[None, None, :]
    rows = flat[:, None, :].expand(b, s, out_cap).gather(
        2, idx.clamp(0, out_cap - 1))
    col_valid = torch.arange(out_cap, device=dev)[None, None, :] < \
        lens[:, :, None]
    rows = torch.where(col_valid, rows, 0)
    return rows.reshape(b * s, out_cap), lens.reshape(b * s)
