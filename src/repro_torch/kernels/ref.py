"""Plain PyTorch versions of the kernels: the CPU path of every wrapper and
the yardstick the CUDA kernels are held to on the card.

Packed bit words are int32 tensors (bit b of word w is node ``w*32 + b``);
bit 31 makes a word negative.  ``>>`` on int32 sign-extends, but
``(x >> b) & 1`` still reads bit b for every b in [0, 32), so the bit
reads below need no widening.  The SWAR popcount, the hash and the
scatter-OR's commit run in int64 with ``& 0xFFFFFFFF``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.packing import bit_values, to_int32_bits
from repro_torch.core.roots import draw_roots, row_seeds
from repro_torch.core.variant import VariantScan, row_weights, weighted_occur
from repro_torch.kernels.bernoulli import MASK32, counter_uniform_u32, mul_u32
from repro_torch.kernels.sketch import (canonical_row_ids, check_fold,
                                        frontier_pairs)

# rows per block of the Occur histograms: a (block, W, 32) bit tensor stays
# near 2^28 elements whatever the matrix size
_OCCUR_ELEMS = 1 << 28
# seeds per block of the edge trials: each int64 temporary of the hash
# stays near 2^25 elements
_TRIAL_ELEMS = 1 << 25
_U01 = 2.0 ** -32


def counter_uniform_u32_ref(seed, counter):
    return counter_uniform_u32(seed, counter)


def bernoulli_edges_ref(weights: torch.Tensor, seeds) -> torch.Tensor:
    """One Bernoulli(``weights[e]``) trial per edge and seed:
    ``keep[b, e] = float32(counter_uniform_u32(seeds[b], e)) * 2^-32 <
    weights[e]``.

    ``weights`` is (E,) float32; ``seeds`` an int (-> (E,) bool) or a (B,)
    integer tensor (-> (B, E) bool, what ``jax.vmap(bernoulli_edges)``
    computes), taken mod 2^32.
    """
    w = weights.to(torch.float32)
    e = torch.arange(w.shape[0], dtype=torch.int64, device=w.device)
    if not isinstance(seeds, torch.Tensor) or seeds.dim() == 0:
        return counter_uniform_u32(seeds, e).to(torch.float32) * _U01 < w
    seeds = seeds.to(device=w.device, dtype=torch.int64)
    out = torch.empty(seeds.shape[0], w.shape[0], dtype=torch.bool,
                      device=w.device)
    step = max(1, _TRIAL_ELEMS // max(w.shape[0], 1))
    for b0 in range(0, seeds.shape[0], step):
        bits = counter_uniform_u32(seeds[b0:b0 + step, None], e[None, :])
        out[b0:b0 + step] = bits.to(torch.float32) * _U01 < w
    return out


def trial_threshold_ref(weights: torch.Tensor) -> torch.Tensor:
    """The least ``t`` in ``[0, 2^32]`` with ``float32(t) * 2^-32 >=
    weights[e]``, as int64: trial ``h`` keeps edge ``e`` iff ``h < t``,
    the same as :func:`bernoulli_edges_ref`'s float compare, since the
    conversion (round to nearest even) and the exact scale are
    non-decreasing in ``h``.  The formula of ``csrc/bernoulli.cu``'s
    ``trial_limit``, which keeps ``t - 1``:

    - ``w <= 0``, ``-0.0`` and NaN keep nothing (``t = 0``); ``w > 1`` and
      ``+inf`` keep everything (``t = 2^32``);
    - else ``W = w * 2^32`` is exact (a denormal ``w`` becomes normal);
      up to ``2^24`` every integer is a float32, so ``t = ceil(W)``;
    - above, ``t`` is the midpoint between ``W`` and the float32 below it
      (half its gap, which is half the gap above at a power of two), plus
      one when ``W``'s mantissa is odd: a tie rounds to the even one.  At
      ``w = 1.0``, ``t = 2^32 - 128``.
    """
    w = weights.to(torch.float32)
    inside = (w > 0) & (w <= 1)
    big = torch.where(inside, w, torch.ones_like(w)) * 2.0 ** 32
    bits = big.view(torch.int32).to(torch.int64) & MASK32
    exp = (bits >> 23) - 127
    frac = bits & 0x7FFFFF
    half_gap = torch.ones_like(bits) << torch.where(
        frac != 0, exp - 24, exp - 25).clamp(min=0)
    whole = (frac | 0x800000) << (exp - 23).clamp(min=0)
    t = torch.where(big <= 2.0 ** 24, torch.ceil(big).to(torch.int64),
                    whole - half_gap + (frac & 1))
    t = torch.where(w > 1, 1 << 32, t)
    return torch.where(w > 0, t, 0)


def first_occurrence_ref(nbr: torch.Tensor, cand: torch.Tensor,
                         mode: str) -> torch.Tensor:
    """The reference's ``_first_occurrence`` (paper §3.1's duplicate
    hazard), bit for bit: ``accept[b, j]`` iff chunk position j is the
    first of lane b's candidates ``cand`` with destination ``nbr[b, j]``.

    ``"none"`` returns ``cand`` (simple rows).  ``"segmented"`` counts only
    adjacent duplicates (destination-sorted rows): a candidate is kept when
    it starts its run of equal destinations or no earlier position of its
    run is a candidate, by a segmented inclusive prefix-OR in log-step
    (Hillis-Steele) shifts.  ``"sort"`` takes any order: a stable sort of
    the candidates' destinations (others sort last under the int32 maximum)
    and a neighbour difference.  ``nbr`` (B, EC) integers, ``cand`` (B, EC)
    bool -> (B, EC) bool."""
    if mode == "none":
        return cand
    b, ec = cand.shape
    dev = cand.device
    if mode == "segmented":
        runhead = torch.ones_like(cand)
        runhead[:, 1:] = nbr[:, 1:] != nbr[:, :-1]
        val, seg = cand, runhead
        d = 1
        while d < ec:
            val_in = torch.zeros_like(val)
            val_in[:, d:] = val[:, :-d]
            seg_in = torch.ones_like(seg)
            seg_in[:, d:] = seg[:, :-d]
            val = val | (val_in & ~seg)
            seg = seg | seg_in
            d *= 2
        prev = torch.zeros_like(val)          # the OR up to j - 1
        prev[:, 1:] = val[:, :-1]
        return cand & (runhead | ~prev)
    if mode != "sort":
        raise ValueError(f"unknown dedup mode {mode!r}")
    sentinel = (1 << 31) - 1
    key = torch.where(cand, nbr.to(torch.int64), sentinel)
    skey, spos = torch.sort(key, dim=1, stable=True)
    first = torch.ones(b, ec, dtype=torch.bool, device=dev)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    out = torch.zeros_like(cand)
    return out.scatter_(1, spos, first & (skey != sentinel))


def _bfs_step(offsets, indices, weights, seeds, out, visited, head, tail,
              ecur, active, cap, arange_ec, bitval, dedup):
    """One lock-step micro-step of the queue BFS over the lanes' rows of
    ``out`` ((B, C + 1) int32, the last column a spare): each ``active``
    lane dequeues from ``out[b, head[b]]`` and handles ``ec`` edges of that
    node from ``ecur[b]``; accepted destinations go to ``out[b, tail[b]
    + rank]`` while below ``cap`` and get their visited bit.  Returns
    ``(head, tail, ecur, over)``, ``over`` the lanes that accepted a node
    they had no room for."""
    m = indices.shape[0]
    c = out.shape[1] - 1
    u = out.gather(1, head.clamp(max=c - 1)[:, None])[:, 0].long()
    s = offsets[u]
    deg = offsets[u + 1] - s
    pos = ecur[:, None] + arange_ec[None, :]                     # (B, EC)
    valid = (pos < deg[:, None]) & active[:, None]
    eidx = (s[:, None] + pos).clamp(0, max(m - 1, 0))
    nbr = indices[eidx]                                          # (B, EC)
    u01 = counter_uniform_u32(seeds, eidx).to(torch.float32) * _U01
    keep = (u01 < weights[eidx]) & valid                         # live edge
    nbr64 = nbr.to(torch.int64)
    word = nbr64 >> 5
    seen = (visited.gather(1, word) >> (nbr & 31)) & 1
    # the first live edge a destination in the chunk (paper §3.1)
    accept = first_occurrence_ref(nbr, keep & (seen == 0), dedup)
    # atomic_enqueue (Alg. 3 L21): rank-ordered append at the tail
    rank = accept.cumsum(dim=1) - 1
    cnt = rank[:, -1] + 1
    take = torch.minimum(cnt, (cap - tail).clamp(min=0))
    sel = accept & (rank < take[:, None])
    out.scatter_(1, torch.where(sel, tail[:, None] + rank, c), nbr)
    visited.scatter_add_(1, torch.where(sel, word, 0),
                         torch.where(sel, bitval[nbr64 & 31], 0))
    # advance the edge cursor / pop the node (Alg. 3 L12)
    ecur2 = ecur + arange_ec.shape[0]
    row_done = ecur2 >= deg
    head = torch.where(active & row_done, head + 1, head)
    ecur = torch.where(active & ~row_done, ecur2, 0)
    return head, tail + take, ecur, cnt > take


def queue_bfs_ref(offsets: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor, seeds: torch.Tensor,
                  roots: torch.Tensor, *, qcap: int, ec: int,
                  dedup: str = "none"):
    """One round of gIM's queue sampler (paper Alg. 3/6), every lane's BFS
    to its end, in lock-step micro-steps, from given row seeds and roots
    (:func:`queue_round_ref` draws them, as ``csrc/queue.cu`` does).

    Lane b keeps one queue row: in BFS the dequeued prefix *is* the RR set.
    One micro-step handles ``ec`` edges of each lane's current node (the
    paper's ``for i = tx; i < deg; i += N_th`` loop): lane b's edge e is
    live iff ``float32(counter_uniform_u32(seeds[b], e)) * 2^-32 <
    weights[e]``, and a live edge whose destination's visited bit is clear
    is a candidate.  ``dedup`` (``core/rrset.py::detect_dedup_mode``) keeps
    the first candidate of each destination in the chunk
    (:func:`first_occurrence_ref`), so the accepted destinations of a chunk
    are distinct: ``"none"`` for simple rows, ``"segmented"`` for rows
    sorted by destination, ``"sort"`` for any.  The accepted destinations
    are appended in edge order (Alg. 3 L21's rank-ordered
    ``atomic_enqueue``); of them only the first ``qcap - tail`` are taken
    and get their visited bit, and the lane's ``overflowed`` flag is set
    when any is not.  The host reads ``(qhead < qtail).any()`` once a
    micro-step.

    ``offsets`` (n+1,), ``indices`` (m,) and ``weights`` (m,) are a reverse
    CSR; ``seeds`` (B,) int64 row seeds, ``roots`` (B,) int32.  Returns
    ``(queue (B, qcap) int32, lengths (B,) int32, overflowed (B,) bool,
    steps (B,) int64)``: ``queue[b, :lengths[b]]`` in visit order, zeros
    after it; ``steps[b]`` the micro-steps lane b was active, i.e. the sum
    over its dequeued nodes of ``max(1, ceil(deg / ec))``.
    """
    dev = roots.device
    batch = roots.shape[0]
    n = offsets.shape[0] - 1
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
    steps = torch.zeros(batch, dtype=torch.int64, device=dev)
    arange_ec = torch.arange(ec, dtype=torch.int64, device=dev)
    seeds = seeds[:, None]
    while bool((qhead < qtail).any()):
        active = qhead < qtail
        qhead, qtail, ecur, over = _bfs_step(
            offsets, indices, weights, seeds, queue, visited, qhead, qtail,
            ecur, active, qcap, arange_ec, bitval, dedup)
        overflow |= over
        steps += active
    return queue[:, :qcap], qtail.to(torch.int32), overflow, steps


def queue_round_ref(offsets: torch.Tensor, indices: torch.Tensor,
                    weights: torch.Tensor, seed32: int, batch: int, *,
                    qcap: int, ec: int, table=None, dedup: str = "none",
                    root_tile: int = 1, row0: int = 0):
    """One round of the queue sampler with round seed ``seed32``: the plain
    version of ``csrc/queue.cu``.  The ``batch`` row seeds of rows ``row0
    ..`` (``core/roots.py::row_seeds``) and roots (``draw_roots``, ∝ the
    weights of the alias ``table``, a ``(prob, alias)`` pair, when one is
    given; lane b's root drawn from the row seed of lane ``b - b mod
    root_tile``), then :func:`queue_bfs_ref` on them with ``dedup``.
    Returns ``queue_bfs_ref``'s four tensors and the (B,) int32 roots."""
    seeds = row_seeds(seed32, batch, offsets.device, row0)
    lane = torch.arange(batch, device=offsets.device)
    roots = draw_roots(seeds[lane - lane % int(root_tile)],
                       offsets.shape[0] - 1, table)
    return (*queue_bfs_ref(offsets, indices, weights, seeds, roots,
                           qcap=qcap, ec=ec, dedup=dedup), roots)


def refill_round_ref(offsets: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor, seed32: int, lanes: int, *,
                     quota: int, out_cap: int, max_sets: int, ec: int,
                     table=None, dedup: str = "none"):
    """The plain version of ``csrc/refill.cu``: the persistent-lane loop
    (paper Alg. 6) in lock-step micro-steps, the reference's
    ``_sample_refill`` with rows claimed by id.

    At the start lanes 0, 1, ... claim rows 0, 1, ...; at the end of each
    micro-step the lanes that finished a set and have a free slot claim the
    next row ids in lane order.  A claim at or past ``quota`` ends the lane.
    Row r starts from the root of row seed ``counter_uniform_u32(seed32,
    r)`` (:func:`queue_round_ref`'s lane r, through ``table`` when one is
    given) at the lane's tail in its ``out_cap`` row, or, with no room
    left, sets ``overflowed`` and ends the lane; then one micro-step of
    :func:`queue_bfs_ref` a step with cap ``out_cap`` and ``dedup``.  A set
    that accepts a node it has no room for sets ``overflowed`` and ends the
    lane without being emitted.  A finished set goes to the lane's next
    slot: its length, its row id and its lock-step count.  The host reads
    whether any lane is in a set once a micro-step.

    Returns :func:`kernels.refill.refill_bfs`'s six tensors (``flat`` zero
    past each lane's emitted sets) and the loop's micro-steps, which equal
    ``core/rrset.py::refill_schedule_steps`` of the rows' counts where no
    lane overflows."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    n_words = (n + 31) // 32
    bitval = bit_values(dev)
    offsets = offsets.to(torch.int64)
    lanes, quota, out_cap = int(lanes), int(quota), int(out_cap)
    flat = torch.zeros(lanes, out_cap + 1, dtype=torch.int32, device=dev)
    # a lane's current set, from its root at column 0 (a spare column last)
    qbuf = torch.zeros(lanes, out_cap + 1, dtype=torch.int32, device=dev)
    lengths = torch.zeros(lanes, max_sets, dtype=torch.int32, device=dev)
    rows = torch.full((lanes, max_sets), -1, dtype=torch.int32, device=dev)
    row_steps = torch.zeros(lanes, max_sets, dtype=torch.int64, device=dev)
    visited = torch.zeros(lanes, n_words, dtype=torch.int32, device=dev)
    zeros = torch.zeros(lanes, dtype=torch.int64, device=dev)
    # set_start: the set's offset in the lane's row; head, qtail: the set's
    # queue cursors; ecur: the edge cursor of the node at head
    set_start, head, qtail, ecur = (zeros.clone() for _ in range(4))
    n_done, cur_row, cur_steps, seeds = (zeros.clone() for _ in range(4))
    overflow = torch.zeros(lanes, dtype=torch.bool, device=dev)
    in_set = torch.zeros(lanes, dtype=torch.bool, device=dev)
    arange_ec = torch.arange(ec, dtype=torch.int64, device=dev)
    cols = torch.arange(out_cap + 1, device=dev)[None, :]
    next_id = 0

    def claim(want: torch.Tensor) -> None:
        # the lanes of `want`, in lane order, claim the next row ids
        nonlocal next_id
        who = want.nonzero()[:, 0]
        ids = next_id + torch.arange(who.shape[0], device=dev)
        next_id += who.shape[0]
        who, ids = who[ids < quota], ids[ids < quota]
        room = set_start[who] < out_cap
        overflow[who[~room]] = True
        who, ids = who[room], ids[room]
        s = counter_uniform_u32(seed32, ids)
        r = draw_roots(s, n, table).to(torch.int64)
        seeds[who], cur_row[who], cur_steps[who] = s, ids, 0
        visited[who] = 0
        visited[who, r >> 5] = bitval[r & 31]
        qbuf[who] = 0
        qbuf[who, 0] = r.to(torch.int32)
        head[who], qtail[who], ecur[who] = 0, 1, 0
        in_set[who] = True

    claim(torch.ones(lanes, dtype=torch.bool, device=dev))
    loop_steps = 0
    while bool(in_set.any()):
        head, qtail, ecur, over = _bfs_step(
            offsets, indices, weights, seeds[:, None], qbuf, visited, head,
            qtail, ecur, in_set, out_cap - set_start, arange_ec, bitval,
            dedup)
        cur_steps += in_set
        loop_steps += 1
        overflow |= over
        finished = in_set & ~over & (head >= qtail)
        in_set &= ~(finished | over)
        f = finished.nonzero()[:, 0]
        # the finished sets into their lanes' rows, at the lanes' tails
        put = torch.where(cols < qtail[f, None], set_start[f, None] + cols,
                          out_cap)
        flat[f] = flat[f].scatter(1, put, qbuf[f])
        slot = n_done[f]
        lengths[f, slot] = qtail[f].to(torch.int32)
        rows[f, slot] = cur_row[f].to(torch.int32)
        row_steps[f, slot] = cur_steps[f]
        n_done[f] += 1
        set_start[f] += qtail[f]
        claim(finished & (n_done < max_sets))
    flat = flat[:, :out_cap]
    return (flat.contiguous(), lengths, n_done.to(torch.int32), overflow, rows,
            row_steps, loop_steps)


def lt_walk_ref(offsets: torch.Tensor, indices: torch.Tensor,
                rowcum: torch.Tensor, seeds: torch.Tensor,
                roots: torch.Tensor, *, qcap: int):
    """One round of the LT walk sampler (paper §3.7), every lane's reverse
    walk to its end, in lock-step, from given row seeds and roots
    (:func:`lt_round_ref` draws them, as ``csrc/lt.cu`` does): the plain
    version of ``csrc/lt.cu``, the oracle's ``rr_set_lt`` on counter draws.

    Lane b stands on its last node ``cur`` with in-row ``[s, e)``.  Its
    draw number t (t = 0, 1, ... its draws so far) is ``u =
    float32(counter_uniform_u32(seeds[b], t)) * 2^-32``.  The walk stops
    when the row is empty or ``u >= rowcum[e - 1]``; else it takes edge j,
    the smallest in ``[s, e)`` with ``rowcum[j] > u`` (the reference's
    bisection; ``rowcum`` rises within a row), and stops when ``indices[j]``
    is on the walk already, or, with ``overflowed`` set, when the walk
    holds ``qcap`` nodes.  Else the node joins the walk.  The host reads
    whether any lane is walking once a draw.

    ``offsets`` (n+1,), ``indices`` (m,) and ``rowcum`` (m,) float32 (the
    row-cumulative weights, ``core/lt.py::row_cumweights``) are a reverse
    CSR; ``seeds`` (B,) int64 row seeds, ``roots`` (B,) int32.  Returns
    ``(walk (B, qcap) int32, lengths (B,) int32, overflowed (B,) bool,
    steps (B,) int64)``: ``walk[b, :lengths[b]]`` in visit order, zeros
    after it; ``steps[b]`` lane b's draws (its length, or qcap on
    overflow), the reference's loop count of the lane."""
    dev = roots.device
    batch = roots.shape[0]
    n = offsets.shape[0] - 1
    m = indices.shape[0]
    n_words = (n + 31) // 32
    bitval = bit_values(dev)
    offsets = offsets.to(torch.int64)
    if m == 0:         # every row is empty: give the reads one slot
        indices = torch.zeros(1, dtype=torch.int32, device=dev)
        rowcum = torch.zeros(1, dtype=torch.float32, device=dev)
    last = max(m - 1, 0)
    lane = torch.arange(batch, device=dev)
    walk = torch.zeros(batch, qcap + 1, dtype=torch.int32, device=dev)
    walk[:, 0] = roots
    cur = roots.to(torch.int64)
    visited = torch.zeros(batch, n_words + 1, dtype=torch.int32, device=dev)
    visited[lane, cur >> 5] = bitval[cur & 31]
    length = torch.ones(batch, dtype=torch.int64, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    overflow = torch.zeros(batch, dtype=torch.bool, device=dev)
    steps = torch.zeros(batch, dtype=torch.int64, device=dev)
    bisect_iters = max(math.ceil(math.log2(max(m, 2))) + 1, 1)
    while bool((~done).any()):
        active = ~done
        s, e = offsets[cur], offsets[cur + 1]
        u = counter_uniform_u32(seeds, steps).to(torch.float32) * _U01
        empty = e == s
        total = torch.where(empty, 0.0, rowcum[(e - 1).clamp(0, last)])
        stop = empty | (u >= total)
        lo, hi = s, torch.maximum(e - 1, s)
        for _ in range(bisect_iters):
            mid = (lo + hi) // 2
            go_right = rowcum[mid.clamp(0, last)] <= u
            lo = torch.where(go_right, torch.minimum(mid + 1, hi), lo)
            hi = torch.where(go_right, hi, mid)
        v = indices[lo.clamp(0, last)].to(torch.int64)
        seen = ((visited.gather(1, (v >> 5)[:, None])[:, 0]
                 >> (v & 31)) & 1) != 0
        take = active & ~(stop | seen)
        fits = length < qcap
        overflow |= take & ~fits
        take &= fits
        walk.scatter_(1, torch.where(take, length, qcap)[:, None],
                      v.to(torch.int32)[:, None])
        visited.scatter_add_(1, torch.where(take, v >> 5, n_words)[:, None],
                             torch.where(take, bitval[v & 31], 0)[:, None])
        length += take
        cur = torch.where(take, v, cur)
        steps += active
        done |= ~take
    return walk[:, :qcap], length.to(torch.int32), overflow, steps


def lt_round_ref(offsets: torch.Tensor, indices: torch.Tensor,
                 rowcum: torch.Tensor, seed32: int, batch: int, *, qcap: int,
                 table=None):
    """One round of the LT walk sampler with round seed ``seed32``: the
    plain version of ``csrc/lt.cu``.  The ``batch`` row seeds and roots
    (``core/roots.py``, ∝ the weights of the alias ``table`` when one is
    given, as :func:`queue_round_ref` draws them), then
    :func:`lt_walk_ref` on them.  Returns its four tensors and the (B,)
    int32 roots."""
    seeds = row_seeds(seed32, batch, offsets.device, row0=0)
    roots = draw_roots(seeds, offsets.shape[0] - 1, table)
    return (*lt_walk_ref(offsets, indices, rowcum, seeds, roots, qcap=qcap),
            roots)


def pack_bits_ref(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) bool -> (B, n/32) int32 words, LSB first: bit j of word w is
    ``bits[:, w*32 + j]``; bit 31 makes a word negative.  ``n`` must be a
    multiple of 32."""
    b, n = bits.shape
    if n % 32:
        raise ValueError("n must be a multiple of 32 (pad first)")
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    b3 = bits.reshape(b, n // 32, 32).to(torch.int64)
    return to_int32_bits((b3 << shift).sum(dim=2))


def bitset_or_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a | b`` on (B, W) int32 words."""
    return a | b


def bitset_andnot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & ~b`` on (B, W) int32 words."""
    return a & ~b


def frontier_update_ref(a: torch.Tensor,
                        visited: torch.Tensor) -> torch.Tensor:
    """``a & ~visited``, and ``visited |= a`` in place, on (B, W) int32
    words: :func:`bitset_andnot_ref` then :func:`bitset_or_ref` of the
    result into ``visited``."""
    new = a & ~visited
    visited |= new
    return new


def popcount_words_ref(words: torch.Tensor) -> torch.Tensor:
    """SWAR popcount per int32 word -> int32."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (mul_u32(v, 0x01010101) >> 24).to(torch.int32)


def _unpack_covered(cov_words: torch.Tensor) -> torch.Tensor:
    """(nw,) int32 packed Covered bitset -> (nw*32,) bool rows."""
    shifts = torch.arange(32, dtype=torch.int32, device=cov_words.device)
    return (((cov_words[:, None] >> shifts) & 1) != 0).reshape(-1)


def _pack_covered(rows: torch.Tensor) -> torch.Tensor:
    """(nw*32,) bool rows -> (nw,) int32 packed words."""
    shifts = torch.arange(32, dtype=torch.int64, device=rows.device)
    words = (rows.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)
    return to_int32_bits(words)


def _newly_rows(flat, ids, valid, covered, u):
    """Rows containing ``u`` that are not covered yet — the membership
    pass of the fused scan."""
    match = ((flat == u) & valid).to(torch.int32)
    row_has = torch.zeros(covered.shape[0], dtype=torch.int32,
                          device=flat.device).index_add_(0, ids, match) > 0
    return row_has & ~covered


def greedy_flat_ref(flat: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, *, n: int, num_rows: int, k: int):
    """Greedy max-coverage of ``k`` seeds on a flat pool: the reference's
    fused scan (``repro.core.coverage`` ``fused``), the plain version of
    ``csrc/greedy.cu``.

    ``flat``/``ids``/``valid`` are the pool's (t,) node ids, row ids (below
    ``num_rows``, a multiple of 32) and valid flags; elements are unique
    within a row.  Occur starts as the count of valid elements per node.
    Each step takes the first maximum of Occur (the lowest id on ties, 0
    when Occur is all zero), marks the rows that hold it and are not yet
    covered in a packed Covered bitset, counts them (the SWAR popcount of
    the new words) and takes their valid elements off Occur.  Returns
    ``(seeds (k,) int32, gains (k,) int32)``.
    """
    flat = flat.to(torch.int64)
    ids = ids.to(torch.int64)
    dev = flat.device
    occur = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, valid.to(torch.int32))[:n]
    cov = torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        newly = _newly_rows(flat, ids, valid, _unpack_covered(cov), u)
        new_words = _pack_covered(newly)
        gains.append(popcount_words_ref(new_words.view(1, -1)).sum())
        elem_newly = (newly[ids] & valid).to(torch.int32)
        occur = occur - torch.zeros(n + 1, dtype=torch.int32,
                                    device=dev).index_add_(
            0, flat, elem_newly)[:n]
        cov = cov | new_words
        seeds.append(u)
    return (torch.stack(seeds).to(torch.int32),
            torch.stack(gains).to(torch.int32))


def occur_flat_ref(flat: torch.Tensor, valid: torch.Tensor, *,
                   n: int) -> torch.Tensor:
    """The valid elements of each node v in [0, n) of a flat pool (a
    rank's shard): the reference's Occur scatter-add of the sharded fused
    scan, the plain version of ``csrc/shard.cu``'s ``occur_flat``.  ->
    (n,) int32."""
    f = flat.to(torch.int64)
    keep = valid & (f >= 0) & (f < n)
    return torch.zeros(n + 1, dtype=torch.int32, device=flat.device
                       ).index_add_(0, torch.where(keep, f, n),
                                    keep.to(torch.int32))[:n]


def shard_flat_step_ref(flat: torch.Tensor, ids: torch.Tensor,
                        valid: torch.Tensor, cov_words: torch.Tensor,
                        u: torch.Tensor, *, n: int) -> torch.Tensor:
    """One seed step of the sharded fused scan on a rank's shard: the
    body of the reference's ``fused`` scan step, the plain version of
    ``csrc/shard.cu``'s ``shard_flat_step``.

    ``flat``/``ids``/``valid`` are the shard's (t,) node ids, row ids and
    valid flags, ``cov_words`` its (rows/32,) int32 Covered words, ``u`` the
    seed as a one-element tensor (read on its device, never on the host).
    The rows that hold ``u`` in a valid element and are not covered are the
    new rows (a row counts once, whatever it repeats; an element whose row
    lies outside ``[0, rows)`` counts for none).  They are ORed into
    ``cov_words`` in place.  Returns the (n + 1,) int32 decrement: slot v <
    n the valid elements of node v in the new rows, slot n the new rows'
    count."""
    flat, ids, keep = _celf_pool(flat, ids, valid, cov_words)
    newly = _newly_rows(flat, ids, keep, _unpack_covered(cov_words),
                        u.reshape(()))
    cov_words |= _pack_covered(newly)
    elem = keep & newly[ids] & (flat >= 0) & (flat < n)
    dec = torch.zeros(n + 1, dtype=torch.int32, device=flat.device
                      ).index_add_(0, torch.where(elem, flat, n),
                                   elem.to(torch.int32))
    dec[n] = newly.sum(dtype=torch.int32)
    return dec


def greedy_flat_variant_ref(flat: torch.Tensor, ids: torch.Tensor,
                            valid: torch.Tensor, *, n: int, num_rows: int,
                            k: int, cand: torch.Tensor,
                            costs: torch.Tensor | None, budget: float,
                            n_group: int, n_groups: int, group_quota: int,
                            ew: torch.Tensor | None = None):
    """The generalised greedy of the problem variants on a flat pool: the
    reference's ``fused_variant`` scan (``repro.core.coverage``, unweighted)
    step for step, the plain version of ``csrc/greedy.cu``'s
    ``greedy_flat_variant``.

    The pool is :func:`greedy_flat_ref`'s.  ``cand`` is an (n,) bool mask,
    ``costs`` (n,) float32 or None (no budget), ``budget`` the float32
    budget, and nodes fall into groups of ``n_group`` (``n_group *
    n_groups >= n``), each of which may give ``group_quota`` seeds.  Step
    s: a node is feasible when it is a candidate, its group has quota left
    and it is not picked yet, and with costs also when ``costs[v] <=
    budget - spent`` and its Occur is positive.  Without costs the step
    takes the first maximum of Occur over the feasible nodes (Occur 0
    included); with costs the first maximum of ``float32(Occur) / cost``.
    A step with no feasible node takes the sentinel n, gains 0 and changes
    nothing.  Otherwise its gain is the rows it newly covers, its group
    loses one of its quota, and ``spent`` gains its cost (float32, in step
    order).  Returns ``(seeds (k,) int32, gains (k,) int32, spent ()
    float32)``.

    Weighted (``ew``, the (t,) float32 element weights of a row-weighted
    store; the reference's ``fused_variant_w``): Occur starts as the
    float32 scatter-add of the valid elements' weights, the score is that
    float Occur (its first maximum over the feasible nodes, Occur 0
    included; with costs over those of positive Occur), a step's gain is
    the float32 sum of the weights of the rows it newly covers (a row's
    weight: its largest valid element weight, floored at 0), each step
    takes its new rows' element weights off Occur, and Occur is clamped
    at 0 after it.  The gains are then (k,) float32."""
    weighted = ew is not None
    flat = flat.to(torch.int64)
    ids = ids.to(torch.int64)
    dev = flat.device
    if weighted:
        occur = weighted_occur(flat, valid, ew, n)
        roww = row_weights(ids, valid, ew, num_rows)
    else:
        occur = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
            0, flat, valid.to(torch.int32))[:n]
    cov = torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
    scan = VariantScan(n, cand, costs, budget, n_group, n_groups, group_quota)
    seeds, gains = [], []
    for _ in range(k):
        u, ok = scan.pick(occur)
        newly = _newly_rows(flat, ids, valid, _unpack_covered(cov), u)
        new_words = _pack_covered(newly)
        elem_newly = newly[ids] & valid
        if weighted:
            gains.append(torch.where(newly, roww, 0.0).sum(
                dtype=torch.float32))
            occur = torch.clamp_min(
                occur - weighted_occur(flat, elem_newly, ew, n), 0.0)
        else:
            gains.append(popcount_words_ref(new_words.view(1, -1)).sum())
            occur = occur - torch.zeros(n + 1, dtype=torch.int32,
                                        device=dev).index_add_(
                0, flat, elem_newly.to(torch.int32))[:n]
        scan.commit(u, ok)
        cov = cov | new_words
        seeds.append(u)
    gains = torch.stack(gains)
    return (torch.stack(seeds).to(torch.int32),
            gains if weighted else gains.to(torch.int32), scan.spent)


def greedy_stacked_ref(flat: torch.Tensor, ids: torch.Tensor,
                       valid: torch.Tensor, *, n: int, num_rows: int,
                       k_max: int, cand: torch.Tensor, costs: torch.Tensor,
                       budget: torch.Tensor, ks: torch.Tensor,
                       quota: torch.Tensor, plain: torch.Tensor,
                       use_costs: torch.Tensor, n_group: int, n_groups: int):
    """R greedy selections on one flat pool in one scan of ``k_max`` steps:
    the reference's ``stacked`` scan (``repro.core.coverage``, serving's
    batched selection), the plain version of ``csrc/greedy.cu``'s
    ``greedy_stacked``.

    The pool is :func:`greedy_flat_ref`'s.  Row r of the (R, n) ``cand``
    and ``costs`` and of the (R,) ``budget``, ``ks``, ``quota``, ``plain``
    and ``use_costs`` is request r.  Step t, for each row r with ``t <
    ks[r]`` (the reference's vmapped ``pick_one``/``cover_one`` as a loop
    over the rows): a plain row takes the first maximum of its Occur
    (:func:`greedy_flat_ref`'s step, duplicates tolerated); a variant row
    takes :class:`VariantScan`'s pick over its candidates, its groups of
    ``n_group`` ids with ``quota[r]`` seeds each and, when
    ``use_costs[r]``, its costs and ``budget[r]``
    (:func:`greedy_flat_variant_ref`'s step).  The pick's newly covered
    rows (:func:`_newly_rows` against the row's own Covered) give the gain
    and come off the row's Occur.  Steps at or past ``ks[r]`` leave the
    sentinel n, gain 0, and change nothing.  Returns ``(seeds (R, k_max)
    int32, gains (R, k_max) int32, spent (R,) float32)``: row r is the
    solo scan's output for request r."""
    flat = flat.to(torch.int64)
    ids = ids.to(torch.int64)
    dev = flat.device
    rows = ks.shape[0]
    ks_h, plain_h = ks.tolist(), plain.tolist()
    occur0 = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, valid.to(torch.int32))[:n]
    occur = [occur0.clone() for _ in range(rows)]
    cov = [torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
           for _ in range(rows)]
    scans = [None if plain_h[r] else VariantScan(
        n, cand[r], costs[r] if bool(use_costs[r]) else None,
        float(budget[r]), n_group, n_groups, int(quota[r]))
        for r in range(rows)]
    seeds = torch.full((rows, k_max), n, dtype=torch.int32, device=dev)
    gains = torch.zeros((rows, k_max), dtype=torch.int32, device=dev)
    for t in range(k_max):
        for r in range(rows):
            if t >= ks_h[r]:
                continue
            scan = scans[r]
            if scan is None:
                u, ok = torch.argmax(occur[r]), None
            else:
                u, ok = scan.pick(occur[r])
            newly = _newly_rows(flat, ids, valid, _unpack_covered(cov[r]), u)
            new_words = _pack_covered(newly)
            gains[r, t] = popcount_words_ref(new_words.view(1, -1)).sum()
            occur[r] = occur[r] - torch.zeros(
                n + 1, dtype=torch.int32, device=dev).index_add_(
                0, flat, (newly[ids] & valid).to(torch.int32))[:n]
            cov[r] = cov[r] | new_words
            if scan is not None:
                scan.commit(u, ok)
            seeds[r, t] = u
    spent = torch.stack([torch.zeros((), dtype=torch.float32, device=dev)
                         if scan is None else scan.spent for scan in scans])
    return seeds, gains, spent


def _celf_pool(flat, ids, valid, cov_words):
    """The pool as int64 ids, with the elements whose row lies outside the
    Covered words dropped (the reference's ``segment_max`` drops them)."""
    ids = ids.to(torch.int64)
    keep = valid & (ids >= 0) & (ids < 32 * cov_words.shape[0])
    return flat.to(torch.int64), torch.where(keep, ids, 0), keep


def celf_eval_ref(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                  cov_words: torch.Tensor, cands: torch.Tensor,
                  roww: torch.Tensor | None = None) -> torch.Tensor:
    """Exact marginal coverage of each candidate against a packed Covered
    bitset: the reference's ``eval_batch``, the plain version of
    ``csrc/celf.cu``'s ``celf_eval``.

    ``flat``/``ids``/``valid`` are a flat pool's (t,) node ids, row ids
    (below ``32 * len(cov_words)``) and valid flags; ``cov_words`` the
    (num_rows/32,) int32 Covered words; ``cands`` (c,) node ids, where an
    id that is no node (the reference pads with -1) matches nothing.
    ``out[i]`` counts the rows that hold ``cands[i]`` and are not covered;
    a row that repeats the node counts once.  -> (c,) int32.

    Weighted (``roww``, (num_rows,) float32 row weights, the reference's
    ``eval_batch_w``): ``out[i]`` is the float32 sum of those rows'
    weights -> (c,) float32."""
    flat, ids, valid = _celf_pool(flat, ids, valid, cov_words)
    covered = _unpack_covered(cov_words)
    out = [_row_gain(_newly_rows(flat, ids, valid, covered, u), roww)
           for u in cands.to(torch.int64)]
    if not out:
        return torch.zeros(0, dtype=torch.int32 if roww is None
                           else torch.float32, device=flat.device)
    return torch.stack(out)


def _row_gain(newly: torch.Tensor, roww: torch.Tensor | None):
    """The rows in ``newly``: their count (int32), or the float32 sum of
    their ``roww`` weights."""
    if roww is None:
        return newly.sum(dtype=torch.int32)
    return torch.where(newly, roww[:newly.shape[0]], 0.0).sum(
        dtype=torch.float32)


def celf_apply_ref(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                   cov_words: torch.Tensor, u: int,
                   roww: torch.Tensor | None = None) -> torch.Tensor:
    """Commit seed ``u``: OR the rows that hold it into ``cov_words`` in
    place and return the number of them that were not covered before, as
    a 0-d int32 tensor: the reference's ``apply_seed``, the plain version
    of ``csrc/celf.cu``'s ``celf_apply``.  With ``roww`` (the reference's
    ``apply_seed_w``) the float32 sum of those rows' weights, 0-d
    float32."""
    flat, ids, valid = _celf_pool(flat, ids, valid, cov_words)
    newly = _newly_rows(flat, ids, valid, _unpack_covered(cov_words), int(u))
    cov_words |= _pack_covered(newly)
    return _row_gain(newly, roww)


def celf_select_ref(flat: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, *, n: int, num_rows: int, k: int,
                    c: int, sketch: torch.Tensor | None = None,
                    calls_out: list | None = None):
    """One selection of the CELF lazy greedy with sketch-first candidate
    ordering: the reference's ``select_seeds_celf`` on one device, seed for
    seed, the plain version of ``csrc/celf.cu``'s ``celf_select``.

    ``flat``/``ids``/``valid`` are a flat pool (row ids below
    ``num_rows``, a multiple of 32); ``c`` (1 <= c <= n) candidates an
    exact evaluation; ``sketch`` the (R >= n, W) int32 coverage sketch, or
    None for no sweep.  A host priority array ``ub`` holds each node's last
    exact marginal gain (at first its valid elements), an upper bound under
    submodularity.  Each seed: every node turns stale; with the sketch, the
    c nodes of largest key ``Δocc·(n+1) − id`` (Δocc(v) =
    popcount(sketch[v] | cov_sk) − popcount(cov_sk), a lower bound on the
    gain; both popcounts are kept as cov_sk grows, each seed adding only
    the words its row brings) are evaluated exactly (``celf_eval_ref``,
    one eval call).  Then
    the first maximum of ``ub`` (the lowest id on ties) is accepted once it
    is fresh; else the ``min(c, stale)`` stale nodes of largest key
    ``ub·(n+1) − id`` are evaluated.  The keys are unique, so each batch is
    the reference's ``argpartition`` set.  The commit is ``celf_apply_ref``
    (its gain is the seed's); ``ub[u]`` = 0 and ``cov_sk`` takes
    ``sketch[u]``.  -> ``(seeds (k,) int32, gains (k,) int32, stats (2,)
    int64)``, stats the candidates evaluated and the eval calls.  Each eval
    call's candidates (a numpy array) are appended to ``calls_out``, when
    given, for a caller that counts the work."""
    dev = flat.device
    keep = valid & (flat >= 0) & (flat < n)
    ub = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(keep, flat, n).to(torch.int64),
        keep.to(torch.int64))[:n].cpu().numpy()
    fresh = np.zeros(n, bool)
    cov_words = torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
    if sketch is not None:
        # union[v] = popcount(sketch[v] | cov_sk), kept as cov_sk grows:
        # new bits b add popcount(b & ~sketch[v]), on the words b touches
        rows = sketch[:n]
        cov_sk = torch.zeros(sketch.shape[1], dtype=torch.int32, device=dev)
        union = popcount_words_ref(rows).sum(dim=1, dtype=torch.int64)
        base = 0                         # popcount(cov_sk)
    node_ids = np.arange(n)
    n_evals = n_calls = 0

    def eval_exact(cands: np.ndarray) -> None:
        nonlocal n_evals, n_calls
        g = celf_eval_ref(flat, ids, valid, cov_words,
                          torch.from_numpy(cands).to(dev))
        ub[cands] = g.cpu().numpy()
        fresh[cands] = True
        if calls_out is not None:
            calls_out.append(cands)
        n_evals += len(cands)
        n_calls += 1

    seeds, gains = [], []
    for _ in range(k):
        fresh[:] = False
        if sketch is not None:
            key = (union - base).cpu().numpy() * (n + 1) - node_ids
            eval_exact(np.argpartition(-key, c - 1)[:c])
        while True:
            u = int(np.argmax(ub))       # first max == lowest id on ties
            if fresh[u]:
                break
            stale = node_ids[~fresh]
            cc = min(c, len(stale))
            key = ub[stale] * (n + 1) - stale
            eval_exact(stale[np.argpartition(-key, cc - 1)[:cc]])
        gains.append(int(celf_apply_ref(flat, ids, valid, cov_words, u)))
        if sketch is not None:
            new = sketch[u] & ~cov_sk
            w = torch.nonzero(new).view(-1)
            union += popcount_words_ref(new[w] & ~rows[:, w]).sum(
                dim=1, dtype=torch.int64)
            base += int(popcount_words_ref(new[w]).sum())
            cov_sk |= new
        ub[u] = 0                        # exact: u's rows are now covered
        seeds.append(u)
    return (torch.tensor(seeds, dtype=torch.int32, device=dev),
            torch.tensor(gains, dtype=torch.int32, device=dev),
            torch.tensor([n_evals, n_calls], dtype=torch.int64, device=dev))


class FlatIndex(NamedTuple):
    """The pool's two CSR indices.  Row-major: row r's elements are
    ``nodes[row_start[r]:row_start[r + 1]]``, with invalid elements as
    ``n``.  Node-major: the rows that hold node v are
    ``inv_rows[inv_start[v]:inv_start[v + 1]]``, in row order, so Occur's
    start is ``inv_start[v + 1] - inv_start[v]``."""
    nodes: torch.Tensor       # (t,) int32
    row_start: torch.Tensor   # (num_rows + 1,) int32
    inv_start: torch.Tensor   # (n + 1,) int32
    inv_rows: torch.Tensor    # (t,) int32


def flat_index(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
               *, n: int, num_rows: int) -> FlatIndex:
    """:class:`FlatIndex` of a pool whose rows are contiguous and in row
    order (``ids`` non-decreasing, as ``DeviceRRStore.append_batch`` writes
    them): the plain statement of the indices that ``csrc/greedy.cu``
    builds inside its launch (there a node's rows come in no set order),
    by torch operations on the pool's device and no host read: a stable
    sort of the valid elements by node (invalid ones sort last, as node n)
    and two binary searches."""
    dev = flat.device
    nodes = torch.where(valid, flat.to(torch.int32), n)
    key, perm = torch.sort(nodes, stable=True)
    ids = ids.to(torch.int32)
    inv_start = torch.searchsorted(
        key, torch.arange(n + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    row_start = torch.searchsorted(
        ids, torch.arange(num_rows + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return FlatIndex(nodes=nodes, row_start=row_start, inv_start=inv_start,
                     inv_rows=ids.index_select(0, perm))


def occur_from_bitset_ref(words: torch.Tensor) -> torch.Tensor:
    """Occur[w*32 + b] = number of rows with bit b of word w set.

    (B, W) int32 -> (W*32,) int32.  Rows are summed block by block, the
    plain twin of the reference Pallas grid's accumulation.
    """
    b, w = words.shape
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    acc = torch.zeros(w, 32, dtype=torch.int64, device=words.device)
    step = max(1, _OCCUR_ELEMS // max(w * 32, 1))
    for r0 in range(0, b, step):
        blk = words[r0:r0 + step]
        acc += ((blk[:, :, None] >> shift) & 1).sum(dim=0)
    return acc.reshape(w * 32).to(torch.int32)


def occur_from_bitset_masked_ref(words: torch.Tensor,
                                 rowmask: torch.Tensor) -> torch.Tensor:
    """Occur over the rows with ``rowmask[r] != 0`` only (B,) int32/bool."""
    keep = (rowmask != 0)[:, None]
    return occur_from_bitset_ref(torch.where(keep, words,
                                             torch.zeros_like(words)))


def _check_buckets(bucket: torch.Tensor, n_words: int) -> None:
    """Raise unless every bucket lies in ``[0, 32 * n_words)`` (one host
    read; the CUDA wrapper raises on the same condition)."""
    if bucket.numel() and bool(((bucket < 0) | (bucket >= 32 * n_words)).any()):
        raise ValueError(f"bucket outside [0, {32 * n_words})")


def sketch_scatter_or_ref(words: torch.Tensor, v: torch.Tensor,
                          bucket: torch.Tensor,
                          bad: torch.Tensor | None = None) -> torch.Tensor:
    """``words[v[e], bucket[e] >> 5] |= 1 << (bucket[e] & 31)``, in place.

    ``words`` is a contiguous (R, W) int32 matrix, ``v``/``bucket`` are (E,)
    integer tensors.  Pairs with ``v`` outside ``[0, R)`` are dropped and
    duplicates are harmless; a bucket outside ``[0, 32W)`` raises, or, when
    a (1,) int32 flag ``bad`` is given, sets it nonzero and its pair is
    dropped (no host read: the caller reads the flag later).  torch
    has no scatter with an OR reduction, so, as the reference's
    ``scatter_or_bits``: the (cell, bit) keys are deduplicated, bits already
    set are masked off, and the rest (distinct bits of each word) commit
    with one add per word, which then equals OR.  The add runs in int64 on
    the unsigned value and wraps back to int32 bits.  Returns ``words``.
    """
    r, w = words.shape
    v = v.to(torch.int64)
    b = bucket.to(torch.int64)
    keep = (v >= 0) & (v < r)
    if bad is None:
        _check_buckets(bucket, w)
    else:
        outside = (b < 0) | (b >= 32 * w)
        bad.bitwise_or_(outside.any().to(torch.int32))
        keep &= ~outside
    key = torch.unique((v * (w * 32) + b)[keep])      # sorted (cell, bit)
    if key.numel() == 0:
        return words
    cell = key >> 5                                   # = v*W + (b >> 5)
    flat = words.view(-1)
    val = torch.ones_like(key) << (key & 31)
    cur = flat[cell].to(torch.int64) & MASK32
    new = torch.where((cur & val) == 0, val, 0)
    ucell, inv = torch.unique_consecutive(cell, return_inverse=True)
    add = torch.zeros(ucell.numel(), dtype=torch.int64,
                      device=words.device).index_add_(0, inv, new)
    flat[ucell] = to_int32_bits((flat[ucell].to(torch.int64) & MASK32) + add)
    return words


def sketch_fold_rows_ref(words: torch.Tensor, nodes: torch.Tensor,
                         lens: torch.Tensor, row_base: int, *, k: int,
                         mode: str, counts: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Fold a padded batch into ``words`` in place: for every row i with
    ``lens[i] > 0`` and every lane j < min(lens[i], W), ``words[nodes[i,
    j], b_i >> 5] |= 1 << (b_i & 31)`` with ``b_i`` the bucket of row id
    ``row_base`` + (non-empty rows before i) (``kernels.sketch.bucket_of``:
    ids mod 2^32, ``"mix"`` hashed); nodes outside ``[0, R)`` are dropped.
    As pairs: the batch's (v, bucket) pairs (``frontier_pairs``) through
    :func:`sketch_scatter_or_ref`.  Given a (2,) int64 ``counts``, the
    batch's valid lanes and non-empty rows go there.  Returns ``words``."""
    k = int(k)
    check_fold(words, nodes, lens, k=k, mode=mode)
    clamped = lens.to(torch.int64).clamp(0, nodes.shape[1])
    v, b = frontier_pairs(nodes, clamped, canonical_row_ids(lens, row_base),
                          n_rows=words.shape[0], k=k, mode=mode)
    sketch_scatter_or_ref(words, v, b)
    if counts is not None:
        counts.copy_(torch.stack([clamped.sum(), (clamped > 0).sum()]))
    return words


def sketch_union_popcount_ref(words: torch.Tensor,
                              cov: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_w popcount(words[r, w] | cov[w])``: (R, W) and (W,)
    int32 -> (R,) int32."""
    return popcount_words_ref(words | cov[None, :]).sum(dim=1,
                                                        dtype=torch.int32)


def greedy_sketch_ref(words: torch.Tensor, *, n: int, k: int,
                      cand: torch.Tensor | None = None):
    """The approximate mode's greedy on sketch estimates: (R, W) int32
    sketch words whose rows ``v < n`` are the nodes' -> ``(seeds (k,),
    gains (k,), steps (1,))`` int32.

    cov starts at zero, and the picked set at the nodes outside the (n,)
    bool candidate mask ``cand`` (empty without one).  Step s: ``delta(v)
    = popcount(words[v] | cov) - popcount(cov)``; the first maximum of
    delta over the nodes not picked yet (``torch.argmax``: the lowest id on
    ties) is seed s with gain delta, it is picked, and cov takes its row.
    With no node left the greedy stops: the steps not taken hold seed n and
    gain 0, and ``steps`` counts the steps taken.  One host read a step."""
    dev = words.device
    rows = words[:n]
    cov = torch.zeros(words.shape[1], dtype=torch.int32, device=dev)
    picked = (torch.zeros(n, dtype=torch.bool, device=dev) if cand is None
              else ~cand.to(device=dev, dtype=torch.bool))
    out = torch.zeros(2 * k + 1, dtype=torch.int32, device=dev)
    out[:k] = n
    base = steps = 0
    while steps < k:
        score = torch.where(picked, -1,
                            sketch_union_popcount_ref(rows, cov) - base)
        u = torch.argmax(score)
        u, best = torch.stack([u, score[u].to(u.dtype)]).tolist()
        if best < 0:                     # no node left
            break
        out[steps], out[k + steps] = u, best
        picked[u] = True
        cov |= words[u]
        base += best
        steps += 1
    out[2 * k] = steps
    return out[:k], out[k:2 * k], out[2 * k:]


def membership_rows_ref(rows: torch.Tensor, lengths: torch.Tensor,
                        u) -> torch.Tensor:
    """``hit[r] = any(rows[r, :lengths[r]] == u)``: (R, L) int32 rows padded
    past each length, (R,) lengths, ``u`` an int or a 0-d/1-element tensor
    -> (R,) bool.  Padding lanes never match, whatever they hold."""
    if isinstance(u, torch.Tensor):
        u = u.reshape(())
    lane = torch.arange(rows.shape[1], device=rows.device)[None, :]
    valid = lane < lengths[:, None]
    return ((rows == u) & valid).any(dim=1)


def padded_lane_node(x: torch.Tensor, n: int) -> torch.Tensor:
    """The node that a valid lane holding ``x`` counts for, -1 for none:
    the reference's ``.at[rows].add(..., mode="drop")[:n]``, which wraps a
    negative index as NumPy does (``x + n + 1``, so -1 is slot n) and drops
    what lands outside [0, n] and then slot n (the padding value)."""
    x = x.to(torch.int64)
    node = torch.where(x < 0, x + n + 1, x)
    return torch.where((node >= 0) & (node < n), node, -1)


def padded_greedy_ref(rows: torch.Tensor, lengths: torch.Tensor, *, n: int,
                      k: int):
    """The padded store's greedy, k steps: (R, L) int32 ``rows`` padded
    past each length, (R,) ``lengths`` -> ``(seeds (k,), gains (k,))``
    int32, as the reference's ``select_seeds_padded``.

    Occur starts as a scatter-add of the valid lanes: a lane holding x
    counts for :func:`padded_lane_node` (x, n), so a node twice in a row
    counts twice and a lane at n, past n or below -(n + 1) counts for
    none.  Each step takes u, the first maximum of Occur over all n nodes
    (picked nodes are not left out), finds the rows that hold it
    (:func:`membership_rows_ref`, which compares the lanes as they are),
    and takes the newly covered rows' valid lanes off Occur by the same
    scatter-add; its gain is the newly covered rows.  The valid lanes are
    gathered once, before the steps (the reference adds zeros for every
    padding lane).  The seed stays on the device between steps, so on a
    card the k steps make no host sync beyond the gather.
    """
    r, l = rows.shape
    dev = rows.device
    valid = (torch.arange(l, device=dev)[None, :] < lengths[:, None])
    elem_row, lane = torch.nonzero(valid, as_tuple=True)
    elem_node = padded_lane_node(rows[elem_row, lane], n)
    counted = elem_node >= 0
    elem_row, elem_node = elem_row[counted], elem_node[counted]
    occur = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, elem_node, torch.ones_like(elem_node, dtype=torch.int32))
    covered = torch.zeros(r, dtype=torch.bool, device=dev)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        hit = membership_rows_ref(rows, lengths, u)
        newly = hit & ~covered
        dec = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, elem_node, newly[elem_row].to(torch.int32))
        occur = occur - dec
        covered = covered | hit
        seeds.append(u)
        gains.append(newly.sum(dtype=torch.int32))
    return (torch.stack(seeds).to(torch.int32),
            torch.stack(gains).to(torch.int32))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Attention over (B, S, H, D) q, k, v with the S x S logits
    materialised in float32 (masked with -1e30 when causal), a softmax,
    and the output cast back to q's dtype."""
    s, d = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = logits.masked_fill(pos[:, None] < pos[None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)
