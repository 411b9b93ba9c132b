"""The one dispatch point between the plain versions and the CUDA kernels.

A tensor on the CPU goes to ``kernels/ref.py``; a tensor on a CUDA card goes
to the hand-written kernel, which builds on first use and raises if it
cannot build or launch.  There is no switch that sends a CUDA tensor to the
plain version: code that wants the plain version on the card calls
``ref.py`` directly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import bernoulli as _bernoulli
from repro_torch.kernels import bitset as _bitset
from repro_torch.kernels import celf as _celf
from repro_torch.kernels import flashattn as _flash
from repro_torch.kernels import greedy as _greedy
from repro_torch.kernels import lt as _lt
from repro_torch.kernels import membership as _membership
from repro_torch.kernels import queue as _queue
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import refill as _refill
from repro_torch.kernels import shard as _shard
from repro_torch.kernels import sketch as _sketch

_COUNTERS = (_bitset.LAUNCHES, _sketch.LAUNCHES, _bernoulli.LAUNCHES,
             _membership.LAUNCHES, _flash.LAUNCHES, _queue.LAUNCHES,
             _greedy.LAUNCHES, _celf.LAUNCHES, _lt.LAUNCHES,
             _refill.LAUNCHES, _shard.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.is_cpu:
        return "cpu"
    raise ValueError(f"no kernel or plain version for device {t.device}")


def occur_from_bitset(words: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _bitset.occur_from_bitset(words)
    return _ref.occur_from_bitset_ref(words)


def occur_from_bitset_masked(words: torch.Tensor,
                             rowmask: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _bitset.occur_from_bitset_masked(words, rowmask)
    return _ref.occur_from_bitset_masked_ref(words, rowmask)


def sketch_scatter_or(words: torch.Tensor, v: torch.Tensor,
                      bucket: torch.Tensor,
                      bad: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-OR of (row, bucket) pairs into ``words``, in place.  A bucket
    outside ``[0, 32W)`` raises at once or, given a (1,) int32 flag ``bad``
    on the words' device, sets the flag for the caller to read later."""
    if _route(words) == "cuda":
        return _sketch.sketch_scatter_or(words, v, bucket, bad)
    return _ref.sketch_scatter_or_ref(words, v, bucket, bad)


def sketch_fold_rows(words: torch.Tensor, nodes: torch.Tensor,
                     lens: torch.Tensor, row_base: int, *, k: int, mode: str,
                     counts: torch.Tensor | None = None) -> torch.Tensor:
    """Fold a padded (B, W) batch into ``words`` in place, its non-empty
    rows numbered from ``row_base`` in batch order and bucketed by
    ``mode``; ``counts``, a (2,) int64 tensor on the words' device, gets
    the batch's valid lanes and non-empty rows.  The same bytes on either
    route (``ref.sketch_fold_rows_ref`` says what they hold)."""
    if _route(words) == "cuda":
        return _sketch.sketch_fold_rows(words, nodes, lens, row_base, k=k,
                                        mode=mode, counts=counts)
    return _ref.sketch_fold_rows_ref(words, nodes, lens, row_base, k=k,
                                     mode=mode, counts=counts)


def sketch_union_popcount(words: torch.Tensor,
                          cov: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _sketch.sketch_union_popcount(words, cov)
    return _ref.sketch_union_popcount_ref(words, cov)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) bool, n % 32 == 0 -> (B, n/32) int32 words, LSB first."""
    if _route(bits) == "cuda":
        return _bitset.pack_bits(bits)
    return _ref.pack_bits_ref(bits)


def bitset_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _route(a) == "cuda":
        return _bitset.bitset_or(a, b)
    return _ref.bitset_or_ref(a, b)


def bitset_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & ~b``."""
    if _route(a) == "cuda":
        return _bitset.bitset_andnot(a, b)
    return _ref.bitset_andnot_ref(a, b)


def frontier_update(a: torch.Tensor, visited: torch.Tensor) -> torch.Tensor:
    """The dense level's frontier: ``a & ~visited``, with ``visited |= a``
    in place (one launch on a card)."""
    if _route(a) == "cuda":
        return _bitset.frontier_update(a, visited)
    return _ref.frontier_update_ref(a, visited)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _bitset.popcount_words(words)
    return _ref.popcount_words_ref(words)


def bernoulli_edges(weights: torch.Tensor, seeds) -> torch.Tensor:
    """Edge trials for one seed (-> (E,) bool) or a (B,) seed vector (->
    (B, E) bool)."""
    if _route(weights) == "cuda":
        return _bernoulli.bernoulli_edges(weights, seeds)
    return _ref.bernoulli_edges_ref(weights, seeds)


def queue_bfs(offsets: torch.Tensor, indices: torch.Tensor,
              weights: torch.Tensor, seed32: int, batch: int, *, qcap: int,
              ec: int, table=None, dedup: str = "none", root_tile: int = 1,
              row0: int = 0):
    """One sampling round of the queue sampler with round seed ``seed32``
    and ``batch`` lanes, lane i row ``row0 + i`` of the round (``row0 = 0``
    for a whole round, ``d·b`` for rank d's b lanes of a sharded one):
    every lane's row seed and root (∝ the weights of
    the alias ``table``, a ``(prob, alias)`` pair, when one is given; lanes
    ``[tT, tT + T)`` share lane tT's root for ``root_tile`` T), and its BFS
    on the reverse CSR to its end, with the chunk ``dedup`` of rows that
    repeat destinations -> (queue (B, qcap) int32, lengths (B,) int32,
    overflowed (B,) bool, steps (B,) int64, roots (B,) int32); the same
    bytes on either route (``ref.queue_round_ref`` says what they
    hold)."""
    if _route(offsets) == "cuda":
        return _queue.queue_bfs(offsets, indices, weights, seed32, batch,
                                qcap=qcap, ec=ec, table=table, dedup=dedup,
                                root_tile=root_tile, row0=row0)
    return _ref.queue_round_ref(offsets, indices, weights, seed32, batch,
                                qcap=qcap, ec=ec, table=table, dedup=dedup,
                                root_tile=root_tile, row0=row0)


def refill_bfs(offsets: torch.Tensor, indices: torch.Tensor,
               weights: torch.Tensor, seed32: int, lanes: int, *,
               quota: int, out_cap: int, max_sets: int, ec: int,
               table=None, dedup: str = "none"):
    """One round of the persistent-lane sampler (paper Alg. 6): rows ``0
    .. quota - 1`` of round seed ``seed32``, each :func:`queue_bfs`'s lane
    of that index, on ``lanes`` lanes that claim row ids as they finish ->
    (flat (L, out_cap) int32, lengths (L, S) int32, n_done (L,) int32,
    overflowed (L,) bool, rows (L, S) int32, row_steps (L, S) int64)
    (``kernels/refill.py::refill_bfs`` says what they hold).  Each emitted
    row has the same bytes on either route; which lane holds it depends on
    the route (``ref.refill_round_ref`` claims in lane order)."""
    if _route(offsets) == "cuda":
        return _refill.refill_bfs(offsets, indices, weights, seed32, lanes,
                                  quota=quota, out_cap=out_cap,
                                  max_sets=max_sets, ec=ec, table=table,
                                  dedup=dedup)
    return _ref.refill_round_ref(offsets, indices, weights, seed32, lanes,
                                 quota=quota, out_cap=out_cap,
                                 max_sets=max_sets, ec=ec, table=table,
                                 dedup=dedup)[:6]


def lt_walk(offsets: torch.Tensor, indices: torch.Tensor,
            rowcum: torch.Tensor, seed32: int, batch: int, *, qcap: int,
            table=None):
    """One sampling round of the LT walk sampler with round seed
    ``seed32`` and ``batch`` lanes: every lane's row seed and root (∝ the
    weights of the alias ``table`` when one is given) and its reverse walk
    on the CSR with row-cumulative weights ``rowcum`` to its end ->
    (queue (B, qcap) int32, lengths (B,) int32, overflowed (B,) bool,
    steps (B,) int64, roots (B,) int32), :func:`queue_bfs`'s layout; the
    same bytes on either route (``ref.lt_round_ref`` says what they
    hold)."""
    if _route(offsets) == "cuda":
        return _lt.lt_walk(offsets, indices, rowcum, seed32, batch,
                           qcap=qcap, table=table)
    return _ref.lt_round_ref(offsets, indices, rowcum, seed32, batch,
                             qcap=qcap, table=table)


def greedy_flat(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                *, n: int, num_rows: int, k: int):
    """``k`` steps of greedy max-coverage on a flat pool: (t,) int32 node ids
    ``flat`` and row ids ``ids`` (rows contiguous and in row order, below
    ``num_rows``), (t,) bool ``valid`` -> (seeds (k,) int32, gains (k,)
    int32); the same bytes on either route (``ref.greedy_flat_ref`` says
    what they hold)."""
    if _route(flat) == "cuda":
        return _greedy.greedy_flat(flat, ids, valid, n=n, num_rows=num_rows,
                                   k=k)
    return _ref.greedy_flat_ref(flat, ids, valid, n=n, num_rows=num_rows,
                                k=k)


def occur_flat(flat: torch.Tensor, valid: torch.Tensor, *,
               n: int) -> torch.Tensor:
    """The valid elements of each node of a flat pool (a rank's shard):
    (t,) int32 ``flat``, bool ``valid`` -> (n,) int32; the same bytes on
    either route (``ref.occur_flat_ref``)."""
    if _route(flat) == "cuda":
        return _shard.occur_flat(flat, valid, n=n)
    return _ref.occur_flat_ref(flat, valid, n=n)


def shard_flat_step(flat: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, cov_words: torch.Tensor,
                    u: torch.Tensor, *, n: int) -> torch.Tensor:
    """One seed step of the sharded fused scan on a rank's shard: the rows
    that hold the seed ``u`` (a one-element int64 tensor, never read on the
    host) and are not in ``cov_words`` are ORed into it in place -> the
    (n + 1,) int32 decrement, the new rows' count in slot n; the same bytes
    on either route (``ref.shard_flat_step_ref`` says what they hold)."""
    if _route(flat) == "cuda":
        return _shard.shard_flat_step(flat, ids, valid, cov_words, u, n=n)
    return _ref.shard_flat_step_ref(flat, ids, valid, cov_words, u, n=n)


def greedy_flat_variant(flat: torch.Tensor, ids: torch.Tensor,
                        valid: torch.Tensor, *, n: int, num_rows: int,
                        k: int, cand: torch.Tensor,
                        costs: torch.Tensor | None, budget: float,
                        n_group: int, n_groups: int, group_quota: int,
                        ew: torch.Tensor | None = None):
    """``k`` steps of the problem variants' greedy on a flat pool (the
    pool of :func:`greedy_flat`): candidates ``cand`` (n,) bool, float32
    ``costs`` (n,) and ``budget`` (``costs`` None: no budget), group
    quotas -> ``(seeds (k,) int32, gains (k,) int32, spent () float32)``;
    the same bytes on either route (``ref.greedy_flat_variant_ref`` says
    what they hold).  With ``ew``, the (t,) float32 element weights of a
    row-weighted store, the weighted form: gains (k,) float32, the same
    bytes on either route wherever the weights' float32 sums are exact
    (integer or dyadic weights whose sums stay below 2^24)."""
    if _route(flat) == "cuda":
        return _greedy.greedy_flat_variant(
            flat, ids, valid, n=n, num_rows=num_rows, k=k, cand=cand,
            costs=costs, budget=budget, n_group=n_group, n_groups=n_groups,
            group_quota=group_quota, ew=ew)
    return _ref.greedy_flat_variant_ref(
        flat, ids, valid, n=n, num_rows=num_rows, k=k, cand=cand,
        costs=costs, budget=budget, n_group=n_group, n_groups=n_groups,
        group_quota=group_quota, ew=ew)


def greedy_stacked(flat: torch.Tensor, ids: torch.Tensor,
                   valid: torch.Tensor, *, n: int, num_rows: int, k_max: int,
                   cand: torch.Tensor, costs: torch.Tensor,
                   budget: torch.Tensor, ks: torch.Tensor,
                   quota: torch.Tensor, plain: torch.Tensor,
                   use_costs: torch.Tensor, n_group: int, n_groups: int):
    """R selections on one flat pool (the pool of :func:`greedy_flat`), a
    request a row of the (R, n) ``cand``/``costs`` and the (R,)
    ``budget``/``ks``/``quota``/``plain``/``use_costs`` -> (seeds (R,
    k_max) int32, gains (R, k_max) int32, spent (R,) float32); the same
    bytes on either route (``ref.greedy_stacked_ref`` says what they
    hold)."""
    kw = dict(n=n, num_rows=num_rows, k_max=k_max, cand=cand, costs=costs,
              budget=budget, ks=ks, quota=quota, plain=plain,
              use_costs=use_costs, n_group=n_group, n_groups=n_groups)
    if _route(flat) == "cuda":
        return _greedy.greedy_stacked(flat, ids, valid, **kw)
    return _ref.greedy_stacked_ref(flat, ids, valid, **kw)


def greedy_sketch(words: torch.Tensor, *, n: int, k: int,
                  cand: torch.Tensor | None = None):
    """``k`` steps of the approximate mode's greedy on an (R, W) int32
    sketch whose rows ``v < n`` are the nodes', restricted to the (n,) bool
    candidate mask ``cand`` when one is given -> (seeds (k,), gains (k,),
    steps (1,)) int32; the same bytes on either route
    (``ref.greedy_sketch_ref`` says what they hold)."""
    if _route(words) == "cuda":
        return _greedy.greedy_sketch(words, n=n, k=k, cand=cand)
    return _ref.greedy_sketch_ref(words, n=n, k=k, cand=cand)


def celf_select(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                *, n: int, num_rows: int, k: int, c: int,
                sketch: torch.Tensor | None = None):
    """One selection of the CELF lazy greedy on a flat pool, ``c`` (1 <= c
    <= n) candidates an exact evaluation, with the (R >= n, W) int32
    coverage ``sketch``'s sweep a seed or without one -> ``(seeds (k,)
    int32, gains (k,) int32, stats (2,) int64)``, stats the candidates
    evaluated and the eval calls; the same bytes on either route
    (``ref.celf_select_ref`` says what they hold)."""
    if _route(flat) == "cuda":
        return _celf.celf_select(flat, ids, valid, n=n, num_rows=num_rows,
                                 k=k, c=c, sketch=sketch)[:3]
    return _ref.celf_select_ref(flat, ids, valid, n=n, num_rows=num_rows,
                                k=k, c=c, sketch=sketch)


def celf_eval(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
              cov_words: torch.Tensor, cands: torch.Tensor,
              roww: torch.Tensor | None = None) -> torch.Tensor:
    """CELF's exact evaluation: for each of the (c,) ``cands``, the rows of
    the flat pool that hold it and are not in the packed Covered bitset
    ``cov_words`` -> (c,) int32; the same bytes on either route
    (``ref.celf_eval_ref`` says what they hold).  With ``roww``, the
    (num_rows,) float32 row weights, the float32 sum of those rows'
    weights (the same bytes where the sums are exact, as
    :func:`greedy_flat_variant`'s weighted form)."""
    if _route(flat) == "cuda":
        return _celf.celf_eval(flat, ids, valid, cov_words, cands, roww)
    return _ref.celf_eval_ref(flat, ids, valid, cov_words, cands, roww)


def celf_apply(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
               cov_words: torch.Tensor, u: int,
               roww: torch.Tensor | None = None) -> torch.Tensor:
    """CELF's seed commit: OR the rows that hold node ``u`` into
    ``cov_words`` in place -> the rows that were new, a 0-d int32 tensor on
    the pool's device (``ref.celf_apply_ref``); with ``roww`` the float32
    sum of their weights."""
    if _route(flat) == "cuda":
        return _celf.celf_apply(flat, ids, valid, cov_words, u, roww)
    return _ref.celf_apply_ref(flat, ids, valid, cov_words, u, roww)


def membership_rows(rows: torch.Tensor, lengths: torch.Tensor,
                    u) -> torch.Tensor:
    """``hit[r] = any(rows[r, :lengths[r]] == u)``: (R, L) int32 rows,
    (R,) lengths, ``u`` an int or a one-element tensor -> (R,) bool."""
    if _route(rows) == "cuda":
        return _membership.membership_rows(rows, lengths, u)
    return _ref.membership_rows_ref(rows, lengths, u)


def padded_greedy(rows: torch.Tensor, lengths: torch.Tensor, *, n: int,
                  k: int):
    """``k`` steps of the padded store's greedy: (R, L) int32 rows padded
    past each length, (R,) lengths -> ``(seeds (k,), gains (k,))`` int32;
    the same bytes on either route (``ref.padded_greedy_ref`` says what
    they hold, lanes outside the nodes included)."""
    if _route(rows) == "cuda":
        return _membership.padded_greedy(rows, lengths, n=n, k=k)
    return _ref.padded_greedy_ref(rows, lengths, n=n, k=k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Attention over (B, S, H, D) q, k, v (equal H: repeat the KV heads
    beforehand for GQA), in q's dtype and shape.  ``bq``/``bk`` keep the
    reference's contract (S a multiple of each, once capped at S); the
    kernel tiles the work its own way.  On a card any layout and any D
    run: an input the kernel cannot read is copied once, and D is
    zero-padded to the width the kernel takes (``padded_head_dim``: the
    next one-pass width up to 256, a multiple of 64 above, where the
    column-split kernel runs) and the output sliced back, with the true
    D's scale."""
    _flash.check_blocks(q, k, v, bq, bk)
    if _route(q) == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal)
    d = q.shape[-1]
    width = _flash.padded_head_dim(d)
    if width == d:
        q, k, v = (_flash.kernel_layout(t) for t in (q, k, v))
        return _flash.flash_attention(q, k, v, causal)
    q, k, v = (torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v))
    out = _flash.flash_attention(q, k, v, causal, scale=1.0 / math.sqrt(d))
    return out[..., :d].contiguous()
