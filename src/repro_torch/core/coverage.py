"""The device RR pool and greedy max-coverage (paper Alg. 6 pool, Alg. 7).

:class:`DeviceRRStore` is the reference's ``ShardedDeviceRRStore`` on one
device: the flat concatenated pool ``flat`` (node ids, sentinel ``n`` past
the live extent), ``ids`` (row id of every element) and ``valid``, with the
same initial capacity, the same doubling and the same growth headroom, so
its buffers equal the reference's shard 0 element for element.  The host
keeps exact mirrors of the element and row counts (one device read per
append, gIM's ``N_RR`` readback).

Selection (:func:`select_seeds_device`):

* ``flat`` — the reference's fused scan, all k steps in one launch of
  the ``greedy_flat`` CUDA kernel (``kernels.ops.greedy_flat``; the plain
  version, the reference's loop of scatter-adds over the pool and a packed
  Covered bitset, on the CPU).  The pool's row-major and node-major
  indices are built on the card, so a step touches only its seed's rows
  and their elements, and the selection makes no host sync.
* ``bitset`` — Alg. 7 on the packed (row_capacity, ceil(n/32)) membership
  matrix: the initial Occur and each seed's Occur decrement are the two
  hand-written CUDA kernels (``kernels/ops.py``; the plain versions on the
  CPU).
* ``auto`` — ``bitset`` iff the bit matrix is no larger than the pool's
  capacity, the reference's rule.
* ``celf`` (:func:`select_seeds_celf`) — the reference's CELF lazy greedy
  (upper bounds, a sweep of the store's coverage sketch a seed, exact
  evaluations of ``eval_batch`` candidates, a commit a seed), the whole
  selection one launch of the ``celf_select`` CUDA kernel and one host
  read (``kernels.ops.celf_select``; the plain version on the CPU).

A store built with ``sketch_k`` keeps the reference's incremental
coverage sketch: each append folds its batch (one ``sketch_fold_rows``
launch) under the row ids it writes.  Without one, :meth:`sketch_words`
builds the sketch from the pool on demand.

A third layout, :class:`PaddedStore` (the pool as an (R, L) matrix padded
with n, the reference's layout for its TPU membership kernel), has its
own greedy, :func:`select_seeds_padded`: all k steps, the membership scans
and the Occur updates, are one launch of the ``padded_greedy`` CUDA
kernel (``kernels.ops.padded_greedy``; the plain loop on the CPU).

The problem variants (candidates, costs and a budget, group quotas: a
:class:`SelectionSpec`) run :func:`select_variant`, the reference's
generalised scan: ``flat`` is one launch of the ``greedy_flat_variant``
CUDA kernel (``kernels.ops.greedy_flat_variant``), ``bitset`` the same
device loop as the plain one with the feasibility and score on the card,
and ``celf`` (:func:`select_seeds_celf` with ``spec``) the reference's
host loop of sweeps, exact evaluations and commits.  A store built with
``row_weighted=True`` (the importance-weighted estimator of weighted IM on
an engine that draws uniform roots) keeps each element's row weight, and a
``weighted`` spec scores every one of these scans by covered weight: the
weighted form of ``greedy_flat_variant``, a torch loop for ``bitset``, and
the weighted forms of ``celf_eval`` and ``celf_apply``.

:func:`select_seeds_stacked` is serving's batched selection (the
reference's ``select_seeds_stacked`` on one device): R requests, plain or
variant, in one scan over the shared pool, one launch of the
``greedy_stacked`` CUDA kernel (``kernels.ops.greedy_stacked``; the plain
loop on the CPU), each row the solo ``flat`` scan's bytes.

All these scans take ties to the lowest node id (``torch.argmax`` and
``np.argmax`` return the first maximum; the bit matrix's padding ids past
n have Occur 0) and give seeds, gains and ``frac`` identical to each other
and to the reference's ``fused`` scan on the same pool.

:class:`SketchRRStore` is the pool-free store of the approximate mode (the
reference's ``SketchRRStore`` on one device): each batch folds straight
into packed per-node occupancy sketches and no pool buffer exists.
:func:`select_seeds_sketch` is its greedy on sketch estimates, with a
certified error bound instead of exact marginals: all k steps in one
launch of the ``greedy_sketch`` CUDA kernel (``kernels.ops.greedy_sketch``;
the plain version on the CPU) and one host read a selection.

:class:`ShardedDeviceRRStore` deals the pool over the ranks of a sampling
mesh (``repro_torch.launch.mesh``), rank d holding the reference's shard
d, and the plain selections on it run the reference's sharded protocol
(DESIGN.md §5) with ``all_reduce`` as its ``psum``: ``flat`` is
``occur_flat`` and a ``shard_flat_step`` a seed on each shard (CUDA
kernels of ``csrc/shard.cu``), ``bitset`` the Occur kernels on each
shard's block, CELF the reference's lazy loop with a striped sweep.  The
host-list API (:class:`RRStore`, :func:`build_store`,
:class:`IncrementalRRStore`, :func:`merge_stores`, :func:`select_seeds`,
:func:`shard_stores`, :func:`select_seeds_sharded`) is the reference's on
host-compacted pools.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import numpy as np

from repro_torch.core import sketch as sketch_mod
from repro_torch.core.packing import bit_values, rank_positions
from repro_torch.core.variant import VariantScan, row_weights, weighted_occur
from repro_torch.device import resolve_device
from repro_torch.ft.failures import PoolAllocError
from repro_torch.kernels import ops as kops

_PACK = 1 << 15   # growth headroom of a wide append (the reference's _PACK)


def _ceil_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _shard0(a, dtype, shape: tuple, device) -> torch.Tensor:
    """Shard 0 of a (1, ...) state array, checked against ``shape`` and
    ``dtype``, as a tensor on ``device``."""
    a = _host(a)
    if a.shape != (1,) + shape or a.dtype != dtype:
        raise ValueError(f"state array must be {(1,) + shape} "
                         f"{np.dtype(dtype)}, got {a.shape} {a.dtype}")
    return torch.from_numpy(np.array(a[0])).to(device)


def _uint32_words(words: torch.Tensor) -> np.ndarray:
    """(1, R, W) uint32 host copy of int32 sketch words (the reference's
    state layout, the same bits)."""
    return words.cpu().numpy().view(np.uint32)[None]


def _int32_words(words, shape, device) -> torch.Tensor:
    """int32 sketch words of ``shape`` on ``device`` from the reference's
    (1, R, W) uint32 state words or from (R, W) int32 words (a tensor stays
    on its device until it moves to ``device``)."""
    if not isinstance(words, torch.Tensor):
        a = np.asarray(words)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        words = torch.from_numpy(np.array(a))
    if words.dim() == 3 and words.shape[0] == 1:
        words = words[0]
    if words.dtype != torch.int32 or tuple(words.shape) != tuple(shape):
        raise ValueError(f"sk_words must be {tuple(shape)} int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    return words.to(device).contiguous()


class CoverageResult(NamedTuple):
    seeds: torch.Tensor   # (k,) int32
    gains: torch.Tensor   # (k,) int32 — newly covered RR sets per seed
    frac: torch.Tensor    # () float32 — F_R(S): covered fraction


class _FoldedSketch:
    """What both stores with an incremental sketch share: its (1,) int32
    flag ``fold_error`` and the check of a requested bucket count."""

    def check_folds(self, flag: int) -> None:
        """Raise if ``flag``, the host's read of :attr:`fold_error`, says
        that a fold met a bucket outside the sketch."""
        if flag:
            raise ValueError(f"a fold met a bucket outside [0, "
                             f"{self.sketch_k})")

    def _check_k(self, k: int | None) -> None:
        if k is not None and sketch_mod.resolve_sketch_k(k) != self.sketch_k:
            raise ValueError(
                f"store maintains an incremental sketch of k="
                f"{self.sketch_k}; requested k={k} cannot be honored")


class DeviceRRStore(_FoldedSketch):
    """Growing CSR-of-RR pool on one device (see the module docstring).

    With ``sketch_k`` set, every append also folds its batch into an
    incremental coverage sketch (:meth:`sketch_words`), the (n + 1,
    sketch_k/32) int32 words of the reference's store under the same
    batch-order row ids; ``fold_error`` is its (1,) int32 flag, read as
    :class:`SketchRRStore` reads its own.
    """

    DEFAULT_SKETCH_K = 1024

    def __init__(self, n_nodes: int, capacity: int = 4096, *,
                 sketch_k: int | None = None, sketch_mode: str = "mod",
                 row_weighted: bool = False, device="cuda"):
        if n_nodes >= 2 ** 31 - 1:
            raise ValueError("item space must fit int32")
        if sketch_mode not in ("mod", "mix"):
            raise ValueError(f"unknown sketch hash mode {sketch_mode!r}")
        self.n_nodes = n_nodes
        self.device = resolve_device(device)
        cap = _ceil_pow2(max(capacity, 1))
        self.flat = torch.full((cap,), n_nodes, dtype=torch.int32,
                               device=self.device)
        self.ids = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        # the row-weighted store (the importance-weighted estimator): ew is
        # each element's row weight, so weighted Occur is one scatter-add of
        # it, and wsum the float32 total weight of the non-empty rows (the
        # weighted F_R denominator)
        self.row_weighted = bool(row_weighted)
        self.ew = (torch.zeros(cap, dtype=torch.float32, device=self.device)
                   if self.row_weighted else None)
        self.wsum = (torch.zeros((), dtype=torch.float32, device=self.device)
                     if self.row_weighted else None)
        self._t = 0        # host mirrors (exact)
        self._nrr = 0
        self._bitset = None
        self.sketch_mode = sketch_mode
        self.sketch_k = (sketch_mod.resolve_sketch_k(sketch_k)
                         if sketch_k is not None else None)
        self.sketch_rows = n_nodes + 1
        self._sk_words = (torch.zeros(
            (self.sketch_rows, self.sketch_k // 32), dtype=torch.int32,
            device=self.device) if self.sketch_k is not None else None)
        self.fold_error = torch.zeros(1, dtype=torch.int32,
                                      device=self.device)
        self._sk_cache = None   # on-demand sketch (no incremental one)
        # the growth gate, called (store, newcap) before any growth
        # allocation; it may raise PoolAllocError (the fault policy's
        # "grow" site), and the append has mutated nothing by then, so a
        # refused growth is retryable
        self.alloc_check = None
        # rows and elements of each append that added rows (a sampling
        # round): the granularity of windowed eviction, oldest first
        self._round_rows: list[int] = []
        self._round_elems: list[int] = []

    @property
    def n_rr(self) -> int:
        return self._nrr

    @property
    def n_elems(self) -> int:
        return self._t

    @property
    def capacity(self) -> int:
        return int(self.flat.shape[0])

    @property
    def n_rounds(self) -> int:
        """Sampling rounds (appends that added rows) still in the pool."""
        return len(self._round_rows)

    def per_device_pool_bytes(self) -> int:
        """Pool bytes on the device: flat, ids and valid (9 bytes a slot),
        and the element weights on a row-weighted store (13)."""
        return self.capacity * (4 + 4 + 1 + (4 if self.row_weighted else 0))

    def config(self) -> dict:
        """The store's construction parameters, as the reference's
        ``ShardedDeviceRRStore.config`` on one shard."""
        return {"n_nodes": int(self.n_nodes),
                "per_shard_capacity": self.capacity, "n_shards": 1,
                "sketch_k": self.sketch_k, "sketch_mode": self.sketch_mode,
                "row_weighted": self.row_weighted}

    def append_batch(self, batch, row_w=None) -> None:
        """Append one batch (an ``RRBatch`` or ``(nodes, lengths)``).

        Rows of length 0 are padding and get no row id.  Elements land in
        row-major order at ``[t, t + elems)``: their source positions come
        from :func:`rank_positions` over the prefix sum of the length mask,
        their row ids from the prefix sum of the non-empty rows.  A wide
        batch (``R*W > 2^15`` holding at most 2^15 elements) reserves 2^15
        elements of headroom before it grows the buffers, as the
        reference's packed append does; when that growth fails with
        :class:`PoolAllocError` (the ``alloc_check`` gate), it grows to the
        exact footprint instead before the failure goes up.

        ``row_w``, the (R,) row weights, is required on a row-weighted
        store and refused on any other: a row's weight, rounded to float32,
        lands on each of its elements, and the non-empty rows' weights are
        summed in float32 into ``wsum``, once an append.
        """
        nodes, lens, roww = self._batch_arrays(batch, row_w)
        r, w = nodes.shape
        lens = lens.to(torch.int64).clamp(0, w)
        row_valid = lens > 0
        counts = [lens.sum(), row_valid.sum()]
        if self._sk_words is not None:       # the last fold's flag, too
            counts.append(self.fold_error[0].to(torch.int64))
        elems, rows, *bad = (int(x) for x in torch.stack(counts).cpu())
        self.check_folds(sum(bad))
        wide = r * w > _PACK and elems <= _PACK
        self._reserve(self._t + (_PACK if wide else elems),
                      self._t + elems, wide)
        if self._sk_words is not None:
            # after the growth, before the counters move: the reference's
            # order, so the fold numbers the rows as the append does
            self.fold_batch(nodes, lens)
        self._write(nodes, lens, row_valid, elems, rows, roww)

    def _batch_arrays(self, batch, row_w):
        """(nodes (R, W), lengths (R,), row weights or None) of a batch on
        the store's device, checked."""
        nodes, lens = ((batch.nodes, batch.lengths)
                       if hasattr(batch, "nodes") else batch)
        nodes = torch.as_tensor(nodes, device=self.device)
        lens = torch.as_tensor(lens, device=self.device)
        if nodes.dim() != 2 or lens.shape != (nodes.shape[0],):
            raise ValueError("append_batch wants padded (R, W) nodes + (R,) "
                             "lengths")
        roww = None
        if self.row_weighted:
            if row_w is None:
                raise ValueError("row_weighted store needs row_w= per append")
            roww = torch.as_tensor(row_w, device=self.device).to(
                torch.float32)
            if roww.shape != (nodes.shape[0],):
                raise ValueError("row_w must be (R,) aligned with the batch")
        elif row_w is not None:
            raise ValueError("row_w given but the store was built without "
                             "row_weighted=True")
        return nodes, lens, roww

    def _reserve(self, need: int, exact: int, wide: bool) -> None:
        """Grow to ``need`` elements before an append (``exact``: the
        append's own footprint, ``wide``: whether ``need`` holds the wide
        append's headroom).  When that growth fails with
        :class:`PoolAllocError`, a wide append grows to ``exact`` instead
        before the failure goes up, as the reference's does."""
        if need <= self.capacity:
            return
        try:
            self._grow_to(need)
        except PoolAllocError:
            if not wide or exact >= need:
                raise
            if exact > self.capacity:
                self._grow_to(exact)

    def _write(self, nodes, lens, row_valid, elems: int, rows: int,
               roww=None) -> None:
        """Write a batch's ``elems`` elements and ``rows`` non-empty rows
        (``lens`` clamped to the width) at the end of the pool."""
        r, w = nodes.shape
        rid = self._nrr + row_valid.cumsum(0) - 1
        if elems:
            t = self._t
            mask = torch.arange(w, device=self.device)[None, :] < lens[:, None]
            src = rank_positions(mask.reshape(-1).cumsum(0), elems, r * w)
            self.flat[t:t + elems] = nodes.reshape(-1)[src].to(torch.int32)
            self.ids[t:t + elems] = rid[src // w].to(torch.int32)
            self.valid[t:t + elems] = True
            if self.row_weighted:
                self.ew[t:t + elems] = roww[src // w]
        if self.row_weighted:
            self.wsum = self.wsum + torch.where(row_valid, roww, 0.0).sum(
                dtype=torch.float32)
        self._t += elems
        self._nrr += rows
        if rows:
            self._round_rows.append(rows)
            self._round_elems.append(elems)
        self._bitset = None
        self._sk_cache = None

    def fold_batch(self, nodes: torch.Tensor, lens: torch.Tensor) -> None:
        """Fold a padded batch into the incremental sketch, its non-empty
        rows under the ids ``n_rr``, ``n_rr + 1``, ... that the append
        gives them (``sketch.fold_frontier_packed``: one
        ``sketch_fold_rows`` launch on the card)."""
        sketch_mod.fold_frontier_packed(self._sk_words, nodes, lens,
                                        self.n_rr, k=self.sketch_k,
                                        mode=self.sketch_mode)

    def sketch_bytes(self) -> int:
        """Bytes of the incremental sketch (0 without one)."""
        if self._sk_words is None:
            return 0
        return self.sketch_rows * (self.sketch_k // 32) * 4

    def sketch_words(self, k: int | None = None) -> torch.Tensor:
        """(n + 1, k/32) int32 packed per-node coverage sketch.

        A store built with ``sketch_k`` returns its incremental fold (a
        ``k`` other than its own raises ``ValueError``); any other builds
        one from the pool on demand (``k`` default
        :attr:`DEFAULT_SKETCH_K`), cached until the next append."""
        if self._sk_words is not None:
            self._check_k(k)
            return self._sk_words
        kk = sketch_mod.resolve_sketch_k(k if k is not None
                                         else self.DEFAULT_SKETCH_K)
        if self._sk_cache is None or self._sk_cache.shape[1] != kk // 32:
            t = self._t
            self._sk_cache = sketch_mod.sketch_packed_from_flat(
                self.flat[:t], self.ids[:t], self.valid[:t],
                n_rows=self.sketch_rows, k=kk, mode=self.sketch_mode)
        return self._sk_cache

    def _grow_to(self, need: int) -> None:
        """Double the capacity until ``need`` elements fit, gated by
        ``alloc_check`` (which may raise :class:`PoolAllocError` before
        anything is allocated)."""
        newcap = self.capacity
        while newcap < need:
            newcap *= 2
        if self.alloc_check is not None:
            self.alloc_check(self, newcap)
        pad = newcap - self.capacity
        self.flat = torch.cat([self.flat, torch.full(
            (pad,), self.n_nodes, dtype=torch.int32, device=self.device)])
        self.ids = torch.cat([self.ids, torch.zeros(
            pad, dtype=torch.int32, device=self.device)])
        self.valid = torch.cat([self.valid, torch.zeros(
            pad, dtype=torch.bool, device=self.device)])
        if self.row_weighted:
            self.ew = torch.cat([self.ew, torch.zeros(
                pad, dtype=torch.float32, device=self.device)])

    # -- checkpoint state ----------------------------------------------
    def state(self) -> dict:
        """The store as host numpy arrays in the layout of the reference's
        ``ShardedDeviceRRStore.state()`` on one shard: ``flat``, ``ids``,
        ``valid`` (and ``ew``) as (1, capacity), the counters ``t_dev``/
        ``nrr_dev`` (1,) int32 and ``t_loc``/``nrr_loc`` (1,) int64, the
        float32 ``w_dev`` (1,) of a row-weighted store, the sketch
        ``sk_words`` (1, n + 1, sketch_k/32) uint32 (the bits of the int32
        words), and the round history ``round_rows``/``round_elems``
        (rounds, 1) int64 when there is one.  :meth:`from_state` rebuilds
        the store from it, and so does the reference's ``from_state``."""
        t, nrr = self._t, self._nrr
        out = {"flat": self.flat, "ids": self.ids, "valid": self.valid}
        if self.row_weighted:
            out["ew"] = self.ew
        out = {k: v.cpu().numpy()[None] for k, v in out.items()}
        out["t_dev"] = np.array([t], np.int32)
        out["nrr_dev"] = np.array([nrr], np.int32)
        if self.row_weighted:
            out["w_dev"] = self.wsum.cpu().numpy().reshape(1)
        if self._sk_words is not None:
            out["sk_words"] = _uint32_words(self._sk_words)
        out["t_loc"] = np.array([t], np.int64)
        out["nrr_loc"] = np.array([nrr], np.int64)
        if self._round_rows:
            out["round_rows"] = np.array(self._round_rows,
                                         np.int64).reshape(-1, 1)
            out["round_elems"] = np.array(self._round_elems,
                                          np.int64).reshape(-1, 1)
        return out

    @classmethod
    def from_state(cls, state: dict, config: dict, *, device="cuda"):
        """A store holding ``state`` (:meth:`state`'s layout, numpy arrays
        or tensors, the reference's one-shard state too) with the
        construction parameters ``config`` (:meth:`config`'s), on the
        named ``device``.  A state without a round history (saved before
        the pool kept one) counts as one round; one whose row holds a node
        twice raises ``ValueError`` (the samplers never write one)."""
        if int(config.get("n_shards", 1)) != 1:
            raise ValueError(
                f"pool checkpoint was saved on {config['n_shards']} shard(s) "
                "but the port's store has one; restore onto one shard")
        cap = int(config["per_shard_capacity"])
        store = cls(config["n_nodes"], capacity=cap,
                    sketch_k=config["sketch_k"],
                    sketch_mode=config["sketch_mode"],
                    row_weighted=config["row_weighted"], device=device)
        if store.capacity != cap:
            raise ValueError("per-shard capacity drifted across restore")
        dev = store.device
        store.flat = _shard0(state["flat"], np.int32, (cap,), dev)
        store.ids = _shard0(state["ids"], np.int32, (cap,), dev)
        store.valid = _shard0(state["valid"], np.bool_, (cap,), dev)
        if store.row_weighted:
            store.ew = _shard0(state["ew"], np.float32, (cap,), dev)
            store.wsum = _shard0(state["w_dev"], np.float32, (), dev)
        if store._sk_words is not None:
            store._sk_words = _int32_words(state["sk_words"],
                                           store._sk_words.shape, dev)
        store._t = int(np.sum(_host(state["t_loc"])))
        store._nrr = int(np.sum(_host(state["nrr_loc"])))
        t = store._t
        key = store.ids[:t].to(torch.int64) * (store.n_nodes + 1) \
            + store.flat[:t].to(torch.int64)
        key = key.sort().values
        if bool((key[1:] == key[:-1]).any()):
            # the greedy scans read a step's gain off Occur, which counts
            # newly covered rows only when a row holds each node once
            raise ValueError("the restored pool holds a node twice in one "
                             "row; the selections need row-unique rows")
        rr = state.get("round_rows")
        if rr is not None:
            store._round_rows = [int(x) for x in _host(rr).reshape(-1)]
            store._round_elems = [int(x) for x in
                                  _host(state["round_elems"]).reshape(-1)]
        elif store._nrr:
            store._round_rows, store._round_elems = [store._nrr], [store._t]
        return store

    # -- windowed eviction ----------------------------------------------
    def _rewrite(self, flat, ids, ew, rows: int) -> dict:
        """Rebuild the pool from the survivors: elements ``flat`` with dense
        renumbered row ids ``ids`` in ``[0, rows)`` (non-decreasing, in
        pool order) and, on a row-weighted store, their weights ``ew``; all
        on the device.  The buffers take the smallest power-of-two
        capacity that holds them (no append headroom), the bitset and
        sketch caches go, and the incremental sketch rebuilds from the
        survivors (``sketch_packed_from_flat``: one ``sketch_scatter_or``
        launch on the card), which a later append's fold continues
        (``base = n_rr``).  The row-weighted total is the float32 sum of
        one element's weight a row, summed in numpy as the reference sums
        it.  Returns the reference's stats dict."""
        old_rows, old_elems = self._nrr, self._t
        t = int(flat.shape[0])
        cap = _ceil_pow2(max(t, 1))
        dev = self.device
        self.flat = torch.full((cap,), self.n_nodes, dtype=torch.int32,
                               device=dev)
        self.ids = torch.zeros(cap, dtype=torch.int32, device=dev)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.flat[:t] = flat
        self.ids[:t] = ids
        self.valid[:t] = True
        if self.row_weighted:
            self.ew = torch.zeros(cap, dtype=torch.float32, device=dev)
            self.ew[:t] = ew
            first = torch.ones(t, dtype=torch.bool, device=dev)
            first[1:] = ids[1:] != ids[:-1]
            total = ew[first].cpu().numpy().sum(dtype=np.float32)
            self.wsum = torch.tensor(np.float32(total), device=dev)
        self._t, self._nrr = t, int(rows)
        if self._sk_words is not None:
            self._sk_words = sketch_mod.sketch_packed_from_flat(
                self.flat[:t], self.ids[:t], self.valid[:t],
                n_rows=self.sketch_rows, k=self.sketch_k,
                mode=self.sketch_mode)
        self._bitset = None
        self._sk_cache = None
        return {"rows_dropped": old_rows - self._nrr,
                "rows_kept": self._nrr,
                "elems_dropped": old_elems - self._t,
                "per_shard_capacity": self.capacity}

    def _live(self):
        t = self._t
        return (self.flat[:t], self.ids[:t],
                self.ew[:t] if self.row_weighted else None)

    def evict_earliest_rounds(self, n_rounds: int) -> dict:
        """Drop the ``n_rounds`` earliest sampling rounds (a windowed pool).

        Row ids and elements are in append order, so the earliest rounds
        are the id prefix ``[0, thr)`` and an element prefix: the
        survivors keep their order and renumber by one subtraction, on the
        device.  Returns the :meth:`_rewrite` stats and
        ``rounds_dropped``."""
        n_rounds = max(0, min(int(n_rounds), self.n_rounds))
        if n_rounds == 0:
            return {"rows_dropped": 0, "rows_kept": self.n_rr,
                    "elems_dropped": 0, "per_shard_capacity": self.capacity}
        thr = sum(self._round_rows[:n_rounds])
        cut = sum(self._round_elems[:n_rounds])
        flat, ids, ew = self._live()
        stats = self._rewrite(flat[cut:], ids[cut:] - thr,
                              None if ew is None else ew[cut:],
                              self._nrr - thr)
        self._round_rows = self._round_rows[n_rounds:]
        self._round_elems = self._round_elems[n_rounds:]
        stats["rounds_dropped"] = n_rounds
        return stats

    def evict_to_bytes(self, max_bytes_per_device: int) -> dict:
        """Drop the earliest rounds until :meth:`per_device_pool_bytes`
        fits ``max_bytes_per_device``.  The latest round always stays (the
        returned ``met`` says whether the bound holds).  When no round need
        go but the capacity alone exceeds the bound (the append's
        headroom), the pool compacts to the smallest power-of-two capacity
        and keeps every row."""
        bpe = 4 + 4 + 1 + (4 if self.row_weighted else 0)
        elems = self._round_elems

        def bytes_after(j):
            return _ceil_pow2(max(sum(elems[j:]), 1)) * bpe

        drop = 0
        while drop < max(len(elems) - 1, 0) and \
                bytes_after(drop) > max_bytes_per_device:
            drop += 1
        if drop == 0 and \
                self.per_device_pool_bytes() > max_bytes_per_device:
            stats = self._rewrite(*self._live(), self._nrr)
            stats["rounds_dropped"] = 0
        else:
            stats = self.evict_earliest_rounds(drop)
        stats["met"] = self.per_device_pool_bytes() <= max_bytes_per_device
        return stats

    def evict_rows_containing(self, nodes) -> dict:
        """Drop every RR row that contains one of ``nodes`` (the
        invalidation of ``IMMSolver.resolve_incremental``: the nodes whose
        reverse-adjacency rows an edge delta changes,
        :func:`repro_torch.core.stream.affected_nodes`).  The rows hit, the
        survivors' dense renumbering and the compaction run on the device;
        the round history becomes one round (this eviction cuts across
        rounds).  Returns the :meth:`_rewrite` stats and
        ``affected_nodes``."""
        aff = np.unique(np.asarray(nodes, np.int64).reshape(-1))
        flat, ids, ew = self._live()
        ids = ids.to(torch.int64)
        hit = torch.isin(flat.to(torch.int64),
                         torch.from_numpy(aff).to(self.device))
        bad = torch.zeros(self._nrr, dtype=torch.bool, device=self.device)
        bad[ids[hit]] = True
        good = ~bad
        rank = good.cumsum(0) - 1
        keep = good[ids]
        stats = self._rewrite(flat[keep], rank[ids[keep]].to(torch.int32),
                              None if ew is None else ew[keep],
                              int(good.sum()))
        self._round_rows = [self._nrr] if self._nrr else []
        self._round_elems = [self._t] if self._nrr else []
        stats["affected_nodes"] = int(aff.shape[0])
        return stats

    def row_capacity(self) -> int:
        """Row bound of the selection: the next power of two ≥ n_rr, and at
        least 32 so the Covered bitset packs whole words."""
        return max(32, _ceil_pow2(max(self._nrr, 1)))

    def bitset_matrix(self) -> torch.Tensor:
        """(row_capacity, ceil(n/32)) int32 packed membership matrix
        (cached until the next append)."""
        num_rows = self.row_capacity()
        n_words = (self.n_nodes + 31) // 32
        if self._bitset is None or \
                self._bitset.shape != (num_rows, n_words):
            self._bitset = bitset_from_flat(
                self.flat[:self._t], self.ids[:self._t],
                self.valid[:self._t], num_rows=num_rows, n_words=n_words)
        return self._bitset

    def select(self, k: int, method: str = "auto",
               spec: "SelectionSpec | None" = None,
               eval_batch: int | None = None):
        """Greedy selection: ``method`` is ``"flat"``, ``"bitset"``,
        ``"auto"`` (:func:`select_seeds_device`) or ``"celf"`` /
        ``"celf-sketch"`` (:func:`select_seeds_celf`, ``eval_batch``
        candidates an exact evaluation; its default when None).  A
        ``spec`` runs the variant greedy (:func:`select_variant`, or the
        CELF variant) and returns a :class:`VariantResult`."""
        if method in ("celf", "celf-sketch"):
            return select_seeds_celf(
                self, k, spec=spec,
                eval_batch=32 if eval_batch is None else eval_batch)
        if spec is not None:
            return select_variant(self, spec, method=method)
        return select_seeds_device(self, k, method=method)


def not_sharded(what: str) -> NotImplementedError:
    """The error of a path that the sharded pool does not run yet."""
    return NotImplementedError(f"{what}: not ported to the sharded pool "
                               "yet (ROADMAP [9b])")


class ShardedDeviceRRStore(DeviceRRStore):
    """The pool dealt over the ranks of a sampling mesh (the reference's
    ``ShardedDeviceRRStore``; DESIGN.md §4–5).

    Each rank holds one shard, rank d the reference's shard d element for
    element: ``flat``/``ids``/``valid`` are the rank's buffers, row ids are
    local, and an append deals the batch's rows in contiguous blocks of
    ``ceil(R / D)`` (the tail rank takes the padding).  Every rank keeps
    the exact element and row counts of every shard (``_t_loc``,
    ``_nrr_loc``): they cost one ``all_reduce`` of a (D, 2) int32 tensor an
    append and one host read.  All shards grow together: each rank doubles
    its capacity to the largest shard's need, with the reference's ``_PACK``
    headroom for a wide batch, so the capacities stay equal.  ``n_rr`` and
    ``n_elems`` are the pool's totals.

    The incremental sketch is replicated: every rank folds the whole batch
    under global batch-order row ids, so its words are the same at any
    world size; its rows are padded to a multiple of D for the striped
    CELF sweep (:meth:`sketch_words_mesh`), and :meth:`sketch_words` is the
    (n + 1)-row view.  A batch a rank sampled as its block
    (:class:`~repro_torch.core.engine.ShardedBatch` of the same mesh) is
    appended as the rank's shard; the rows are gathered only for the
    sketch's fold.

    With one rank the buffers are :class:`DeviceRRStore`'s and every path
    of it works; with more, the variant and stacked selections, the state
    of a checkpoint and the evictions raise ``NotImplementedError``.
    """

    def __init__(self, n_nodes: int, capacity: int = 4096, *,
                 sketch_k: int | None = None, sketch_mode: str = "mod",
                 mesh, row_weighted: bool = False):
        d = mesh.size
        if row_weighted and d > 1:
            raise not_sharded("the row-weighted store on more than one "
                              "rank")
        super().__init__(n_nodes, capacity=-(-capacity // d),
                         sketch_mode=sketch_mode, row_weighted=row_weighted,
                         device=mesh.device)
        self.mesh = mesh
        self.n_shards = d
        self.rank = mesh.rank
        self._t_loc = np.zeros(d, np.int64)      # every shard's counts
        self._nrr_loc = np.zeros(d, np.int64)
        self.sketch_k = (sketch_mod.resolve_sketch_k(sketch_k)
                         if sketch_k is not None else None)
        self.sketch_rows = -(-(n_nodes + 1) // d) * d
        self._sk_words = (torch.zeros(
            (self.sketch_rows, self.sketch_k // 32), dtype=torch.int32,
            device=self.device) if self.sketch_k is not None else None)

    @property
    def n_rr(self) -> int:
        return int(self._nrr_loc.sum())

    @property
    def n_elems(self) -> int:
        return int(self._t_loc.sum())

    def config(self) -> dict:
        return dict(super().config(), n_shards=self.n_shards)

    def append_batch(self, batch, row_w=None) -> None:
        """Deal one batch over the shards and append this rank's block.

        A replicated batch (an ``RRBatch`` or ``(nodes, lengths)``, the same
        on every rank) is cut into D blocks of ``ceil(R / D)`` rows; a
        :class:`~repro_torch.core.engine.ShardedBatch` of this mesh already
        is this rank's block.  One ``all_reduce`` of the (D, 2) counts and
        one host read (with the sketch's fold flag) give every shard's
        elements and non-empty rows; the growth follows the reference's
        rule over all shards, then the fold of the whole batch, then the
        block's write (:meth:`DeviceRRStore._write`)."""
        from repro_torch.core.engine import ShardedBatch
        mesh, d = self.mesh, self.n_shards
        nodes, lens, roww = self._batch_arrays(batch, row_w)
        if isinstance(batch, ShardedBatch):
            if batch.mesh is not mesh:
                raise ValueError("sharded batch of another mesh")
            rloc, w = nodes.shape
            whole = None
        else:
            r, w = nodes.shape
            rloc = -(-r // d)
            lo = min(self.rank * rloc, r)
            hi = min(lo + rloc, r)
            whole = (nodes, lens)
            nodes, lens = nodes[lo:hi], lens[lo:hi]
            roww = None if roww is None else roww[lo:hi]
        lens = lens.to(torch.int64).clamp(0, w)
        row_valid = lens > 0
        cnt = torch.zeros(d, 2, dtype=torch.int32, device=self.device)
        cnt[self.rank, 0] = lens.sum()
        cnt[self.rank, 1] = row_valid.sum()
        mesh.all_reduce(cnt)
        host = [cnt.reshape(-1).to(torch.int64)]
        if self._sk_words is not None:       # the last fold's flag, too
            host.append(self.fold_error.to(torch.int64))
        host = torch.cat(host).cpu().numpy()
        self.check_folds(int(host[2 * d:].sum()))
        elems_l, rows_l = host[:2 * d:2], host[1:2 * d:2]
        wide = rloc * w > _PACK and int(elems_l.max()) <= _PACK
        self._reserve(
            int(((self._t_loc + _PACK) if wide
                 else (self._t_loc + elems_l)).max()),
            int((self._t_loc + elems_l).max()), wide)
        if self._sk_words is not None:
            if whole is None:
                whole = (mesh.gather_rows(nodes, rloc),
                         mesh.gather_rows(lens, rloc))
            self.fold_batch(whole[0], whole[1].to(torch.int64).clamp(0, w))
        self._write(nodes, lens, row_valid, int(elems_l[self.rank]),
                    int(rows_l[self.rank]), roww)
        self._t_loc += elems_l
        self._nrr_loc += rows_l

    def row_capacity(self) -> int:
        """The selection's row bound: the next power of two at or above the
        largest shard's rows, at least 32 (the same on every rank)."""
        return max(32, _ceil_pow2(max(int(self._nrr_loc.max()), 1)))

    def sketch_words_mesh(self, k: int | None = None) -> torch.Tensor:
        """(sketch_rows, k/32) int32 sketch, rows padded to a multiple of
        D.  With ``sketch_k``, the incremental fold; else built on demand
        as the reference builds it: each rank folds its shard under its
        local row ids, and the partial words are ORed over the ranks (a
        zero-filled (D, rows, k/32) buffer summed, then ORed on the
        rank)."""
        if self._sk_words is not None:
            self._check_k(k)
            return self._sk_words
        kk = sketch_mod.resolve_sketch_k(k if k is not None
                                         else self.DEFAULT_SKETCH_K)
        if self._sk_cache is None or self._sk_cache.shape[1] != kk // 32:
            t = self._t
            part = sketch_mod.sketch_packed_from_flat(
                self.flat[:t], self.ids[:t], self.valid[:t],
                n_rows=self.sketch_rows, k=kk, mode=self.sketch_mode)
            parts = self.mesh.gather_rows(part[None], 1)
            words = parts[0].clone()
            for i in range(1, self.n_shards):
                words |= parts[i]
            self._sk_cache = words
        return self._sk_cache

    def sketch_words(self, k: int | None = None) -> torch.Tensor:
        """The (n + 1, k/32) view of :meth:`sketch_words_mesh`, the same
        words at any world size for an incremental sketch."""
        return self.sketch_words_mesh(k)[:self.n_nodes + 1]

    def _one_rank(self, what: str) -> None:
        if self.n_shards > 1:
            raise not_sharded(f"{what} on more than one rank")

    def state(self) -> dict:
        self._one_rank("a pool checkpoint")
        return super().state()

    def _rewrite(self, flat, ids, ew, rows: int) -> dict:
        self._one_rank("eviction")
        stats = super()._rewrite(flat, ids, ew, rows)
        self._t_loc[:] = self._t
        self._nrr_loc[:] = self._nrr
        return stats


def bitset_from_flat(flat, ids, valid, *, num_rows: int,
                     n_words: int) -> torch.Tensor:
    """Pack a flat pool into a (num_rows, n_words) int32 bit matrix.

    Elements are unique within a row (RRBatch contract), so every bit added
    to one word is distinct and the scatter-add is a scatter-or.
    """
    f = flat.to(torch.int64)
    cell = ids.to(torch.int64).clamp(0, num_rows - 1) * n_words + (f >> 5)
    bits = bit_values(flat.device)[f & 31]
    m = torch.zeros(num_rows * n_words, dtype=torch.int32, device=flat.device)
    m.scatter_add_(0, torch.where(valid, cell, 0),
                   torch.where(valid, bits, 0))
    return m.view(num_rows, n_words)


def _frac(gains: torch.Tensor, n_rr: int) -> torch.Tensor:
    """float32(sum of gains) / float32(n_rr), divided on the device (a
    fill, not a copy from the host, so no sync)."""
    return gains.sum().to(torch.float32) / torch.full(
        (), max(n_rr, 1), dtype=torch.float32, device=gains.device)


def _select_flat(store: DeviceRRStore, k: int) -> CoverageResult:
    t = store.n_elems
    seeds, gains = kops.greedy_flat(
        store.flat[:t], store.ids[:t], store.valid[:t], n=store.n_nodes,
        num_rows=store.row_capacity(), k=k)
    return CoverageResult(seeds=seeds, gains=gains,
                          frac=_frac(gains, store.n_rr))


def _select_bitset(store: DeviceRRStore, k: int,
                   reduce=None) -> CoverageResult:
    """The bitset scan on the store's bit matrix: the Occur kernel, then
    each step the masked Occur kernel on the newly covered rows.  With
    ``reduce`` (a sharded store's ``mesh.all_reduce``) ``m`` is this rank's
    block: the Occur is reduced once, and each step's decrement is reduced
    with the new rows' count in its last slot (one collective a step)."""
    m = store.bitset_matrix()
    occur = kops.occur_from_bitset(m)
    if reduce is not None:
        occur = reduce(occur)
    covered = torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        col = m.index_select(1, (u >> 5).view(1))[:, 0]
        hit = ((col >> (u & 31)) & 1) != 0
        newly = hit & ~covered
        if reduce is None:
            occur = occur - kops.occur_from_bitset_masked(m, newly)
            gains.append(newly.sum())
        else:
            dec = reduce(torch.cat([
                kops.occur_from_bitset_masked(m, newly),
                newly.sum(dtype=torch.int32).view(1)]))
            occur = occur - dec[:-1]
            gains.append(dec[-1])
        covered = covered | hit
        seeds.append(u)
    gains = torch.stack(gains).to(torch.int32)
    return CoverageResult(seeds=torch.stack(seeds).to(torch.int32),
                          gains=gains, frac=_frac(gains, store.n_rr))


def _flat_protocol(mesh, flat, ids, valid, *, n: int, num_rows: int,
                   k: int):
    """The sharded fused scan (DESIGN.md §5) on this rank's shard: the
    Occur of every shard summed by one ``all_reduce``, then k steps, each
    the argmax of Occur (the first maximum: the lowest id on ties), one
    ``shard_flat_step`` on the shard (its new rows ORed into the shard's
    Covered words, the decrement and the new rows' count in one (n + 1,)
    vector), one ``all_reduce`` of that vector and ``occur -= dec[:n]``.
    The seeds and gains stay on the device: no host read.  -> (seeds (k,)
    int32, gains (k,) int32)."""
    occur = mesh.all_reduce(kops.occur_flat(flat, valid, n=n))
    cov = torch.zeros(num_rows // 32, dtype=torch.int32, device=flat.device)
    seeds = torch.empty(k, dtype=torch.int64, device=flat.device)
    gains = torch.empty(k, dtype=torch.int32, device=flat.device)
    for s in range(k):
        u = torch.argmax(occur)
        seeds[s] = u
        dec = mesh.all_reduce(kops.shard_flat_step(flat, ids, valid, cov,
                                                   u.view(1), n=n))
        occur -= dec[:n]
        gains[s] = dec[n]
    return seeds.to(torch.int32), gains


def _sharded_flat(store: ShardedDeviceRRStore, k: int) -> CoverageResult:
    t = store._t
    seeds, gains = _flat_protocol(
        store.mesh, store.flat[:t], store.ids[:t], store.valid[:t],
        n=store.n_nodes, num_rows=store.row_capacity(), k=k)
    return CoverageResult(seeds=seeds, gains=gains,
                          frac=_frac(gains, store.n_rr))


def select_seeds_device(store: DeviceRRStore, k: int,
                        method: str = "auto") -> CoverageResult:
    """Greedy selection of ``k`` seeds on the store's pool.  ``method`` is
    ``"flat"``, ``"bitset"`` or ``"auto"`` (see the module docstring).  On a
    :class:`ShardedDeviceRRStore` (a mesh of any size) each runs the
    sharded protocol, ``auto`` by the reference's rule on a shard's bit
    matrix and capacity; the seeds, gains and ``frac`` are the
    single-device scan's on the same pool."""
    if method == "auto":
        n_words = (store.n_nodes + 31) // 32
        method = ("bitset" if store.row_capacity() * n_words <= store.capacity
                  else "flat")
    sharded = isinstance(store, ShardedDeviceRRStore)
    if method == "flat":
        return _sharded_flat(store, k) if sharded else _select_flat(store, k)
    if method == "bitset":
        return _select_bitset(
            store, k, reduce=store.mesh.all_reduce if sharded else None)
    raise ValueError(f"unknown selection method {method!r}")


class SelectionSpec(NamedTuple):
    """The knobs of the problem variants' greedy (host side, numpy).

    ``n_group``/``n_groups``/``group_quota`` split the item space into
    groups of ``n_group`` ids, each of which gives at most
    ``group_quota`` seeds (one group of quota ``k_steps`` for the plain
    variants).  ``cand`` masks the argmax to a candidate set;
    ``costs`` + ``budget`` make it the cost-ratio greedy among affordable
    nodes.  ``weighted`` scores by the row weights of a row-weighted store
    (the importance-weighted estimator): Occur, gains and ``frac`` are
    float32 covered weight.
    """
    k_steps: int                       # scan length / most seeds
    n_group: int                       # group width over the item space
    n_groups: int = 1
    group_quota: int = 1
    cand: object = None                # (n_items,) bool or None
    costs: object = None               # (n_items,) float32 or None
    budget: object = None              # float or None
    weighted: bool = False


class VariantResult(NamedTuple):
    """:class:`CoverageResult` and the budget spent.  The ``flat`` and
    ``bitset`` scans give ``k_steps`` seeds, the sentinel ``n`` (gain 0) at
    the steps with no feasible node; the CELF variant stops there.  Callers
    trim the sentinels."""
    seeds: torch.Tensor   # int32
    gains: torch.Tensor   # int32 newly covered RR sets (float32 weight)
    frac: torch.Tensor    # () float32 — covered fraction
    spent: torch.Tensor   # () float32 — the picked seeds' total cost


def _check_spec(store: DeviceRRStore, spec: SelectionSpec) -> None:
    if spec.weighted and store.ew is None:
        raise ValueError("weighted selection needs a row_weighted store")
    n = store.n_nodes
    if spec.n_group < 1 or spec.n_groups < 1 or \
            spec.n_group * spec.n_groups < n:
        raise ValueError(f"groups of {spec.n_group} ids x {spec.n_groups} "
                         f"must cover the {n} items")
    if spec.k_steps < 1:
        raise ValueError("k_steps must be >= 1")
    for name in ("cand", "costs"):
        a = getattr(spec, name)
        if a is not None and np.shape(a) != (n,):
            raise ValueError(f"spec.{name} must have shape ({n},), got "
                             f"{np.shape(a)}")


def _spec_operands(store: DeviceRRStore, spec: SelectionSpec):
    """(cand (n,) bool, costs (n,) float32 or None without a budget,
    budget float32) of a spec; the arrays on the store's device."""
    n = store.n_nodes
    cand = torch.from_numpy(
        np.ones(n, bool) if spec.cand is None
        else np.asarray(spec.cand, bool).copy()).to(store.device)
    if spec.budget is None:
        return cand, None, np.float32(np.inf)
    costs = torch.from_numpy(
        np.ones(n, np.float32) if spec.costs is None
        else np.asarray(spec.costs, np.float32).copy()).to(store.device)
    return cand, costs, np.float32(spec.budget)


def _wfrac(gains: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """float32(sum of weighted gains) / max(wsum, 1e-30), the weighted F_R,
    on the device."""
    return gains.sum(dtype=torch.float32) / torch.clamp_min(wsum, 1e-30)


def _select_flat_variant(store: DeviceRRStore,
                         spec: SelectionSpec) -> VariantResult:
    t = store.n_elems
    cand, costs, budget = _spec_operands(store, spec)
    seeds, gains, spent = kops.greedy_flat_variant(
        store.flat[:t], store.ids[:t], store.valid[:t], n=store.n_nodes,
        num_rows=store.row_capacity(), k=spec.k_steps, cand=cand,
        costs=costs, budget=float(budget), n_group=spec.n_group,
        n_groups=spec.n_groups, group_quota=spec.group_quota,
        ew=store.ew[:t] if spec.weighted else None)
    frac = (_wfrac(gains, store.wsum) if spec.weighted
            else _frac(gains, store.n_rr))
    return VariantResult(seeds=seeds, gains=gains, frac=frac, spent=spent)


def _select_bitset_variant(store: DeviceRRStore,
                           spec: SelectionSpec) -> VariantResult:
    """The reference's ``bitset_variant``: :func:`_select_bitset`'s device
    loop with the plain scan's step (:class:`VariantScan`: the feasibility
    and score on the card, the first maximum by ``torch.argmax`` and the
    sentinel n at a step with no feasible node); no host read a step.

    Weighted (the reference's ``bitset_variant_w``): the seed's newly
    covered rows still come from the bit matrix, but Occur is the float32
    scatter-add of the pool's element weights (:func:`weighted_occur`), a
    step's gain the float32 sum of its new rows' weights, and each step's
    decrement the weights of their elements, scattered from the flat pool,
    with Occur clamped at 0 after it: torch operations, as the reference
    runs this form without its Pallas Occur kernels."""
    m = store.bitset_matrix()
    n = store.n_nodes
    cand, costs, budget = _spec_operands(store, spec)
    scan = VariantScan(n, cand, costs, float(budget), spec.n_group,
                       spec.n_groups, spec.group_quota)
    covered = torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
    if spec.weighted:
        t = store.n_elems
        flat, ids, valid = store.flat[:t], store.ids[:t], store.valid[:t]
        ew = store.ew[:t]
        row_of = ids.to(torch.int64).clamp(0, m.shape[0] - 1)
        occur = weighted_occur(flat, valid, ew, n)
        roww = row_weights(ids, valid, ew, m.shape[0])
    else:
        occur = kops.occur_from_bitset(m)[:n]
    last_word = m.shape[1] - 1
    seeds, gains = [], []
    for _ in range(spec.k_steps):
        u, ok = scan.pick(occur)
        col = m.index_select(1, (u >> 5).clamp(max=last_word).view(1))[:, 0]
        hit = ((col >> (u & 31)) & 1) != 0
        newly = hit & ~covered & (u < n)
        if spec.weighted:
            gains.append(torch.where(newly, roww, 0.0).sum(
                dtype=torch.float32))
            dec = weighted_occur(flat, newly[row_of] & valid, ew, n)
            occur = torch.clamp_min(occur - dec, 0.0)
        else:
            occur = occur - kops.occur_from_bitset_masked(m, newly)[:n]
            gains.append(newly.sum())
        covered = covered | newly
        scan.commit(u, ok)
        seeds.append(u)
    seeds = torch.stack(seeds).to(torch.int32)
    if spec.weighted:
        gains = torch.stack(gains)
        return VariantResult(seeds=seeds, gains=gains,
                             frac=_wfrac(gains, store.wsum), spent=scan.spent)
    gains = torch.stack(gains).to(torch.int32)
    return VariantResult(seeds=seeds, gains=gains,
                         frac=_frac(gains, store.n_rr), spent=scan.spent)


def select_variant(store: DeviceRRStore, spec: SelectionSpec,
                   method: str = "flat") -> VariantResult:
    """The problem variants' greedy (candidates, a budget, group quotas;
    the reference's ``select_variant``): ``"flat"`` (and ``"auto"``, as in
    the reference) is one ``kops.greedy_flat_variant`` call, ``"bitset"``
    :func:`_select_bitset_variant`.  Both give the reference's seeds,
    gains, ``frac`` and ``spent`` bytes on the same pool."""
    if isinstance(store, ShardedDeviceRRStore):
        store._one_rank("the variant selection")
    _check_spec(store, spec)
    if method == "auto":
        method = "flat"
    if method == "flat":
        return _select_flat_variant(store, spec)
    if method == "bitset":
        return _select_bitset_variant(store, spec)
    raise ValueError(f"unknown selection method {method!r}")


class StackedRequest(NamedTuple):
    """One request's selection knobs inside a stacked batch (host side,
    numpy): a ``plain`` row is :func:`select_seeds_device`'s scan
    (duplicates tolerated); a variant row carries a
    :class:`SelectionSpec`'s candidates, costs, budget and group quota.
    The group geometry is the batch's (:func:`select_seeds_stacked`)."""
    k_steps: int
    plain: bool = True
    cand: object = None                # (n_items,) bool or None
    costs: object = None               # (n_items,) float32 or None
    budget: object = None              # float or None
    quota: int = 0                     # group quota; 0 -> k_steps


class StackedResult(NamedTuple):
    """:func:`select_seeds_stacked`'s outputs: row r of each tensor is the
    solo selection's output for request r.  Rows are padded past
    ``n_requests`` and columns to a power of two ``k_max``; callers slice
    ``[r, :k_steps_r]`` and trim the ``n_items`` sentinel as for
    :class:`VariantResult`."""
    seeds: torch.Tensor   # (R_pad, k_max) int32
    gains: torch.Tensor   # (R_pad, k_max) int32
    frac: torch.Tensor    # (R_pad,) float32
    spent: torch.Tensor   # (R_pad,) float32
    n_requests: int


def stacked_operands(store: DeviceRRStore, reqs: "list[StackedRequest]",
                     *, n_group: int | None = None,
                     n_groups: int = 1) -> dict:
    """``kops.greedy_stacked``'s keywords for ``reqs`` on the store's pool
    (the reference's padding: R and the scan length to powers of two,
    padding rows of no step; a quota of 0 is the request's k_steps), the
    row operands on the store's device."""
    n = store.n_nodes
    r_pad = _ceil_pow2(len(reqs))
    cand = np.ones((r_pad, n), bool)
    costs = np.ones((r_pad, n), np.float32)
    budget = np.full(r_pad, np.inf, np.float32)
    ks = np.zeros(r_pad, np.int32)
    quota = np.zeros(r_pad, np.int32)
    plain = np.ones(r_pad, bool)
    use_costs = np.zeros(r_pad, bool)
    for i, r in enumerate(reqs):
        ks[i] = r.k_steps
        quota[i] = r.quota if r.quota else r.k_steps
        plain[i] = r.plain
        use_costs[i] = r.budget is not None
        if r.cand is not None:
            cand[i] = np.asarray(r.cand, bool)
        if r.costs is not None:
            costs[i] = np.asarray(r.costs, np.float32)
        if r.budget is not None:
            budget[i] = np.float32(r.budget)
    rows = {k: torch.from_numpy(v).to(store.device) for k, v in (
        ("cand", cand), ("costs", costs), ("budget", budget), ("ks", ks),
        ("quota", quota), ("plain", plain), ("use_costs", use_costs))}
    return dict(rows, n=n, num_rows=store.row_capacity(),
                k_max=_ceil_pow2(max(max(r.k_steps for r in reqs), 1)),
                n_group=n if n_group is None else n_group, n_groups=n_groups)


def select_seeds_stacked(store: DeviceRRStore, reqs: "list[StackedRequest]",
                         *, n_group: int | None = None,
                         n_groups: int = 1) -> StackedResult:
    """R mixed requests (k, candidates, budget, group quota) in one scan
    over the shared pool: the reference's ``select_seeds_stacked`` on one
    device, one ``kops.greedy_stacked`` call (one launch on the card) on
    :func:`stacked_operands`.

    A plain row's seeds, gains and ``frac`` are ``select_seeds_device``'s
    ``flat`` bytes (``frac`` int over int), a variant row's
    ``select_variant``'s ``flat`` bytes with ``spent`` (``frac`` int over
    float32).  Row-weighted stores are not stackable (the weighted
    estimator changes Occur's dtype a request): callers route those to the
    solo path."""
    if isinstance(store, ShardedDeviceRRStore):
        store._one_rank("the stacked selection")
    if store.row_weighted:
        raise ValueError("stacked selection does not support row-weighted "
                         "stores — route weighted requests to the solo path")
    if not reqs:
        raise ValueError("select_seeds_stacked needs at least one request")
    kw = stacked_operands(store, reqs, n_group=n_group, n_groups=n_groups)
    t = store.n_elems
    seeds, gains, spent = kops.greedy_stacked(
        store.flat[:t], store.ids[:t], store.valid[:t], **kw)
    # a plain row divides as the solo flat scan (int over int), a variant
    # row as the solo variant scan (int over a float32 n_rr of at least
    # 1e-30): the same float32 bytes for any sampled pool, kept apart as
    # the reference keeps them
    gsum = gains.sum(dim=1, dtype=torch.int32).to(torch.float32)
    nrr = torch.full((), store.n_rr, dtype=torch.float32, device=store.device)
    frac = torch.where(kw["plain"], gsum / torch.clamp_min(nrr, 1.0),
                       gsum / torch.clamp_min(nrr, 1e-30))
    return StackedResult(seeds=seeds, gains=gains, frac=frac, spent=spent,
                         n_requests=len(reqs))


def select_seeds_celf(store: DeviceRRStore, k: int, *, eval_batch: int = 32,
                      use_sketch: bool = True,
                      spec: SelectionSpec | None = None,
                      stats_out: dict | None = None):
    """CELF lazy greedy with sketch-first candidate ordering: the
    reference's ``select_seeds_celf`` on one device, seed for seed.

    The whole selection is one ``kops.celf_select`` call (on a card one
    cooperative launch of the ``celf_select`` CUDA kernel; on the CPU the
    plain version, ``ref.celf_select_ref``, which says what it computes):
    ``eval_batch`` candidates an exact evaluation and, with
    ``use_sketch``, a sweep a seed of the store's coverage sketch
    (:meth:`DeviceRRStore.sketch_words`).  The host reads the counts of
    exact evaluations and eval calls, the gains' sum and the store's fold
    flag back once, at the end; a bad fold raises there.

    The seeds, gains and ``frac`` equal the ``flat`` scan's for any sketch
    size; ``stats_out`` gets ``n_exact_evals``, ``n_eval_calls``,
    ``sketch_k`` (0 without the sketch) and ``n_rr``, as the reference's.
    A ``spec`` runs the variant loop instead (:func:`_celf_variant`) and
    returns a :class:`VariantResult`.
    """
    if spec is not None:
        if isinstance(store, ShardedDeviceRRStore):
            store._one_rank("the CELF variant")
        return _celf_variant(store, spec, eval_batch=eval_batch,
                             use_sketch=use_sketch, stats_out=stats_out)
    if isinstance(store, ShardedDeviceRRStore):
        return _sharded_celf(store, k, eval_batch=eval_batch,
                             use_sketch=use_sketch, stats_out=stats_out)
    n = store.n_nodes
    t = store.n_elems
    sk_words = store.sketch_words() if use_sketch else None
    seeds, gains, stats = kops.celf_select(
        store.flat[:t], store.ids[:t], store.valid[:t], n=n,
        num_rows=store.row_capacity(), k=k, c=max(1, min(eval_batch, n)),
        sketch=sk_words)
    # the one read: the counts, the gains' sum and the fold flag
    n_evals, n_eval_calls, total, bad = (int(x) for x in torch.cat(
        [stats, gains.sum(dtype=torch.int64).view(1),
         store.fold_error.to(torch.int64)]).cpu())
    store.check_folds(bad)
    if stats_out is not None:
        stats_out.update(n_exact_evals=n_evals, n_eval_calls=n_eval_calls,
                         sketch_k=(sk_words.shape[1] * 32 if use_sketch
                                   else 0),
                         n_rr=store.n_rr)
    # float64 quotient rounded to float32, as the reference's host maths
    frac = np.float32(total / max(store.n_rr, 1))
    return CoverageResult(seeds=seeds, gains=gains,
                          frac=torch.full((), float(frac),
                                          dtype=torch.float32,
                                          device=seeds.device))


def _top(idx: np.ndarray, sc: np.ndarray, k_top: int) -> np.ndarray:
    """The ``k_top`` nodes of ``idx`` with the highest ``sc``, the lowest
    id first on ties (as a set).  Integer scores take one ``argpartition``
    of the unique keys ``sc * (n + 1) - id``; float scores a ``lexsort``."""
    if sc.dtype.kind in "iu":
        if k_top >= len(idx):
            return idx
        key = sc[idx].astype(np.int64) * (len(sc) + 1) - idx
        return idx[np.argpartition(-key, k_top - 1)[:k_top]]
    return idx[np.lexsort((idx, -sc[idx]))[:k_top]]


def _padded_cands(cands: np.ndarray, c: int, dev) -> torch.Tensor:
    """``cands`` padded with -1 to ``celf_eval``'s ``c`` slots."""
    pad = np.full(c, -1, np.int32)
    pad[:len(cands)] = cands
    return torch.from_numpy(pad).to(dev)


def _lazy_celf(ub: np.ndarray, steps: int, c: int, *, evaluate, commit,
               sweep=None, feasible=None, costs=None):
    """The reference's CELF lazy loop on the host, shared by the sharded
    pool's selection and the variant selection; the hooks hold what the
    callers do differently (their kernels and their reductions).

    ``ub`` (n,) holds each node's upper bound (its exact Occur) and is
    updated in place.  Each of ``steps`` steps: ``feasible()`` (None: every
    node, every step) gives the step's mask, and a step with no feasible
    node ends the loop; ``sweep()`` (with the sketch) gives each node's
    sketch union gain, whose top ``c`` (over every node, the infeasible
    ones last) make the first exact evaluation; then the highest-scoring
    stale feasible nodes are evaluated ``c`` at a time until the argmax of
    the scores (the bound, or bound / cost with ``costs``, over the
    feasible nodes) is fresh.  ``evaluate(cands)`` returns the candidates'
    exact gains; ``commit(u)`` commits the pick and returns its gain.
    -> (seeds, gains, exact evaluations, eval calls)."""
    n = len(ub)
    node_ids = np.arange(n)
    fresh = np.zeros(n, bool)
    counts = [0, 0]

    def eval_exact(cands):
        cands = np.asarray(cands, np.int32)
        ub[cands] = evaluate(cands)
        fresh[cands] = True
        counts[0] += len(cands)
        counts[1] += 1

    def scores(feas):
        if costs is not None:
            # the scan's float32 division: ub holds exact counts (or
            # float32 weight sums), so the cast is exact
            return np.where(feas & (ub > 0),
                            ub.astype(np.float32) / costs, -np.inf)
        return ub if feas is None else np.where(feas, ub, -np.inf)

    seeds, gains = [], []
    for _ in range(steps):
        feas = feasible() if feasible is not None else None
        if feas is not None and not feas.any():
            break
        fresh[:] = False
        if sweep is not None:
            deltas = sweep()
            est = deltas / costs if costs is not None else deltas
            if feas is not None:
                est = np.where(feas, est.astype(np.float64), -np.inf)
            eval_exact(_top(node_ids, est, c))
        while True:
            sc = scores(feas)
            u = int(np.argmax(sc))       # the first maximum
            if sc[u] == -np.inf:
                # budgeted only: every affordable node left has gain 0,
                # where the scan starts its sentinels
                u = None
                break
            if fresh[u]:
                break
            stale = ~fresh if feas is None else \
                ~fresh & feas & (sc > -np.inf)
            eval_exact(_top(node_ids[stale], sc, c))
        if u is None:
            break
        gains.append(commit(u))
        ub[u] = 0                        # exact: u's rows are now covered
        seeds.append(u)
    return seeds, gains, counts[0], counts[1]


def _sharded_celf(store: ShardedDeviceRRStore, k: int, *,
                  eval_batch: int = 32, use_sketch: bool = True,
                  stats_out: dict | None = None) -> CoverageResult:
    """CELF on the sharded pool: the reference's lazy loop
    (``select_seeds_celf``, :func:`_lazy_celf`), node for node, with the
    host holding the upper bounds.  The exact Occur is ``occur_flat`` on
    each shard and one ``all_reduce``; a seed's sweep is striped, rank d
    scoring its ``sketch_rows / D`` rows of the replicated sketch with
    ``sketch_union_popcount`` into a zero-filled vector that one
    ``all_reduce`` completes; an exact evaluation is ``celf_eval`` on each
    shard against its Covered words and one ``all_reduce`` of the counts;
    a commit is ``celf_apply`` on each shard and one ``all_reduce`` of the
    new rows; the union of the picks' sketch rows is folded on every rank
    alike.  The seeds, gains and ``frac`` are the ``flat`` scan's."""
    mesh, d = store.mesh, store.n_shards
    n = store.n_nodes
    t = store._t
    flat, ids, valid = store.flat[:t], store.ids[:t], store.valid[:t]
    dev = store.device
    c = max(1, min(eval_batch, n))
    ub = mesh.all_reduce(kops.occur_flat(flat, valid, n=n)
                         ).cpu().numpy().astype(np.int64)
    cov_words = torch.zeros(store.row_capacity() // 32, dtype=torch.int32,
                            device=dev)
    sweep = None
    if use_sketch:
        sk_words = store.sketch_words_mesh()
        sk_k = sk_words.shape[1] * 32
        stripe = store.sketch_rows // d
        mine = sk_words[mesh.rank * stripe:(mesh.rank + 1) * stripe]
        cov_sk = torch.zeros(sk_words.shape[1], dtype=torch.int32,
                             device=dev)

        def sweep():
            full = torch.zeros(store.sketch_rows, dtype=torch.int32,
                               device=dev)
            full[mesh.rank * stripe:(mesh.rank + 1) * stripe] = \
                sketch_mod.union_gains(mine, cov_sk)
            return mesh.all_reduce(full)[:n].cpu().numpy()

    def evaluate(cands):
        return mesh.all_reduce(kops.celf_eval(
            flat, ids, valid, cov_words, _padded_cands(cands, c, dev))
        ).cpu().numpy()[:len(cands)]

    def commit(u):
        nonlocal cov_sk
        gain = int(mesh.all_reduce(kops.celf_apply(
            flat, ids, valid, cov_words, u).view(1)))
        if use_sketch:
            cov_sk = sketch_mod.union_row(cov_sk, sk_words, u)
        return gain

    seeds, gains, n_evals, n_eval_calls = _lazy_celf(
        ub, k, c, evaluate=evaluate, commit=commit, sweep=sweep)
    if stats_out is not None:
        stats_out.update(n_exact_evals=n_evals, n_eval_calls=n_eval_calls,
                         sketch_k=(sk_k if use_sketch else 0),
                         n_rr=store.n_rr)
    frac = np.float32(sum(gains) / max(store.n_rr, 1))
    return CoverageResult(
        seeds=torch.tensor(seeds, dtype=torch.int32, device=dev),
        gains=torch.tensor(gains, dtype=torch.int32, device=dev),
        frac=torch.tensor(frac, dtype=torch.float32, device=dev))


def _celf_variant(store: DeviceRRStore, spec: SelectionSpec, *,
                  eval_batch: int = 32, use_sketch: bool = True,
                  stats_out: dict | None = None) -> VariantResult:
    """CELF lazy greedy on a variant spec: the reference's ``_celf_variant``,
    a host loop (:func:`_lazy_celf`) that launches the port's kernels.

    The host holds each node's upper bound (its exact Occur at first, then
    its last exact gain), the candidate mask, the group quotas and, in
    float32 as the reference keeps them, the costs, the budget and the
    spent total.  A step with no feasible node ends the loop.  Otherwise
    one sweep of the store's coverage sketch (``sketch_union_popcount``)
    orders the first ``eval_batch`` exact evaluations (``celf_eval``, one
    call a batch, read back), the lazy loop evaluates the highest stale
    scores until the argmax of the scores (the bound, or bound / cost with
    a budget, over the feasible nodes) is fresh, and that node's commit is
    one ``celf_apply``.  The seeds are the ``flat`` variant's seeds with
    its sentinels trimmed, and so are the gains and ``spent``.

    Weighted (a row-weighted store): the bounds start as the weighted
    Occur (:func:`weighted_occur`), the row weights
    (:func:`row_weights`) are computed once and passed to the weighted
    forms of ``celf_eval`` and ``celf_apply``, which sum the float32
    weights of the rows a candidate newly covers, and ``frac`` divides by
    the store's ``wsum``.  Where row weights are integers (or multiples of
    a power of two) and their sums stay below 2^24, every float32 sum is
    exact in any order, and the seeds equal the ``flat`` variant's."""
    _check_spec(store, spec)
    n = store.n_nodes
    t = store.n_elems
    flat, ids, valid = store.flat[:t], store.ids[:t], store.valid[:t]
    dev = store.device
    c = max(1, min(eval_batch, n))
    use_costs = spec.budget is not None
    costs = (np.asarray(spec.costs, np.float32) if spec.costs is not None
             else np.ones(n, np.float32))
    cand = (np.asarray(spec.cand, bool) if spec.cand is not None
            else np.ones(n, bool))
    group_of = np.arange(n) // spec.n_group
    gbud = np.full(spec.n_groups, spec.group_quota, np.int64)
    budget32 = np.float32(spec.budget) if use_costs else np.float32(np.inf)
    spent32 = np.float32(0.0)
    weighted = spec.weighted
    roww = None
    if weighted:
        occur = weighted_occur(flat, valid, store.ew[:t], n)
        denom = float(store.wsum)
        roww = row_weights(ids, valid, store.ew[:t], store.row_capacity())
    else:
        occur = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
            0, flat.to(torch.int64), valid.to(torch.int32))[:n]
        denom = float(max(store.n_rr, 1))
    ub = occur.cpu().numpy().astype(np.float64)
    cov_words = torch.zeros(store.row_capacity() // 32, dtype=torch.int32,
                            device=dev)
    sweep = None
    if use_sketch:
        sk_words = store.sketch_words()
        sk_k = sk_words.shape[1] * 32
        cov_sk = torch.zeros(sk_words.shape[1], dtype=torch.int32,
                             device=dev)

        def sweep():
            return sketch_mod.union_gains(sk_words, cov_sk)[:n].cpu().numpy()

    def evaluate(cands):
        return kops.celf_eval(flat, ids, valid, cov_words,
                              _padded_cands(cands, c, dev),
                              roww=roww).cpu().numpy()[:len(cands)]

    picked = np.zeros(n, bool)

    def feasible():
        feas = cand & (gbud[group_of] > 0) & ~picked
        if use_costs:
            feas = feas & (costs <= budget32 - spent32)
        return feas

    def commit(u):
        nonlocal cov_sk, spent32
        gain = kops.celf_apply(flat, ids, valid, cov_words, u,
                               roww=roww).item()
        if use_sketch:
            cov_sk = sketch_mod.union_row(cov_sk, sk_words, u)
        picked[u] = True
        gbud[group_of[u]] -= 1
        if use_costs:
            spent32 = np.float32(spent32 + costs[u])
        return gain

    seeds, gains, n_evals, n_eval_calls = _lazy_celf(
        ub, spec.k_steps, c, evaluate=evaluate, commit=commit, sweep=sweep,
        feasible=feasible, costs=costs if use_costs else None)
    if stats_out is not None:
        stats_out.update(n_exact_evals=n_evals, n_eval_calls=n_eval_calls,
                         sketch_k=(sk_k if use_sketch else 0),
                         n_rr=store.n_rr)
    # float64 quotient rounded to float32, as the reference's host maths
    frac = np.float32(float(np.asarray(gains, np.float64).sum())
                      / max(denom, 1e-30))

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    return VariantResult(seeds=put(seeds, np.int32),
                         gains=put(gains, np.float32 if weighted
                                   else np.int32),
                         frac=put(frac, np.float32),
                         spent=put(spent32, np.float32))


class PaddedStore(NamedTuple):
    """The RR pool as an (R, L) matrix, each row padded with ``n`` past its
    length: the reference's layout for its TPU membership kernel."""
    rows: torch.Tensor      # (R, L) int32, padded with n
    lengths: torch.Tensor   # (R,) int32
    n_nodes: int


def build_padded_store(rr_lists, n: int, row_len: int | None = None,
                       pad_rows_to: int = 8, device="cuda") -> PaddedStore:
    """The reference's ``build_padded_store``, array for array: L is
    ``row_len`` (or the longest list) rounded up to 128, R the list count
    rounded up to ``pad_rows_to``; rows past the lists have length 0."""
    lens = np.asarray([len(r) for r in rr_lists], dtype=np.int64)
    l = row_len if row_len is not None else int(max(lens.max(), 1))
    l = ((l + 127) // 128) * 128
    r = ((len(rr_lists) + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
    rows = np.full((r, l), n, dtype=np.int32)
    for i, rr in enumerate(rr_lists):
        if len(rr) > l:
            raise ValueError("row_len too small")
        rows[i, :len(rr)] = rr
    lengths = np.zeros(r, np.int32)
    lengths[:len(lens)] = lens
    dev = resolve_device(device)
    return PaddedStore(rows=torch.from_numpy(rows).to(dev),
                       lengths=torch.from_numpy(lengths).to(dev), n_nodes=n)


def select_seeds_padded(store: PaddedStore, k: int) -> CoverageResult:
    """Greedy selection on a :class:`PaddedStore`: all k steps in one
    ``kops.padded_greedy`` call (the CUDA kernel on the card, the plain
    loop ``ref.padded_greedy_ref`` on the CPU), with the reference's
    semantics: Occur counts valid lanes (a lane outside the nodes counts
    for none, as the reference's dropping scatter-add), each step takes
    the first maximum over all n nodes, and its gain is the rows it newly
    covers.  The host then reads the row count once."""
    rows, lengths, n = store.rows, store.lengths, store.n_nodes
    seeds, gains = kops.padded_greedy(rows, lengths, n=n, k=k)
    n_rr = int((lengths > 0).sum())
    return CoverageResult(seeds=seeds, gains=gains, frac=_frac(gains, n_rr))


class SketchRRStore(_FoldedSketch):
    """Pool-free RR "store" of ``mode="approximate"`` on one device.

    ``words`` is the (n + 1, sketch_k/32) int32 occupancy matrix (row n is
    the sentinel that padding entries point at).  Each batch folds into it
    in place (:func:`~repro_torch.core.sketch.fold_frontier_packed`, one
    ``sketch_fold_rows`` launch on the card) under canonical batch-order
    row ids, as the reference's fold at mesh size 1 numbers them.  The flat
    pool, ids and valid buffers of :class:`DeviceRRStore` are never
    allocated: memory is O(n · sketch_k / 8) whatever θ is.  The host keeps
    exact row and element counts, which drive θ: the fold writes the
    batch's counts on the device and the append reads them in its one host
    read.

    ``fold_error`` is a (1,) int32 flag on the device that a scatter-OR
    given it sets when a pair's bucket lies outside the sketch (the batch
    fold's buckets are always inside).  Each append's read and the
    selection's one read also read the flag, and raise ``ValueError`` when
    it is set, so a bad fold raises before any result that follows it is
    returned.
    """

    pool_free = True
    row_weighted = False

    def __init__(self, n_nodes: int, sketch_k: int, sketch_mode: str = "mod",
                 *, device="cuda"):
        if n_nodes >= 2 ** 31 - 1:
            raise ValueError("item space must fit int32")
        if sketch_mode not in ("mod", "mix"):
            raise ValueError(f"unknown sketch hash mode {sketch_mode!r}")
        self.n_nodes = n_nodes
        self.device = resolve_device(device)
        self.sketch_mode = sketch_mode
        self.sketch_k = sketch_mod.resolve_sketch_k(sketch_k)
        self.sketch_rows = n_nodes + 1
        self.words = torch.zeros((self.sketch_rows, self.sketch_k // 32),
                                 dtype=torch.int32, device=self.device)
        # what an append reads back, in one copy: the fold's counts of the
        # batch (valid lanes, non-empty rows), then the flag (its low half)
        self._readback = torch.zeros(3, dtype=torch.int64,
                                     device=self.device)
        self.fold_error = self._readback[2:].view(torch.int32)[:1]
        self._nrr = 0      # the θ row counter (host mirror, exact)
        self._t = 0        # element count (stats only)

    @property
    def n_rr(self) -> int:
        return self._nrr

    @property
    def n_elems(self) -> int:
        return self._t

    def per_device_pool_bytes(self) -> int:
        """No pool buffers exist: the point of the mode."""
        return 0

    def sketch_bytes(self) -> int:
        return self.sketch_rows * (self.sketch_k // 32) * 4

    def sketch_words(self, k: int | None = None) -> torch.Tensor:
        """The sketch words; a ``k`` other than the store's raises
        ``ValueError``."""
        self._check_k(k)
        return self.words

    def append_batch(self, batch) -> None:
        """Fold one padded batch (an ``RRBatch`` or ``(nodes, lengths)``)
        into the sketch words: the whole append.  On the card it is one
        ``sketch_fold_rows`` launch, which also writes the batch's counts,
        and one host read of those counts and the flag; a set flag raises
        before the counters move."""
        nodes, lens = ((batch.nodes, batch.lengths)
                       if hasattr(batch, "nodes") else batch)
        nodes = torch.as_tensor(nodes, device=self.device)
        lens = torch.as_tensor(lens, device=self.device)
        if nodes.dim() != 2 or lens.shape != (nodes.shape[0],):
            raise ValueError("append_batch wants padded (R, W) nodes + (R,) "
                             "lengths")
        sketch_mod.fold_frontier_packed(self.words, nodes, lens, self._nrr,
                                        k=self.sketch_k,
                                        mode=self.sketch_mode,
                                        counts=self._readback[:2])
        elems, rows, bad = self._readback.tolist()
        self.check_folds(bad)
        self._t += elems
        self._nrr += rows

    def config(self) -> dict:
        return {"kind": "sketch", "n_nodes": int(self.n_nodes),
                "n_shards": 1, "sketch_k": self.sketch_k,
                "sketch_mode": self.sketch_mode, "row_weighted": False}

    def state(self) -> dict:
        """The reference's ``SketchRRStore.state()`` layout on one shard:
        ``sk_words`` (1, n + 1, sketch_k/32) uint32 (the bits of the int32
        words) and the element and row counts ``t_loc``/``nrr_loc`` (1,)
        int64, as host numpy arrays."""
        return {"sk_words": _uint32_words(self.words),
                "t_loc": np.array([self._t], np.int64),
                "nrr_loc": np.array([self._nrr], np.int64)}

    @classmethod
    def from_state(cls, state: dict, config: dict, *, device="cuda"):
        """A store holding ``state`` on the named ``device``: ``sk_words``
        the reference's (1, n + 1, sketch_k/32) uint32 state words or an
        (n + 1, sketch_k/32) int32 tensor, ``t_loc``/``nrr_loc`` the element
        and row counts of its one shard; ``config`` as :meth:`config`
        gives it."""
        if int(config.get("n_shards", 1)) != 1:
            raise ValueError(
                f"sketch state was saved on {config['n_shards']} shards; the "
                "port's store has one")
        store = cls(config["n_nodes"], sketch_k=config["sketch_k"],
                    sketch_mode=config["sketch_mode"], device=device)
        store.words = _int32_words(state["sk_words"], store.words.shape,
                                   store.device)
        store._t = int(np.sum(_host(state["t_loc"])))
        store._nrr = int(np.sum(_host(state["nrr_loc"])))
        return store

    def select(self, k: int, cand=None,
               info_out: dict | None = None) -> CoverageResult:
        """Greedy on sketch estimates (:func:`select_seeds_sketch`),
        inside the candidate mask ``cand`` when one is given."""
        return select_seeds_sketch(self, k, cand=cand, info_out=info_out)


def select_seeds_sketch(store, k: int, *, cand=None,
                        info_out: dict | None = None) -> CoverageResult:
    """Greedy selection on sketch estimates alone (the approximate mode).

    All k steps are one ``kernels.ops.greedy_sketch`` call (the CUDA kernel
    on the card, the plain version on the CPU).  Per seed: Δocc(v) =
    popcount(sketch_v | cov) − popcount(cov) for every node, the first
    maximum among nodes not yet picked and, given a candidate mask
    ``cand`` (n,) bool, inside it (the lowest id on ties, as the
    reference's host argmax), and an OR of the seed's sketch row into the
    union ``cov``.  The greedy stops when no candidate is left; seeds are
    padded to k with the sentinel n and gain 0.  The host reads the summed
    gains and the store's fold flag back once, and the certificate
    (:func:`sketch_certificate`) is host arithmetic on that sum.
    """
    n = store.n_nodes
    if cand is not None:
        cand = torch.from_numpy(
            np.asarray(cand, bool)[:n].copy()).to(store.device)
    seeds, gains, _ = kops.greedy_sketch(store.words, n=n, k=k, cand=cand)
    occ_union, bad = (int(x) for x in torch.stack(
        [gains.sum(dtype=torch.int64),
         store.fold_error[0].to(torch.int64)]).cpu())
    store.check_folds(bad)
    frac = sketch_certificate(store, occ_union, info_out)
    return CoverageResult(seeds=seeds, gains=gains,
                          frac=torch.full((), float(frac),
                                          dtype=torch.float32,
                                          device=seeds.device))


def sketch_certificate(store, occ_union: int,
                       info_out: dict | None = None) -> np.float32:
    """``frac`` of a sketch selection whose gains sum to ``occ_union``, and
    its certificate into ``info_out``, as the reference's:

    * ``lo_rows`` — the summed Δocc, a deterministic lower bound on the rows
      the seeds cover;
    * ``hi_rows`` — the linear-counting estimate widened by its z-sigma
      relative error, or all ``n_rr`` rows when the union row is saturated;
    * exact regime (``"mod"`` bucketing, ``n_rr <= sketch_k``): Δocc is the
      exact marginal, the estimate is ``occ_union`` and the error 0.

    ``frac`` is ``est_rows / n_rr`` rounded to float32, as the reference's
    ``np.float32(frac)``: the LB loop's Alg. 2 L7 test reads it, and a
    float64 value could flip that test at a boundary and change θ.
    """
    sk_k = store.sketch_k
    n_rr = store.n_rr
    exact_regime = store.sketch_mode == "mod" and n_rr <= sk_k
    if exact_regime:
        est_rows, lo_rows, hi_rows = float(occ_union), occ_union, occ_union
        saturated, rel_err = False, 0.0
    else:
        est_arr, sat_arr = sketch_mod.linear_count_saturated([occ_union], sk_k)
        saturated = bool(sat_arr[0])
        est_rows = min(float(est_arr[0]), float(n_rr))
        rel_err = float(np.asarray(
            sketch_mod.linear_count_rel_error(est_arr, sk_k))[0])
        lo_rows = min(occ_union, n_rr)
        hi_rows = (n_rr if saturated
                   else min(float(n_rr), est_rows * (1.0 + rel_err)))
    if info_out is not None:
        info_out.update(occ_union=occ_union, est_rows=est_rows,
                        lo_rows=lo_rows, hi_rows=hi_rows,
                        saturated=saturated, rel_error=rel_err,
                        exact_regime=exact_regime, sketch_k=sk_k, n_rr=n_rr)
    return np.float32(est_rows / max(n_rr, 1))


# ---------------------------------------------------------------------------
# The host-list API: CSR-of-RR pools compacted on the host (the reference's
# RRStore family), and the legacy sharded selection over host-built shards.
# ---------------------------------------------------------------------------

class RRStore(NamedTuple):
    """CSR-of-RR: ``rr_flat[i]`` is a node of RR set ``rr_ids[i]``; rows
    are contiguous and in row order, and the padded tail (``valid`` false)
    holds the node ``n`` under the row id ``n_rr``."""
    rr_flat: torch.Tensor   # (T,) int32
    rr_ids: torch.Tensor    # (T,) int32
    valid: torch.Tensor     # (T,) bool
    n_rr: int
    n_nodes: int


def _compact_padded(nodes, lens, base: int = 0):
    """(B, W) padded rows and lengths -> (elements, row ids + ``base``,
    lengths clamped to ``[0, W]``) on the host, the reference's
    ``_compact_padded`` (an overflowed lane may report its length before
    truncation; the clamp keeps elements and row ids in step)."""
    nodes = _host(nodes)
    lens = np.clip(_host(lens).astype(np.int64), 0, nodes.shape[1])
    mask = np.arange(nodes.shape[1])[None, :] < lens[:, None]
    flat = nodes[mask].astype(np.int64)
    ids = np.repeat(np.arange(len(lens), dtype=np.int64) + base, lens)
    return flat, ids, lens


def _rr_store(flat, ids, valid, n_rr: int, n: int, device) -> RRStore:
    dev = resolve_device(device)
    return RRStore(rr_flat=torch.from_numpy(flat.astype(np.int32)).to(dev),
                   rr_ids=torch.from_numpy(ids.astype(np.int32)).to(dev),
                   valid=torch.from_numpy(valid).to(dev),
                   n_rr=int(n_rr), n_nodes=int(n))


def build_store(rr_lists_or_arrays, n: int, pad_to: int | None = None,
                device="cuda") -> RRStore:
    """Host compaction of RR sets (paper Alg. 6 lines 4-11), the
    reference's ``build_store``: a list of node lists, or ``(nodes (B, W),
    lengths (B,))`` padded arrays from a sampler; ``pad_to`` pads the
    elements with ``valid`` false.  The tensors go to ``device``."""
    if isinstance(rr_lists_or_arrays, list):
        lens = np.asarray([len(r) for r in rr_lists_or_arrays], np.int64)
        flat = (np.concatenate([np.asarray(r, np.int64)
                                for r in rr_lists_or_arrays])
                if lens.sum() else np.zeros(0, np.int64))
        ids = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    else:
        flat, ids, lens = _compact_padded(*rr_lists_or_arrays)
    t = flat.shape[0]
    t_pad = pad_to if pad_to is not None else t
    if t_pad < t:
        raise ValueError("pad_to smaller than payload")
    valid = np.zeros(t_pad, bool)
    valid[:t] = True
    flat = np.concatenate([flat, np.full(t_pad - t, n, np.int64)])
    ids = np.concatenate([ids, np.full(t_pad - t, len(lens), np.int64)])
    return _rr_store(flat, ids, valid, len(lens), n, device)


class IncrementalRRStore:
    """Growing host CSR-of-RR with amortised O(1) appends, the reference's
    ``IncrementalRRStore``: each batch is compacted once into doubling
    host buffers, and :meth:`snapshot` returns a cached :class:`RRStore` on
    ``device`` (dropped by the next append)."""

    def __init__(self, n_nodes: int, capacity: int = 1024, device="cuda"):
        self.n_nodes = n_nodes
        self.device = resolve_device(device)
        self._flat = np.empty(max(capacity, 1), np.int64)
        self._ids = np.empty(max(capacity, 1), np.int64)
        self._t = 0
        self._n_rr = 0
        self._cache: RRStore | None = None

    @property
    def n_rr(self) -> int:
        return self._n_rr

    def _reserve(self, extra: int) -> None:
        need = self._t + extra
        cap = self._flat.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("_flat", "_ids"):
            buf = np.empty(cap, np.int64)
            buf[:self._t] = getattr(self, name)[:self._t]
            setattr(self, name, buf)

    def append_batch(self, batch) -> None:
        """Append one batch (an ``RRBatch`` or ``(nodes, lengths)``); rows
        of length 0 are padding and get no row id."""
        nodes, lens = ((batch.nodes, batch.lengths)
                       if hasattr(batch, "nodes") else batch)
        flat, ids, lens = _compact_padded(nodes, lens)
        row_rank = np.cumsum(lens > 0) - 1           # empty rows drop out
        t = flat.shape[0]
        self._reserve(t)
        self._flat[self._t:self._t + t] = flat
        self._ids[self._t:self._t + t] = self._n_rr + row_rank[ids]
        self._t += t
        self._n_rr += int((lens > 0).sum())
        self._cache = None

    def snapshot(self) -> RRStore:
        if self._cache is None:
            t = self._t
            self._cache = _rr_store(self._flat[:t], self._ids[:t],
                                    np.ones(t, bool), self._n_rr,
                                    self.n_nodes, self.device)
        return self._cache


def merge_stores(stores: list[RRStore]) -> RRStore:
    """One :class:`RRStore` of the stores' valid elements, their rows
    renumbered in store order (the reference's ``merge_stores``), on the
    first store's device."""
    n = stores[0].n_nodes
    flats, ids, base = [], [], 0
    for s in stores:
        v = _host(s.valid)
        flats.append(_host(s.rr_flat)[v].astype(np.int64))
        ids.append(_host(s.rr_ids)[v].astype(np.int64) + base)
        base += s.n_rr
    flat = np.concatenate(flats)
    return _rr_store(flat, np.concatenate(ids), np.ones(flat.shape[0], bool),
                     base, n, stores[0].rr_flat.device)


def occur_histogram(store: RRStore) -> torch.Tensor:
    """Occur: the RR sets that hold each node, (n,) int32 (elements are
    row-unique), through ``kops.occur_flat``."""
    return kops.occur_flat(store.rr_flat, store.valid, n=store.n_nodes)


def _list_rows(n_rr: int) -> int:
    """Covered rows of a host-built store: its rows and the padding row id
    ``n_rr``, rounded to a power of two of at least 32."""
    return max(32, _ceil_pow2(n_rr + 1))


def select_seeds(store: RRStore, k: int) -> CoverageResult:
    """Greedy max-coverage on a host-built store, the reference's
    ``select_seeds``: one ``kops.greedy_flat`` call on the stacked pool (a
    ``greedy_flat`` launch on a card)."""
    seeds, gains = kops.greedy_flat(
        store.rr_flat, store.rr_ids, store.valid, n=store.n_nodes,
        num_rows=_list_rows(store.n_rr), k=k)
    return CoverageResult(seeds=seeds, gains=gains,
                          frac=_frac(gains, store.n_rr))


def shard_stores(per_shard_rr: list[list[list[int]]], n: int,
                 device="cuda") -> RRStore:
    """Stack per-rank RR lists into one :class:`RRStore` whose tensors
    carry a leading shard dimension, the reference's ``shard_stores``:
    every shard is padded to the most rows (with empty rows, never covered
    and never matched) and to the longest flat extent, so ``n_rr`` is the
    rows of each shard."""
    rows = max(len(p) for p in per_shard_rr)
    per_shard_rr = [p + [[]] * (rows - len(p)) for p in per_shard_rr]
    t_max = max(sum(len(r) for r in p) for p in per_shard_rr)
    stores = [build_store(p, n, pad_to=t_max, device=device)
              for p in per_shard_rr]
    return RRStore(rr_flat=torch.stack([s.rr_flat for s in stores]),
                   rr_ids=torch.stack([s.rr_ids for s in stores]),
                   valid=torch.stack([s.valid for s in stores]),
                   n_rr=rows, n_nodes=n)


def select_seeds_sharded(mesh, store_shards: RRStore, k: int, n: int):
    """The legacy sharded selection on host-built shards (the reference's
    ``select_seeds_sharded``): this rank runs the step protocol of the
    sharded fused scan (:func:`_flat_protocol`: one ``all_reduce`` of the
    Occur, then one of the (n + 1,) decrement a seed) on shard
    ``mesh.rank`` of :func:`shard_stores`' stack, whose leading dimension
    must be the mesh's size.  Returns ``(seeds (k,), gains (k,))`` int32,
    the same on every rank."""
    if store_shards.rr_flat.shape[0] != mesh.size:
        raise ValueError(f"{store_shards.rr_flat.shape[0]} shards for a mesh "
                         f"of {mesh.size} ranks")
    d = mesh.rank
    return _flat_protocol(
        mesh, store_shards.rr_flat[d].contiguous(),
        store_shards.rr_ids[d].contiguous(),
        store_shards.valid[d].contiguous(), n=n,
        num_rows=_list_rows(store_shards.n_rr), k=k)
