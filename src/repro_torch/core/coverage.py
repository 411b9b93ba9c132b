"""The device RR pool and greedy max-coverage (paper Alg. 6 pool, Alg. 7).

:class:`DeviceRRStore` is the reference's ``ShardedDeviceRRStore`` on one
device: the flat concatenated pool ``flat`` (node ids, sentinel ``n`` past
the live extent), ``ids`` (row id of every element) and ``valid``, with the
same initial capacity, the same doubling and the same growth headroom, so
its buffers equal the reference's shard 0 element for element.  The host
keeps exact mirrors of the element and row counts (one device read per
append, gIM's ``N_RR`` readback).

Selection (:func:`select_seeds_device`):

* ``flat`` — the reference's fused scan: Occur by scatter-add over the
  pool, per seed one membership pass that finds the newly covered rows and
  one scatter that takes their elements off Occur.  Covered rows live in a
  packed int32 bitset; gains are SWAR popcounts of the new words.
* ``bitset`` — Alg. 7 on the packed (row_capacity, ceil(n/32)) membership
  matrix: the initial Occur and each seed's Occur decrement are the two
  hand-written CUDA kernels (``kernels/ops.py``; the plain versions on the
  CPU).
* ``auto`` — ``bitset`` iff the bit matrix is no larger than the pool's
  capacity, the reference's rule.

Both scans take ties to the lowest node id (``torch.argmax`` returns the
first maximum; the bit matrix's padding ids past n have Occur 0) and give
seeds, gains and ``frac`` identical to each other and to the reference's
``fused`` scan on the same pool.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.packing import bit_values, rank_positions, to_int32_bits
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import popcount_words_ref

_PACK = 1 << 15   # growth headroom of a wide append (the reference's _PACK)


def _ceil_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


class CoverageResult(NamedTuple):
    seeds: torch.Tensor   # (k,) int32
    gains: torch.Tensor   # (k,) int32 — newly covered RR sets per seed
    frac: torch.Tensor    # () float32 — F_R(S): covered fraction


class DeviceRRStore:
    """Growing CSR-of-RR pool on one device (see the module docstring)."""

    def __init__(self, n_nodes: int, capacity: int = 4096, *,
                 device="cuda"):
        if n_nodes >= 2 ** 31 - 1:
            raise ValueError("item space must fit int32")
        self.n_nodes = n_nodes
        self.device = resolve_device(device)
        cap = _ceil_pow2(max(capacity, 1))
        self.flat = torch.full((cap,), n_nodes, dtype=torch.int32,
                               device=self.device)
        self.ids = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self._t = 0        # host mirrors (exact)
        self._nrr = 0
        self._bitset = None

    @property
    def n_rr(self) -> int:
        return self._nrr

    @property
    def n_elems(self) -> int:
        return self._t

    @property
    def capacity(self) -> int:
        return int(self.flat.shape[0])

    def append_batch(self, batch) -> None:
        """Append one batch (an ``RRBatch`` or ``(nodes, lengths)``).

        Rows of length 0 are padding and get no row id.  Elements land in
        row-major order at ``[t, t + elems)``: their source positions come
        from :func:`rank_positions` over the prefix sum of the length mask,
        their row ids from the prefix sum of the non-empty rows.  A wide
        batch (``R*W > 2^15`` holding at most 2^15 elements) reserves 2^15
        elements of headroom before it grows the buffers, as the
        reference's packed append does.
        """
        nodes, lens = ((batch.nodes, batch.lengths)
                       if hasattr(batch, "nodes") else batch)
        nodes = torch.as_tensor(nodes, device=self.device)
        lens = torch.as_tensor(lens, device=self.device)
        if nodes.dim() != 2 or lens.shape != (nodes.shape[0],):
            raise ValueError("append_batch wants padded (R, W) nodes + (R,) "
                             "lengths")
        r, w = nodes.shape
        lens = lens.to(torch.int64).clamp(0, w)
        row_valid = lens > 0
        elems, rows = (int(x) for x in torch.stack(
            [lens.sum(), row_valid.sum()]).cpu())
        wide = r * w > _PACK and elems <= _PACK
        need = self._t + (_PACK if wide else elems)
        if need > self.capacity:
            self._grow_to(need)
        if elems:
            t = self._t
            mask = torch.arange(w, device=self.device)[None, :] < lens[:, None]
            src = rank_positions(mask.reshape(-1).cumsum(0), elems, r * w)
            rid = self._nrr + row_valid.cumsum(0) - 1
            self.flat[t:t + elems] = nodes.reshape(-1)[src].to(torch.int32)
            self.ids[t:t + elems] = rid[src // w].to(torch.int32)
            self.valid[t:t + elems] = True
        self._t += elems
        self._nrr += rows
        self._bitset = None

    def _grow_to(self, need: int) -> None:
        """Double the capacity until ``need`` elements fit."""
        newcap = self.capacity
        while newcap < need:
            newcap *= 2
        pad = newcap - self.capacity
        self.flat = torch.cat([self.flat, torch.full(
            (pad,), self.n_nodes, dtype=torch.int32, device=self.device)])
        self.ids = torch.cat([self.ids, torch.zeros(
            pad, dtype=torch.int32, device=self.device)])
        self.valid = torch.cat([self.valid, torch.zeros(
            pad, dtype=torch.bool, device=self.device)])

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

    def select(self, k: int, method: str = "auto") -> CoverageResult:
        return select_seeds_device(self, k, method=method)


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


def _frac(gains: torch.Tensor, n_rr: int) -> torch.Tensor:
    return (gains.sum().to(torch.float32)
            / torch.tensor(max(n_rr, 1), dtype=torch.float32,
                           device=gains.device))


def _select_flat(store: DeviceRRStore, k: int) -> CoverageResult:
    n, t = store.n_nodes, store.n_elems
    num_rows = store.row_capacity()
    flat = store.flat[:t].to(torch.int64)
    ids = store.ids[:t].to(torch.int64)
    valid = store.valid[:t]
    dev = flat.device
    occur = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, valid.to(torch.int32))[:n]
    cov = torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        newly = _newly_rows(flat, ids, valid, _unpack_covered(cov), u)
        new_words = _pack_covered(newly)
        gains.append(popcount_words_ref(new_words).sum())
        elem_newly = (newly[ids] & valid).to(torch.int32)
        occur = occur - torch.zeros(n + 1, dtype=torch.int32,
                                    device=dev).index_add_(
            0, flat, elem_newly)[:n]
        cov = cov | new_words
        seeds.append(u)
    gains = torch.stack(gains).to(torch.int32)
    return CoverageResult(seeds=torch.stack(seeds).to(torch.int32),
                          gains=gains, frac=_frac(gains, store.n_rr))


def _select_bitset(store: DeviceRRStore, k: int) -> CoverageResult:
    m = store.bitset_matrix()
    occur = kops.occur_from_bitset(m)
    covered = torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        col = m.index_select(1, (u >> 5).view(1))[:, 0]
        hit = ((col >> (u & 31)) & 1) != 0
        newly = hit & ~covered
        occur = occur - kops.occur_from_bitset_masked(m, newly)
        gains.append(newly.sum())
        covered = covered | hit
        seeds.append(u)
    gains = torch.stack(gains).to(torch.int32)
    return CoverageResult(seeds=torch.stack(seeds).to(torch.int32),
                          gains=gains, frac=_frac(gains, store.n_rr))


def select_seeds_device(store: DeviceRRStore, k: int,
                        method: str = "auto") -> CoverageResult:
    """Greedy selection of ``k`` seeds on the store's pool.  ``method`` is
    ``"flat"``, ``"bitset"`` or ``"auto"`` (see the module docstring)."""
    if method == "auto":
        n_words = (store.n_nodes + 31) // 32
        method = ("bitset" if store.row_capacity() * n_words <= store.capacity
                  else "flat")
    if method == "flat":
        return _select_flat(store, k)
    if method == "bitset":
        return _select_bitset(store, k)
    raise ValueError(f"unknown selection method {method!r}")
