"""Carry the reference's data into the port.

Callers turn a JAX ``CSRGraph``, ``RRBatch`` or ``PaddedStore`` into numpy
arrays (``np.asarray``) and hand them here; this module imports nothing of
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coverage import PaddedStore
from repro_torch.core.engine import RRBatch
from repro_torch.core.roots import AliasTable
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph, _from_numpy


def graph_from_arrays(offsets, indices, weights, device="cuda") -> CSRGraph:
    """A port CSR graph with the given (offsets, indices, weights)."""
    offsets = np.asarray(offsets)
    indices = np.asarray(indices)
    if offsets.ndim != 1 or indices.ndim != 1 or \
            np.shape(weights) != indices.shape or \
            int(offsets[-1]) != indices.shape[0]:
        raise ValueError("inconsistent CSR arrays")
    return _from_numpy(offsets, indices, weights, device)


def batch_from_arrays(nodes, lengths, overflowed, steps, roots=None,
                      device="cuda") -> RRBatch:
    """A port RRBatch from the arrays of a reference ``RRBatch``."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    return RRBatch(nodes=put(nodes, np.int32), lengths=put(lengths, np.int32),
                   overflowed=put(overflowed, np.bool_), steps=int(steps),
                   roots=None if roots is None else put(roots, np.int32))


def alias_table_from_arrays(prob, alias, device="cuda") -> AliasTable:
    """A port alias table with the reference's ``AliasTable`` arrays: (n,)
    float32 ``prob`` in [0, 1] and (n,) int32 ``alias`` in [0, n)."""
    prob = np.asarray(prob)
    alias = np.asarray(alias)
    n = prob.shape[0] if prob.ndim == 1 else -1
    if prob.ndim != 1 or alias.shape != prob.shape or n < 1:
        raise ValueError(f"an alias table wants (n,) prob and alias, got "
                         f"{prob.shape} and {alias.shape}")
    if not ((prob >= 0) & (prob <= 1)).all() or \
            alias.min() < 0 or alias.max() >= n:
        raise ValueError(f"prob must lie in [0, 1] and alias in [0, {n})")
    dev = resolve_device(device)
    return AliasTable(
        prob=torch.from_numpy(prob.astype(np.float32)).to(dev),
        alias=torch.from_numpy(alias.astype(np.int32)).to(dev))


def sketch_words_from_arrays(words, device="cuda") -> torch.Tensor:
    """The port's int32 sketch words with the bits of the reference's
    (R, W) uint32 sketch words (a bit-for-bit view, bit 31 negative)."""
    words = np.asarray(words)
    if words.ndim != 2 or words.dtype not in (np.uint32, np.int32):
        raise ValueError(f"sketch words must be 2-D uint32, got "
                         f"{words.shape} {words.dtype}")
    return torch.from_numpy(
        np.ascontiguousarray(words).view(np.int32).copy()).to(
            resolve_device(device))


def padded_store_from_arrays(rows, lengths, n: int,
                             device="cuda") -> PaddedStore:
    """A port PaddedStore from the arrays of a reference ``PaddedStore``:
    (R, L) rows holding node ids in [0, n] (n is the padding) and (R,)
    lengths in [0, L]."""
    rows = np.asarray(rows)
    lengths = np.asarray(lengths)
    if rows.ndim != 2 or lengths.shape != (rows.shape[0],):
        raise ValueError(f"padded store wants (R, L) rows and (R,) lengths, "
                         f"got {rows.shape} and {lengths.shape}")
    if rows.size and (rows.min() < 0 or rows.max() > n):
        raise ValueError(f"rows must hold node ids in [0, {n}]")
    if lengths.size and (lengths.min() < 0 or lengths.max() > rows.shape[1]):
        raise ValueError(f"lengths must lie in [0, {rows.shape[1]}]")
    dev = resolve_device(device)
    return PaddedStore(rows=torch.tensor(rows.astype(np.int32), device=dev),
                       lengths=torch.tensor(lengths.astype(np.int32),
                                            device=dev),
                       n_nodes=int(n))


def shard_from_arrays(flat, ids, valid, rank: int,
                      device="cuda") -> tuple:
    """Rank ``rank``'s ``(flat, ids, valid)`` tensors from the buffers of
    the reference's sharded store (``ShardedDeviceRRStore._flat``,
    ``_ids``, ``_valid``: (D, cap) int32, int32 and bool numpy arrays, one
    row a shard), as a ``ShardedDeviceRRStore`` of the port holds them on
    that rank."""
    flat, ids, valid = (np.asarray(a) for a in (flat, ids, valid))
    if flat.ndim != 2 or ids.shape != flat.shape or \
            valid.shape != flat.shape:
        raise ValueError(f"sharded store buffers must be three (D, cap) "
                         f"arrays, got {flat.shape}, {ids.shape} and "
                         f"{valid.shape}")
    if not 0 <= rank < flat.shape[0]:
        raise ValueError(f"rank {rank} outside the {flat.shape[0]} shards")
    dev = resolve_device(device)
    return (torch.from_numpy(flat[rank].astype(np.int32)).to(dev),
            torch.from_numpy(ids[rank].astype(np.int32)).to(dev),
            torch.from_numpy(valid[rank].astype(np.bool_)).to(dev))
