"""LT-model RR sampler (paper §3.7): the reference's ``repro.core.lt``.

Under the linear-threshold model each node is activated through at most
one in-edge, chosen with probability equal to the edge's weight (a row's
weights sum to at most 1; the rest is "no edge").  A reverse RR set is
therefore a walk: from the root, repeatedly take one in-edge of the current
node or stop, and stop also on a revisit.

The in-edge choice is a search of the row's cumulative weights
(:func:`row_cumweights`, built once per graph), so a lane carries only its
current node and length, and the paper's frontier queue is one node.

Random numbers come from the counter hash, as the queue sampler's
(:mod:`repro_torch.core.rrset`): row r of a round with seed ``seed32`` has
the row seed ``counter_uniform_u32(seed32, r)`` and its root from
:mod:`repro_torch.core.roots` (uniform, or ∝ the weights of an alias
table); draw t of the lane (t = 0, 1, ...) is ``float32(counter_uniform_u32(
row_seed, t)) * 2^-32``.  The counters t stay below qcap <= n < 2^31 and
never meet the roots' reserved counters 0xFFFFFFFF and 0xFFFFFFFE.  So a
walk is a pure function of (row seed, graph), and the reference's threefry
walks agree with it in distribution, not draw for draw.

A round is one call of ``kernels.ops.lt_walk``: on a card one launch of the
CUDA kernel ``csrc/lt.cu`` (row seeds, roots and every lane's walk); on the
CPU the plain version, which syncs the host once a draw.  Both return the
same bytes in the queue sampler's layout, so the stores read an LT batch
as they read a queue batch.  The round then makes one host read, of the
longest walk and the most draws together.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import ops


class LTSample(NamedTuple):
    """One round: ``steps`` is the most draws of a lane, the reference's
    while-loop count."""
    nodes: torch.Tensor       # (B, W) int32 walk nodes (visit order)
    lengths: torch.Tensor     # (B,) int32
    roots: torch.Tensor       # (B,) int32
    overflowed: torch.Tensor  # (B,) bool
    steps: int


def row_cumweights(g: CSRGraph) -> torch.Tensor:
    """(m,) float32 inclusive cumulative weights within each CSR row, on
    ``g``'s device: the float64 cumulative sum over all edges less each
    row's base, cast to float32, byte for byte the reference's."""
    offs, _, w = g.numpy()
    w = np.asarray(w, dtype=np.float64)
    offs = np.asarray(offs, dtype=np.int64)
    cs = np.cumsum(w)
    base = np.concatenate([[0.0], cs])[offs[:-1]]
    rowcum = cs - np.repeat(base, np.diff(offs))
    return torch.from_numpy(rowcum.astype(np.float32)).to(g.device)


def sample_rrsets_lt(g_rev: CSRGraph, batch: int, seed32: int,
                     qcap: int | None = None, table=None,
                     rowcum: torch.Tensor | None = None) -> LTSample:
    """Sample one round of ``batch`` LT RR sets on the reverse CSR ``g_rev``
    with round seed ``seed32``, on ``g_rev``'s device: row seeds, roots (∝
    the weights of the alias ``table`` when one is given) and walks, one
    ``ops.lt_walk`` call.  ``qcap`` (default n) caps a walk's length;
    ``rowcum`` is :func:`row_cumweights` of ``g_rev`` (built here when
    None)."""
    qcap = g_rev.n_nodes if qcap is None else int(qcap)
    if rowcum is None:
        rowcum = row_cumweights(g_rev)
    walk, lengths, overflowed, lane_steps, roots = ops.lt_walk(
        g_rev.offsets, g_rev.indices, rowcum, seed32, batch, qcap=qcap,
        table=table)
    # the round's one host read
    width, steps = torch.stack((lengths.max().to(torch.int64),
                                lane_steps.max())).tolist()
    return LTSample(nodes=walk[:, :max(width, 1)], lengths=lengths,
                    roots=roots, overflowed=overflowed, steps=steps)
