"""Sampler-engine protocol and registry: the canonical :class:`RRBatch` and
the ``queue``, ``dense``, ``refill``, ``lt`` and ``mrim`` engines (the
reference's ``repro.core.engine``).

An engine is configured by a ``Config`` dataclass, registered under a short
name and returns one :class:`RRBatch` from ``sample(seed32)``, where
``seed32`` is the 32-bit seed of the sampling round (the port draws from
the counter hash, not from a key).  The two IC engines keep the per-row
contract of :mod:`.rrset`, so for one ``seed32`` they give the same RR
sets, row for row.  With ``root_weights`` (weighted IM) every engine draws
its roots ∝ the weights through one alias table
(:func:`repro_torch.core.roots.draw_roots`), and the IC engines still agree
row for row.  The ``lt`` engine samples the linear-threshold model's RR
walks (:mod:`.lt`); :func:`resolve_engine_name` picks it for
``model="lt"``.  The ``refill`` engine (paper Alg. 6's persistent lanes)
returns the queue engine's rows of a round at ``batch = quota`` where no
lane overflows, and the ``mrim`` engine (paper §4.8) samples T tagged BFS
from a shared root a row.  :class:`FusedSketchEngine` marks an engine as
feeding the pool-free store of the approximate mode.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, coalesce_ic
from repro_torch.core import dense as rr_dense
from repro_torch.core import lt as rr_lt
from repro_torch.core import rrset as rr_queue
from repro_torch.core.packing import pack_rows_device
from repro_torch.core.roots import build_alias_table
from repro_torch.kernels import ops

# the reference's bound on weighted refill roots (repro.core.roots), whose
# one-uniform alias draw is exact only up to it; the refill engine keeps its
# refusal, though the port's two-hash draw would not need it
ONE_UNIFORM_MAX_N = 1 << 22


class RRBatch(NamedTuple):
    """One batch of RR sets on a device.

    Invariants (:meth:`validate` checks them): one row per RR set, padded to
    the batch's longest set; ``lengths[i]`` counts row i's nodes, which lie
    in ``[0, item_space)``, are distinct and hold the row's root (queue rows
    start with it, dense rows are ascending); entries past ``lengths[i]``
    are undefined.  A row of length 0 is padding (no RR set) and the store
    drops it without a row id.  ``overflowed`` is per lane; ``steps``
    counts the lockstep micro-steps (queue) or BFS levels (dense) of the
    batch.
    """
    nodes: torch.Tensor       # (R, W) int32
    lengths: torch.Tensor     # (R,) int32
    overflowed: torch.Tensor  # (L,) bool
    steps: int
    roots: Optional[torch.Tensor] = None  # (R,) int32

    @property
    def n_sets(self) -> int:
        return int(self.lengths.shape[0])

    def validate(self, item_space: int) -> None:
        """Raise ``ValueError`` if the batch breaks an invariant (host check,
        for tests and for batches that come from outside the port)."""
        nodes = self.nodes.cpu().numpy()
        lens = self.lengths.cpu().numpy()
        if nodes.ndim != 2 or lens.shape != (nodes.shape[0],):
            raise ValueError("RRBatch wants (R, W) nodes and (R,) lengths")
        if (lens < 0).any() or (lens > nodes.shape[1]).any():
            raise ValueError("RRBatch lengths outside [0, W]")
        roots = None if self.roots is None else self.roots.cpu().numpy()
        for i, ln in enumerate(lens.tolist()):
            row = nodes[i, :ln]
            if ln == 0:
                continue
            if row.min() < 0 or row.max() >= item_space:
                raise ValueError(f"RRBatch row {i} leaves [0, {item_space})")
            if len(set(row.tolist())) != ln:
                raise ValueError(f"RRBatch row {i} repeats a node")
            if roots is not None and roots[i] not in row:
                raise ValueError(f"RRBatch row {i} does not hold its root")


class ShardedBatch(NamedTuple):
    """This rank's block of a batch that the ranks of ``mesh`` sampled
    together (``queue_sharded``'s ``sample_sharded``): rank d holds rows
    ``[d·b, (d+1)·b)`` of the ``mesh.size · b`` rows, padded to the width
    that all the blocks share; ``overflowed`` (every lane's flag) and
    ``steps`` (the most over the lanes) are the whole batch's.  A
    ``ShardedDeviceRRStore`` on the same mesh appends the block as its
    shard of the batch, with no gather of the rows."""
    nodes: torch.Tensor       # (b, W) int32, this rank's rows
    lengths: torch.Tensor     # (b,) int32
    overflowed: torch.Tensor  # (size · b,) bool
    steps: int
    roots: Optional[torch.Tensor]   # (b,) int32
    mesh: object


_ENGINES: dict[str, type] = {}

# engines that live outside core (core does not import launch) are
# imported from their home module at their first lookup
_LAZY_ENGINES: dict[str, str] = {
    "queue_sharded": "repro_torch.launch.im_solve"}


def register_engine(name: str):
    """Class decorator: register ``cls`` under ``name`` (sets ``cls.name``)."""
    def deco(cls):
        cls.name = name
        _ENGINES[name] = cls
        return cls
    return deco


def get_engine(name: str) -> type:
    if name not in _ENGINES and name in _LAZY_ENGINES:
        import importlib
        importlib.import_module(_LAZY_ENGINES[name])
    try:
        return _ENGINES[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; registered: "
                       f"{list_engines()}") from None


def list_engines() -> list[str]:
    """Every engine: core's and the lazily registered ones
    (``queue_sharded``), whether their modules were imported or not."""
    return sorted(set(_ENGINES) | set(_LAZY_ENGINES))


def make_engine(name: str, g_rev: CSRGraph, root_weights=None, mesh=None,
                **opts):
    """Instantiate a registered engine on the reverse graph (on its device).
    ``opts`` may hold keys the engine's ``Config`` lacks and ``None``
    values; both are dropped.  ``root_weights`` (weighted IM) makes the
    engine draw its roots ∝ the weights; ``None`` keeps the uniform draw.
    ``mesh`` (a ``launch.mesh.SampleMesh``) goes to an engine that samples
    over one (``sharded = True``: ``queue_sharded``); the others draw the
    whole batch on every rank and ignore it."""
    cls = get_engine(name)
    fields = {f.name for f in dataclasses.fields(cls.Config)}
    cfg = cls.Config(**{k: v for k, v in opts.items()
                        if k in fields and v is not None})
    if getattr(cls, "sharded", False):
        return cls(g_rev, cfg, mesh=mesh, root_weights=root_weights)
    return cls(g_rev, cfg, root_weights=root_weights)


def resolve_engine_name(engine: str, model: str = "ic") -> str:
    """The engine a solve runs: ``model="lt"`` takes the LT walk sampler
    (the only LT engine) whatever ``engine`` names."""
    return "lt" if model == "lt" else engine


def _resolve_root_table(root_weights, device):
    """(weights or None) -> (float32 weights or None, the alias table on
    ``device`` or None)."""
    if root_weights is None:
        return None, None
    w = np.asarray(root_weights, np.float32)
    return w, build_alias_table(w, device=device)


@register_engine("queue")
class QueueEngine:
    """gIM's work-efficient sampler (paper Alg. 3/6; :mod:`.rrset`).  On a
    card a round is one launch of the CUDA kernel ``csrc/queue.cu``
    (``kernels/queue.py::queue_bfs``, through ``kernels.ops.queue_bfs``)
    and one host read; on the CPU the plain version runs."""

    @dataclass(frozen=True)
    class Config:
        batch: int = 256
        qcap: Optional[int] = None   # default: n_nodes
        ec: int = rr_queue.EC_DEFAULT

    def __init__(self, g_rev: CSRGraph, config: Optional[Config] = None,
                 root_weights=None):
        # IC equivalence: parallel edges merge to p' = 1-∏(1-p), so rows
        # are simple and the sampler needs no in-chunk dedup
        self.g_rev = coalesce_ic(g_rev)
        self.config = config if config is not None else self.Config()
        self.qcap = (self.config.qcap if self.config.qcap is not None
                     else self.g_rev.n_nodes)
        self.root_weights, self.table = _resolve_root_table(
            root_weights, self.g_rev.device)

    @property
    def item_space(self) -> int:
        return self.g_rev.n_nodes

    def sample(self, seed32: int) -> RRBatch:
        s = rr_queue.sample_rrsets_queue(self.g_rev, self.config.batch,
                                         seed32, qcap=self.qcap,
                                         ec=self.config.ec, dedup="none",
                                         table=self.table)
        return RRBatch(s.nodes, s.lengths, s.overflowed, s.steps,
                       roots=s.roots)


@register_engine("dense")
class DenseEngine:
    """Dense-frontier sampler (:mod:`.dense`): one (B, m) edge-trial launch
    per round, then a BFS over every edge at every level; rows come out in
    ascending node order, trimmed to the longest set.  ``edge_src`` is built
    once here, not per round; ``steps`` of a batch is its level count."""

    @dataclass(frozen=True)
    class Config:
        batch: int = 256

    def __init__(self, g_rev: CSRGraph, config: Optional[Config] = None,
                 root_weights=None):
        self.g_rev = coalesce_ic(g_rev)      # exact for IC, fewer edges
        self.config = config if config is not None else self.Config()
        self._edge_src = rr_dense._edge_src(self.g_rev)
        self.root_weights, self.table = _resolve_root_table(
            root_weights, self.g_rev.device)

    @property
    def item_space(self) -> int:
        return self.g_rev.n_nodes

    def sample(self, seed32: int) -> RRBatch:
        nodes, lens, roots, overflow, levels = rr_dense._dense_round(
            self.g_rev, self._edge_src, seed32, self.config.batch,
            table=self.table)
        return RRBatch(nodes, lens, overflow, levels, roots=roots)


@register_engine("refill")
class RefillEngine:
    """Persistent-lane worker (paper Alg. 6; :func:`.rrset.
    sample_rrsets_refill`): ``lanes`` lanes sample the round's ``batch``
    rows, each lane starting its next row as soon as its last ends.  On a
    card a round is one launch of the CUDA kernel ``csrc/refill.cu``
    (``kernels.ops.refill_bfs``) and one host read.  ``sample`` returns the
    rows in row-id order: where no lane overflows, exactly ``batch`` rows,
    the queue engine's round at the same batch row for row (the reference
    returns ``batch`` to ``batch + lanes - 1``, with the same law)."""

    @dataclass(frozen=True)
    class Config:
        batch: int = 256             # quota: RR sets a sample()
        lanes: Optional[int] = None  # default: batch//2 clamped to [8, 512]
        out_cap: Optional[int] = None
        ec: int = rr_queue.EC_DEFAULT

    def __init__(self, g_rev: CSRGraph, config: Optional[Config] = None,
                 root_weights=None):
        self.g_rev = coalesce_ic(g_rev)
        cfg = config if config is not None else self.Config()
        self.config = cfg
        self.lanes = (cfg.lanes if cfg.lanes is not None
                      else max(min(cfg.batch // 2, 512), 8))
        self.out_cap = (cfg.out_cap if cfg.out_cap is not None
                        else min(8 * cfg.batch // self.lanes, 64) * 64)
        if root_weights is not None and self.g_rev.n_nodes > ONE_UNIFORM_MAX_N:
            raise ValueError(
                "weighted refill roots use the one-uniform alias draw, "
                f"which is only exact for n <= {ONE_UNIFORM_MAX_N}; use the "
                "queue or dense engine for weighted IM on larger graphs")
        self.root_weights, self.table = _resolve_root_table(
            root_weights, self.g_rev.device)

    @property
    def item_space(self) -> int:
        return self.g_rev.n_nodes

    def _round(self, seed32: int):
        return rr_queue._refill_round(
            self.g_rev, self.lanes, seed32, quota=self.config.batch,
            out_cap=self.out_cap, max_sets_per_lane=None, ec=self.config.ec,
            dedup="none", table=self.table)

    def sample(self, seed32: int) -> RRBatch:
        s, width, by_row = self._round(seed32)
        nodes, lens = rr_queue.refill_rows_by_id(s.flat, by_row,
                                                 max(width, 1))
        # rows are root-first, so a row's root is its column 0
        return RRBatch(nodes, lens, s.overflowed, s.steps,
                       roots=nodes[:, 0])

    def sample_device(self, seed32: int) -> RRBatch:
        """The same rows with no host read: ``batch`` rows in row-id order,
        ``out_cap`` wide, a row that was not emitted of length 0 (padding,
        which the store drops).  Without the host read there is no
        lock-step count: ``steps`` is 0."""
        g, cfg = self.g_rev, self.config
        flat, lengths, _, overflowed, rows, row_steps = ops.refill_bfs(
            g.offsets, g.indices, g.weights, seed32, self.lanes,
            quota=cfg.batch, out_cap=self.out_cap,
            max_sets=rr_queue.default_sets_per_lane(cfg.batch, self.lanes),
            ec=cfg.ec, table=self.table)
        nodes, lens = rr_queue.refill_rows_by_id(
            flat, rr_queue.refill_by_row(lengths, rows, row_steps,
                                         cfg.batch)[:3], self.out_cap)
        return RRBatch(nodes, lens, overflowed, 0, roots=nodes[:, 0])


@register_engine("lt")
class LTEngine:
    """Linear-threshold walk sampler (paper §3.7; :mod:`.lt`).  The rows'
    cumulative weights are built once here; on a card a round is one
    launch of the CUDA kernel ``csrc/lt.cu`` (``kernels/lt.py::lt_walk``,
    through ``kernels.ops.lt_walk``) and one host read.  The graph is
    taken as it is: parallel edges are two in-edges, each with its own
    weight, as in the reference."""

    @dataclass(frozen=True)
    class Config:
        batch: int = 256
        qcap: Optional[int] = None   # default: n_nodes

    def __init__(self, g_rev: CSRGraph, config: Optional[Config] = None,
                 root_weights=None):
        self.g_rev = g_rev
        self.config = config if config is not None else self.Config()
        self.qcap = (self.config.qcap if self.config.qcap is not None
                     else g_rev.n_nodes)
        self.rowcum = rr_lt.row_cumweights(g_rev)
        self.root_weights, self.table = _resolve_root_table(
            root_weights, g_rev.device)

    @property
    def item_space(self) -> int:
        return self.g_rev.n_nodes

    def sample(self, seed32: int) -> RRBatch:
        s = rr_lt.sample_rrsets_lt(self.g_rev, self.config.batch, seed32,
                                   qcap=self.qcap, table=self.table,
                                   rowcum=self.rowcum)
        return RRBatch(s.nodes, s.lengths, s.overflowed, s.steps,
                       roots=s.roots)


@register_engine("mrim")
class MRIMEngine:
    """Multi-round IM sampler (paper §4.8): each RR sample is T tagged BFS
    from a shared root, run as T adjacent lanes of one queue round
    (``root_tile`` T: lane ``bT + t`` has lane ``bT``'s root and its own
    trials); elements are encoded ``round * n + node``, so the coverage
    machinery runs unchanged on an item space of n·T.  The T segments of a
    sample are packed into one row by ``pack_rows_device``, at the round's
    width (T times its longest BFS), which the round's one host read
    gives."""

    @dataclass(frozen=True)
    class Config:
        batch: int = 64
        t_rounds: int = 2
        qcap: Optional[int] = None   # default: n_nodes
        ec: int = rr_queue.EC_DEFAULT

    def __init__(self, g_rev: CSRGraph, config: Optional[Config] = None,
                 root_weights=None):
        self.g_rev = coalesce_ic(g_rev)
        self.config = config if config is not None else self.Config()
        self.qcap = (self.config.qcap if self.config.qcap is not None
                     else self.g_rev.n_nodes)
        self.root_weights, self.table = _resolve_root_table(
            root_weights, self.g_rev.device)
        if self.item_space >= np.iinfo(np.int32).max:
            raise ValueError("n_nodes * t_rounds must fit int32")

    @property
    def item_space(self) -> int:
        return self.g_rev.n_nodes * self.config.t_rounds

    def sample(self, seed32: int) -> RRBatch:
        cfg, n, t = self.config, self.g_rev.n_nodes, self.config.t_rounds
        s = rr_queue.sample_rrsets_queue(
            self.g_rev, cfg.batch * t, seed32, qcap=self.qcap, ec=cfg.ec,
            dedup="none", table=self.table, root_tile=t)
        nodes, lens = merge_rounds(s.nodes, s.lengths, cfg.batch, t, n)
        overflow = s.overflowed.reshape(cfg.batch, t).any(dim=1)
        return RRBatch(nodes, lens, overflow, s.steps,
                       roots=s.roots[::t].contiguous())


def merge_rounds(nodes: torch.Tensor, lengths: torch.Tensor, batch: int,
                 t: int, n: int):
    """MRIM's segment merge: (B·T, W) BFS rows, lane ``bT + r`` round r of
    sample b -> (B, T·W) rows of ``r * n + node`` in round order, packed
    left, and their (B,) int32 lengths."""
    w = nodes.shape[1]
    dev = nodes.device
    tag = (torch.arange(batch * t, device=dev) % t) * n
    enc = (nodes.to(torch.int64) + tag[:, None]).to(torch.int32)
    enc = enc.reshape(batch, t * w)
    col = torch.arange(t * w, device=dev)
    mask = (col % w)[None, :] < lengths.reshape(batch, t)[:, col // w]
    return pack_rows_device(enc, mask)


class FusedSketchEngine:
    """Adapter that names an engine as the pool-free sample→sketch path
    (``IMProblem(mode="approximate")``).

    Sampling is untouched: every batch the inner engine emits is the batch
    the exact path would append, so an approximate solve walks the same
    round-seed stream as an exact one.  Only the destination changes: the
    solver pairs this adapter with a ``SketchRRStore``.  Every attribute
    other than ``name`` passes through to the inner engine.
    """

    def __init__(self, inner):
        self._inner = inner
        self.name = f"fused-sketch[{inner.name}]"

    def __getattr__(self, attr):
        # consulted only for attributes not set on the adapter itself
        return getattr(self._inner, attr)
