"""Result cache for the IM serving layer (the reference's
``repro.serve.cache``, on the port).

Keys are the *content* of a request — the graph name **and its content
digest** (:func:`repro_torch.graph.csr.graph_digest` — a re-registered or
delta-mutated graph can never return a pre-mutation cached result), plus
the problem's :meth:`~repro_torch.core.problem.IMProblem.signature_digest`
(sha256 over every field, arrays by dtype+shape+bytes), plus the
solver-config discriminator the registry derives — so two requests hit
the same entry iff a solve for one would be bit-identical to a solve for
the other on the same warm solver.  Values are host-side
:class:`~repro_torch.core.problem.IMResult` objects (numpy seeds/gains +
python and float32 scalars, no tensor); treat them as immutable.

Plain LRU over an ``OrderedDict`` with hit/miss/eviction counters — the
numbers surface in :class:`~repro_torch.serve.front.ServeStats` and the
server's ``/statsz``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Hashable, Optional

from repro_torch.core.problem import IMResult


@dataclass(frozen=True)
class CacheStats:
    hits: int
    misses: int
    evictions: int
    entries: int
    max_entries: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ResultCache:
    """LRU map ``request key -> IMResult`` with counters."""

    def __init__(self, max_entries: int = 1024):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self._d: "OrderedDict[Hashable, IMResult]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: Hashable) -> Optional[IMResult]:
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: Hashable, result: IMResult) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = result
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def snapshot(self) -> CacheStats:
        return CacheStats(hits=self.hits, misses=self.misses,
                          evictions=self.evictions, entries=len(self._d),
                          max_entries=self.max_entries)
