"""Fault injection and the retry policy of the IM pipeline (the
reference's ``repro.ft.failures``, on the port).

On the card a device loss or allocator pressure surfaces as a
``torch.cuda.OutOfMemoryError`` (the counterpart of the reference's
``XlaRuntimeError`` with ``RESOURCE_EXHAUSTED``) out of a call in the
solver's hot loop.  The recovery (detect, classify, back off, retry from
the last *committed* round) is the same on any device, so it is what this
module implements and what the tests drive, with :class:`FaultInjector`
standing in for the runtime error at each boundary a real failure crosses:

``sample``    the engine's sample of a round in ``IMMSolver._round``
``append``    the store's append of a sampled batch
``grow``      the buffer allocation of the pool's capacity doubling
              (raises :class:`PoolAllocError`, the out-of-memory stand-in)
``select``    a selection (an LB iteration's or the final one)
``executor``  the serving front's batch executor

Injection fires *at the boundary, before any device mutation*, which is
what makes the retry sound: a retried round samples again with the same
round seed against unchanged buffers, so the fault-free and faulty
streams are bit-identical.  A real error that strikes *in the middle* of
an append can leave device buffers ahead of the host mirrors; that store
must never serve again (``IMMSolver.drop_pool``) instead of being retried.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

# the injection boundaries, in hot-loop order
SITES = ("sample", "append", "grow", "select", "executor")


class InjectedFailure(RuntimeError):
    """Transient stand-in for a device error at a loop boundary."""


class PoolAllocError(RuntimeError):
    """Stand-in for an out-of-memory error during pool capacity growth."""


class DeadlineExceeded(RuntimeError):
    """An in-solve deadline tripped and no degraded answer was possible
    (a non-counting objective, or no round sampled yet)."""


def is_transient(e: BaseException) -> bool:
    """Retryable? Injected faults and allocation failures always are; so is
    the card's ``torch.cuda.OutOfMemoryError``, where a retry after freeing
    memory can succeed; the reference's ``XlaRuntimeError`` only when it
    reports allocator pressure (``RESOURCE_EXHAUSTED``).  Anything else
    propagates."""
    if isinstance(e, (InjectedFailure, PoolAllocError,
                      torch.cuda.OutOfMemoryError)):
        return True
    return (type(e).__name__ == "XlaRuntimeError"
            and "RESOURCE_EXHAUSTED" in str(e))


@dataclass
class FaultInjector:
    """Deterministic fault source, keyed by injection site.

    ``fail_at`` maps a site to 1-based *occurrence numbers* that fire
    exactly once each (``{"sample": {3}}`` fails the third sample boundary
    crossed); ``rate`` adds seeded Bernoulli chaos per check (scalar or
    per-site dict — the chaos bench's ~10% mode).  ``match`` gates firing
    on the checked context (e.g. only a specific problem — the poisoned
    request of the serving isolation test).  ``max_fires`` bounds total
    fires so bounded-retry loops terminate in chaos runs.
    """
    fail_at: dict = field(default_factory=dict)
    rate: object = 0.0                 # float or {site: float}
    seed: int = 0
    match: Optional[Callable] = None   # (site, ctx) -> bool
    max_fires: Optional[int] = None
    counts: dict = field(default_factory=dict)
    fires: int = 0
    fired_log: list = field(default_factory=list)

    def __post_init__(self):
        bad = set(self.fail_at) - set(SITES)
        if bad:
            raise ValueError(f"unknown injection site(s) {sorted(bad)}; "
                             f"valid sites: {SITES}")
        self.fail_at = {s: set(int(x) for x in v)
                        for s, v in self.fail_at.items()}
        self._rng = random.Random(self.seed)

    def _rate_for(self, site: str) -> float:
        if isinstance(self.rate, dict):
            return float(self.rate.get(site, 0.0))
        return float(self.rate)

    def check(self, site: str, ctx=None) -> None:
        """Count one boundary crossing; raise if this one is configured to
        fail.  ``grow`` raises :class:`PoolAllocError`, every other site
        :class:`InjectedFailure`."""
        self.counts[site] = c = self.counts.get(site, 0) + 1
        if self.match is not None and not self.match(site, ctx):
            return
        if self.max_fires is not None and self.fires >= self.max_fires:
            return
        rate = self._rate_for(site)
        fire = (c in self.fail_at.get(site, ())
                or (rate > 0.0 and self._rng.random() < rate))
        if not fire:
            return
        self.fires += 1
        self.fired_log.append((site, c))
        if site == "grow":
            raise PoolAllocError(
                f"injected RESOURCE_EXHAUSTED at grow crossing #{c}")
        raise InjectedFailure(f"injected failure at {site} crossing #{c}")


@dataclass
class FaultPolicy:
    """Capped-exponential-backoff retry wrapper for the solver hot loop.

    ``run(fn, site)`` checks the injector at the boundary, runs ``fn``, and
    on a transient failure sleeps ``min(cap, base·2^attempt)`` and retries,
    up to ``max_retries`` — each retry re-executes the *same* round/selection
    against the committed store state, so the result stream stays
    bit-identical to a fault-free run.  :class:`PoolAllocError` additionally
    runs the ``on_oom`` hooks first (the serving registry registers
    "evict cold entries" here) before retrying the append, whose growth
    path falls back to a smaller allocation on its own
    (``DeviceRRStore.append_batch``).

    Counters (``retries``/``oom_recoveries``/``gave_up``/
    ``straggler_rounds``) feed ``ServeStats`` and the chaos bench report.
    """
    injector: Optional[FaultInjector] = None
    max_retries: int = 6
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.25
    sleep: Callable[[float], None] = time.sleep
    on_oom: list = field(default_factory=list)   # zero-arg "free memory" hooks
    round_timer: object = None     # optional ft.straggler.StepTimer
    retries: int = 0
    oom_recoveries: int = 0
    gave_up: int = 0
    straggler_rounds: int = 0

    def check(self, site: str, ctx=None) -> None:
        if self.injector is not None:
            self.injector.check(site, ctx)

    def run(self, fn: Callable, site: str, ctx=None):
        attempt = 0
        while True:
            try:
                self.check(site, ctx)
                return fn()
            except BaseException as e:
                if not is_transient(e):
                    raise
                if isinstance(e, PoolAllocError):
                    freed = False
                    for hook in list(self.on_oom):
                        freed = bool(hook()) or freed
                    if freed:
                        self.oom_recoveries += 1
                attempt += 1
                self.retries += 1
                if attempt > self.max_retries:
                    self.gave_up += 1
                    raise
                self.sleep(min(self.backoff_cap_s,
                               self.backoff_base_s * (2.0 ** (attempt - 1))))
