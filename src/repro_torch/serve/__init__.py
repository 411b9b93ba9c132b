"""IM-as-a-service on the port (the reference's ``repro.serve``):
warm-solver registry, micro-batched asyncio request front, and result
cache over the :class:`~repro_torch.core.problem.IMProblem` API, with the
micro-batch executor (``batching``) that runs a batch of compatible
requests on one warm solver.  DESIGN.md §7 documents the architecture
and contracts; §8 the fault model (failure isolation, quarantine, circuit
breakers, degraded serves, pool spill/rehydrate); §11 the network surface
(``repro_torch.serve.net``), the consistent-hash cluster
(``repro_torch.serve.cluster``) and batched stacked selection.  Solvers
run on ``solver_opts["device"]`` (default ``"cuda"``)."""
from repro_torch.serve.batching import (execute_batch,
                                        occur_fastpath_eligible,
                                        stacked_eligible)
from repro_torch.serve.cache import CacheStats, ResultCache
from repro_torch.serve.client import IMClient, ServeHTTPError
from repro_torch.serve.cluster import HashRing, IMCluster
from repro_torch.serve.front import (
    CircuitOpenError,
    DeadlineExpiredError,
    IMService,
    InvalidProblemError,
    QueueFullError,
    ServeConfig,
    ServeError,
    ServeResponse,
    ServeStats,
    SolverFailedError,
    UnknownGraphError,
    build_service,
)
from repro_torch.serve.net import ERROR_STATUS, IMNetServer, status_for
from repro_torch.serve.registry import (RegistryStats, WarmEntry,
                                        WarmSolverRegistry)

__all__ = [
    "CacheStats",
    "CircuitOpenError",
    "DeadlineExpiredError",
    "ERROR_STATUS",
    "HashRing",
    "IMClient",
    "IMCluster",
    "IMNetServer",
    "IMService",
    "InvalidProblemError",
    "QueueFullError",
    "RegistryStats",
    "ResultCache",
    "ServeConfig",
    "ServeError",
    "ServeHTTPError",
    "ServeResponse",
    "ServeStats",
    "SolverFailedError",
    "UnknownGraphError",
    "WarmEntry",
    "WarmSolverRegistry",
    "build_service",
    "execute_batch",
    "occur_fastpath_eligible",
    "stacked_eligible",
    "status_for",
]
