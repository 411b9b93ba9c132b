"""``repro_torch.serve.net`` — the stdlib-asyncio HTTP/1.1 serving surface
(the reference's ``repro.serve.net``, on the port; the wire protocol is the
reference's, so either package's client drives either package's server).

Wire protocol (DESIGN.md §11):

    POST /v1/solve   body {"graph": name, "problem": {IMProblem state},
                          "deadline_s"?: float}
                     -> 200 {"result": {...}, "cached", "batch_size",
                             "queued_s", "solve_s", "degraded"}
    GET  /healthz    -> 200 {"status": "ok"}          (process liveness)
    GET  /readyz     -> 200 / 503 while draining      (admission readiness)
    GET  /statsz     -> 200 ServeStats + registry/cache/breaker counters,
                        per-entry pool footprints and the exact/approximate
                        footprint ratio, as JSON

The problem body is the :func:`repro_torch.core.problem.problem_state`
encoding — the *full* ``IMProblem`` surface (k/eps/theta/candidates/
node_weights/costs/budget/t_rounds/mode) travels as JSON with dtype-tagged arrays, and
floats round-trip exactly through ``json`` (shortest-repr), so θ-pinned
answers read off the wire bit-identical to in-process
``IMService.submit``.  A per-request deadline rides either the
``X-Deadline-S`` header or the body's ``deadline_s``.

Every :class:`~repro_torch.serve.front.ServeError` subclass maps to a
*distinct* HTTP status (:data:`ERROR_STATUS`) with a typed error body
``{"error": {"code", "type", "message"}}`` — clients rebuild the exact
exception class from ``code`` (:mod:`repro_torch.serve.client`).

Graceful drain (SIGTERM/SIGINT): ``/readyz`` flips to 503 and ``/v1/solve``
rejects new work with a typed 503 body, in-flight batches flush through
``IMService.drain()``, warm pools spill via the registry's durable
spill-on-evict path, then the listener closes.  The server fronts either a
single :class:`~repro_torch.serve.front.IMService` or a
:class:`~repro_torch.serve.cluster.IMCluster` (both expose the same
submit/drain/stop/spill_pools surface).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.problem import IMProblem, IMResult, problem_from_state
from repro_torch.graph import csr as csr_mod
from repro_torch.graph import generators, weights
from repro_torch.serve.front import (CircuitOpenError, DeadlineExpiredError,
                                     IMService, InvalidProblemError,
                                     QueueFullError, ServeConfig, ServeError,
                                     SolverFailedError, UnknownGraphError,
                                     build_service)

# every ServeError subclass -> a DISTINCT status; the exhaustiveness (no
# subclass silently falling through to 500) is asserted by
# tests/test_torch_serve_net.py against ServeError.__subclasses__()
ERROR_STATUS = {
    InvalidProblemError: 400,     # malformed / unsatisfiable problem body
    UnknownGraphError: 404,       # graph name not registered
    QueueFullError: 429,          # admission queue at capacity (shed)
    SolverFailedError: 500,       # solver died after isolation retry
    CircuitOpenError: 503,        # key's breaker open — back off
    DeadlineExpiredError: 504,    # deadline passed before/while solving
}

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}

_MAX_BODY = 64 << 20


def status_for(err: ServeError) -> int:
    """HTTP status for a typed serve error (nearest ancestor wins)."""
    for cls in type(err).__mro__:
        if cls in ERROR_STATUS:
            return ERROR_STATUS[cls]
    return 500


def error_body(err: ServeError) -> dict:
    return {"error": {"code": err.code, "type": type(err).__name__,
                      "message": str(err)}}


def decode_problem(doc) -> IMProblem:
    """``problem_state`` JSON -> IMProblem; every malformation (wrong
    types, unknown fields, constraint violations from __post_init__)
    surfaces as the typed 400."""
    if not isinstance(doc, dict):
        raise InvalidProblemError("problem must be a JSON object")
    try:
        return problem_from_state(doc)
    except (TypeError, ValueError) as e:
        raise InvalidProblemError(str(e)) from e


def result_state(res: IMResult) -> dict:
    """JSON encoding of an IMResult.  Seeds/gains as lists, the float32
    frac/spread as exact-repr floats — the parity tests compare these
    against in-process results bit for bit.  The port's results hold numpy
    arrays and scalars, never a tensor, so this reads nothing off a
    card."""
    st = res.stats
    return {
        "seeds": np.asarray(res.seeds).tolist(),
        "gains": np.asarray(res.gains).tolist(),
        "spread": float(res.spread),
        "frac": float(res.frac),
        "cost": float(res.cost),
        "degraded": bool(res.degraded),
        "spread_bounds": (None if res.spread_bounds is None else
                          [float(res.spread_bounds[0]),
                           float(res.spread_bounds[1])]),
        "stats": {"theta": int(st.theta), "rounds": int(st.rounds),
                  "n_rr_sampled": int(st.n_rr_sampled),
                  "selection": st.selection, "variant": st.variant},
    }


def service_statsz(svc: IMService, *, draining: bool = False) -> dict:
    """/statsz payload for one service: the full ServeStats tree plus
    per-entry pool footprints and the exact-vs-approximate footprint ratio
    (the ε-tolerant tier's memory win) under the shared budget."""
    d = dataclasses.asdict(svc.stats())
    entries, exact_b, approx_b = [], [], []
    for e in svc.registry.entries.values():
        mode = e.problem.mode
        entries.append({"graph": e.key[0], "theta": e.key[2], "mode": mode,
                        "bytes": e.bytes, "solves": e.solves,
                        "staleness": e.staleness})
        (approx_b if mode == "approximate" else exact_b).append(e.bytes)
    ratio = None
    if exact_b and approx_b and sum(approx_b) > 0:
        ratio = ((sum(exact_b) / len(exact_b))
                 / (sum(approx_b) / len(approx_b)))
    return {"serve": d, "entries": entries, "draining": draining,
            "approx_footprint": {
                "exact_entries": len(exact_b),
                "approx_entries": len(approx_b),
                "exact_bytes_mean": (sum(exact_b) / len(exact_b)
                                     if exact_b else None),
                "approx_bytes_mean": (sum(approx_b) / len(approx_b)
                                      if approx_b else None),
                "exact_over_approx_ratio": ratio}}


class IMNetServer:
    """HTTP/1.1 front over an ``IMService`` (or ``IMCluster``) target.

    ``await start()`` binds (port 0 picks an ephemeral port, read back from
    ``self.port``) and starts the target; ``await shutdown()`` runs the
    drain protocol.  The HTTP layer is a deliberate minimal stdlib parse —
    request line, headers, Content-Length body, keep-alive — because the
    container bakes no HTTP dependency and the wire format is fully under
    test.
    """

    def __init__(self, target, *, host: str = "127.0.0.1", port: int = 0):
        self.target = target
        self.host = host
        self.port = port
        self.draining = False
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "IMNetServer":
        if self._server is not None:
            raise RuntimeError("server already started")
        if hasattr(self.target, "start"):
            await self.target.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def shutdown(self, *, spill: bool = True) -> None:
        """Graceful drain: stop admission (readyz -> 503, solve -> typed
        503), flush in-flight batches, spill warm pools, stop the target,
        close the listener."""
        if self.draining:
            return
        self.draining = True
        if self._server is not None:
            self._server.close()          # no new connections
        await self.target.drain()         # flush everything admitted
        if spill and hasattr(self.target, "spill_pools"):
            self.target.spill_pools()
        await self.target.stop()
        if self._server is not None:
            await self._server.wait_closed()

    # -- HTTP plumbing ------------------------------------------------------
    async def _read_request(self, reader):
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, path, _version = line.decode("latin1").split()
        except ValueError:
            raise _BadRequest("malformed request line")
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", 0) or 0)
        if length > _MAX_BODY:
            raise _BadRequest("body too large", status=413)
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _handle(self, reader, writer):
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except _BadRequest as e:
                    self._write(writer, e.status,
                                {"error": {"code": "bad_request",
                                           "message": str(e)}},
                                keep=False)
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, headers, body = req
                keep = headers.get("connection", "").lower() != "close"
                status, payload = await self._route(method, path, headers,
                                                    body)
                self._write(writer, status, payload, keep=keep)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    @staticmethod
    def _write(writer, status: int, payload: dict, *, keep: bool) -> None:
        data = json.dumps(payload).encode()
        writer.write((
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"content-type: application/json\r\n"
            f"content-length: {len(data)}\r\n"
            f"connection: {'keep-alive' if keep else 'close'}\r\n"
            f"\r\n").encode("latin1"))
        writer.write(data)

    # -- routes -------------------------------------------------------------
    async def _route(self, method, path, headers, body
                     ) -> Tuple[int, dict]:
        if path == "/healthz":
            return 200, {"status": "ok"}
        if path == "/readyz":
            if self.draining:
                return 503, {"ready": False, "draining": True}
            return 200, {"ready": True, "draining": False}
        if path == "/statsz":
            return 200, await self._stats_payload()
        if path == "/v1/solve":
            if method != "POST":
                return 405, {"error": {"code": "method_not_allowed",
                                       "message": "POST /v1/solve"}}
            return await self._solve(headers, body)
        return 404, {"error": {"code": "not_found",
                               "message": f"no route {method} {path}"}}

    async def _solve(self, headers, body) -> Tuple[int, dict]:
        if self.draining:
            return 503, {"error": {"code": "draining",
                                   "message": "server is draining"}}
        try:
            doc = json.loads(body.decode() or "{}")
            if not isinstance(doc, dict):
                raise InvalidProblemError("body must be a JSON object")
            graph = doc.get("graph")
            if not isinstance(graph, str):
                raise InvalidProblemError("body needs a string 'graph'")
            problem = decode_problem(doc.get("problem"))
            deadline = doc.get("deadline_s")
            if "x-deadline-s" in headers:
                deadline = float(headers["x-deadline-s"])
            if deadline is not None:
                deadline = float(deadline)
        except ServeError as e:
            return status_for(e), error_body(e)
        except Exception as e:
            e = InvalidProblemError(f"{type(e).__name__}: {e}")
            return status_for(e), error_body(e)
        try:
            resp = await self.target.submit(graph, problem,
                                            deadline_s=deadline)
        except ServeError as e:
            return status_for(e), error_body(e)
        return 200, {"result": result_state(resp.result),
                     "cached": resp.cached, "batch_size": resp.batch_size,
                     "queued_s": resp.queued_s, "solve_s": resp.solve_s,
                     "degraded": resp.degraded}

    async def _stats_payload(self) -> dict:
        if hasattr(self.target, "statsz"):     # cluster target
            return await self.target.statsz(draining=self.draining)
        return service_statsz(self.target, draining=self.draining)


class _BadRequest(Exception):
    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status


# -- CLI ---------------------------------------------------------------------

def _build_graph(n: int, r: int, seed: int, device="cuda"):
    """The reference's deterministic BA graph with WC weights (its
    ``benchmarks.common.ba_graph``; the same ``graph_digest``), on
    ``device``, so an out-of-process client can run θ-pinned parity checks
    against a locally built twin.  ``--n 75879 --r 4`` is the epinions-like
    stand-in."""
    src, dst = generators.barabasi_albert(n, r, seed=seed)
    return weights.wc_weights(csr_mod.from_edges(src, dst, n,
                                                 device=device))


async def serve_main(args) -> None:
    g = _build_graph(args.n, args.r, args.graph_seed, args.device)
    cfg = ServeConfig(
        max_batch=args.max_batch, queue_cap=args.queue_cap,
        batch_window_s=args.batch_window,
        solver_opts={"batch": args.batch, "seed": args.seed,
                     "device": args.device},
        stacked_selection=not args.no_stacked,
        spill_dir=args.spill_dir)
    if args.workers > 1:
        from repro_torch.serve.cluster import IMCluster
        target = IMCluster({"graph": g}, cfg, workers=args.workers)
    else:
        target = build_service({"graph": g}, cfg)
    server = IMNetServer(target, host=args.host, port=args.port)
    await server.start()
    print(f"serving graph(n={args.n}) on {args.device} at "
          f"http://{server.host}:{server.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for s in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(s, stop.set)
    await stop.wait()
    print("drain: admission stopped, flushing in-flight batches", flush=True)
    await server.shutdown()
    print("drained" + (", warm pools spilled" if args.spill_dir else ""),
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="IM serving over HTTP (repro_torch.serve.net)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--n", type=int, default=2000,
                    help="BA graph size (served as graph name 'graph')")
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1,
                    help=">1 runs the consistent-hash cluster")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--queue-cap", type=int, default=256)
    ap.add_argument("--batch-window", type=float, default=0.002)
    ap.add_argument("--batch", type=int, default=64,
                    help="solver sampling batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-stacked", action="store_true",
                    help="disable batched stacked selection (baseline)")
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the solvers' device: cuda (the kernels) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)
    asyncio.run(serve_main(args))


if __name__ == "__main__":
    main()
