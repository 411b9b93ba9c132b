"""Asyncio HTTP client for the ``repro_torch.serve.net`` wire protocol (the
reference's ``repro.serve.client``, on the port; the protocol is the
reference's, so it drives either package's server).

``IMClient.solve`` posts a problem and either returns the decoded 200
payload or raises the *same* :class:`~repro_torch.serve.front.ServeError`
subclass the server raised — the typed error body carries the subclass
``code``, and the client rebuilds the exception from it, so in-process and
over-the-wire callers handle failures identically.  One connection per
request (``Connection: close``): serving batches are milliseconds of
device time, so connection reuse is not the bottleneck and the client
stays trivially cancellation-safe (Ctrl-C in the demo just drops
sockets).
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional, Tuple

from repro_torch.core.problem import IMProblem, problem_state
from repro_torch.serve.front import ServeError


def _error_classes():
    """code -> ServeError subclass, walking the whole subclass tree."""
    out = {}
    stack = list(ServeError.__subclasses__())
    while stack:
        cls = stack.pop()
        out[cls.code] = cls
        stack.extend(cls.__subclasses__())
    return out


class ServeHTTPError(Exception):
    """Non-2xx response whose error code maps to no ServeError subclass
    (transport-level rejections: drained server, bad route, ...)."""

    def __init__(self, status: int, code: str, message: str):
        super().__init__(f"HTTP {status} [{code}]: {message}")
        self.status = status
        self.code = code


class IMClient:
    """Minimal client over asyncio streams (stdlib only, like the server).

    ``solve`` raises typed errors; ``solve_raw`` returns ``(status, doc)``
    untouched for load generators that count status codes.
    """

    def __init__(self, host: str, port: int, *,
                 timeout_s: Optional[float] = 120.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._codes = _error_classes()

    async def request(self, method: str, path: str, body: Optional[dict]
                      = None, headers: Optional[dict] = None
                      ) -> Tuple[int, dict]:
        payload = b"" if body is None else json.dumps(body).encode()
        head = [f"{method} {path} HTTP/1.1",
                f"host: {self.host}:{self.port}",
                "connection: close",
                "content-type: application/json",
                f"content-length: {len(payload)}"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        raw = ("\r\n".join(head) + "\r\n\r\n").encode("latin1") + payload

        async def _do():
            reader, writer = await asyncio.open_connection(self.host,
                                                           self.port)
            try:
                writer.write(raw)
                await writer.drain()
                status_line = await reader.readline()
                status = int(status_line.split()[1])
                length = None
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = h.decode("latin1").partition(":")
                    if name.strip().lower() == "content-length":
                        length = int(value)
                data = (await reader.readexactly(length)
                        if length is not None else await reader.read())
                return status, json.loads(data.decode() or "{}")
            finally:
                writer.close()
                try:
                    await writer.wait_closed()
                except Exception:
                    pass

        if self.timeout_s is None:
            return await _do()
        return await asyncio.wait_for(_do(), self.timeout_s)

    def _typed(self, status: int, doc: dict) -> Exception:
        err = (doc.get("error") or {})
        code = err.get("code", "error")
        msg = err.get("message", "")
        cls = self._codes.get(code)
        if cls is not None:
            return cls(msg)
        return ServeHTTPError(status, code, msg)

    async def solve_raw(self, graph: str, problem: IMProblem, *,
                        deadline_s: Optional[float] = None
                        ) -> Tuple[int, dict]:
        body = {"graph": graph, "problem": problem_state(problem)}
        headers = ({"x-deadline-s": repr(float(deadline_s))}
                   if deadline_s is not None else None)
        return await self.request("POST", "/v1/solve", body, headers)

    async def solve(self, graph: str, problem: IMProblem, *,
                    deadline_s: Optional[float] = None) -> dict:
        status, doc = await self.solve_raw(graph, problem,
                                           deadline_s=deadline_s)
        if status != 200:
            raise self._typed(status, doc)
        return doc

    async def healthz(self) -> Tuple[int, dict]:
        return await self.request("GET", "/healthz")

    async def readyz(self) -> Tuple[int, dict]:
        return await self.request("GET", "/readyz")

    async def stats(self) -> dict:
        status, doc = await self.request("GET", "/statsz")
        if status != 200:
            raise self._typed(status, doc)
        return doc
