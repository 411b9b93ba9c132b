"""The port's network surface and cluster on the CPU (DESIGN.md §11).

Holds ``repro_torch.serve.net``/``client``/``cluster`` to the assertions
of the reference's ``tests/test_serve_net.py``:

* the consistent-hash ring moves only the minimal key range on a join or
  a leave;
* every ``ServeError`` subclass maps to a distinct HTTP status and code;
* HTTP answers are bit-identical to in-process ``IMService.submit`` and to
  cold solves, typed errors come back as the same class through the
  client, and the drain flips ``/readyz``, rejects solves typed and spills
  the warm pools; ``/statsz`` is JSON of the documented shape;
* ring rebalance hands warm pools off as ``PoolLease`` exports and the
  moved keys answer bit-identically.

And across the packages: the wire protocol is the reference's, so
``repro.serve.client`` drives the port's server and the port's client
drives the reference's (θ-pinned answers equal to the server's own
in-process answers, errors rebuilt as the client package's classes with
the same status and code); ``ERROR_STATUS``, the ring's owners and
``net._build_graph``'s digest are the reference's.  The CLI serves on the
CPU with ``--device cpu`` and drains on SIGTERM.  The reference's
``test_stacked_mesh8_bit_identity`` waits for the multi-GPU slice; its
other stacked tests are ported in ``tests/test_torch_batching.py``.
"""
import asyncio
import json
import os
import select
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro.serve import net as jnet
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr as csr_mod
from repro_torch.graph import generators, weights
from repro_torch.serve import (ERROR_STATUS, HashRing, IMClient, IMCluster,
                               IMNetServer, InvalidProblemError, ServeConfig,
                               ServeError, SolverFailedError,
                               UnknownGraphError, build_service, status_for)
from repro_torch.serve import net as tnet
from repro_torch.serve.net import service_statsz

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPTS = {"batch": 64, "seed": 0, "device": "cpu"}
REF_OPTS = {"batch": 64, "seed": 0, "selection": "fused"}
THETA = 256
TIMEOUT_S = 120.0


def run(coro):
    """Run one test's event loop under a timeout of its own."""
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def ba(n=220, r=4, seed=0):
    src, dst = generators.barabasi_albert(n, r, seed=seed)
    return weights.wc_weights(csr_mod.from_edges(src, dst, n, device="cpu"))


def jba(n=220, r=4, seed=0):
    src, dst = jgen.barabasi_albert(n, r, seed=seed)
    return jw.wc_weights(jcsr.from_edges(src, dst, n))


def _mixed(n, theta, cls=IMProblem):
    cand = np.zeros(n, bool)
    cand[: n // 4] = True
    costs = (np.abs(np.random.default_rng(3).normal(1.0, 0.3, n))
             + 0.1).astype(np.float32)
    return [
        cls(k=2, theta=theta),
        cls(k=5, theta=theta),
        cls(k=3, theta=theta, candidates=np.flatnonzero(cand)),
        cls(k=None, budget=2.5, costs=costs, theta=theta),
        cls(k=4, theta=theta),
    ]


def _wire_equals(doc, res):
    """A wire answer against an in-process IMResult, bit for bit."""
    got = doc["result"]
    assert got["seeds"] == np.asarray(res.seeds).tolist()
    assert got["gains"] == np.asarray(res.gains).tolist()
    assert got["spread"] == float(res.spread)
    assert got["frac"] == float(res.frac)
    assert got["cost"] == float(res.cost)
    assert (np.float32(got["frac"]).tobytes()
            == np.float32(res.frac).tobytes())
    assert (np.float32(got["spread"]).tobytes()
            == np.float32(res.spread).tobytes())


# -- consistent-hash ring -----------------------------------------------------

def test_ring_minimal_movement_on_join_and_leave():
    ring = HashRing(vnodes=64)
    for w in range(4):
        ring.add(w)
    keys = [f"digest{i}|pool{i}|{i}|exact" for i in range(2000)]
    before = {k: ring.owner(k) for k in keys}
    ring.add(4)
    after = {k: ring.owner(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert moved and all(after[k] == 4 for k in moved)
    assert len(moved) < 2 * len(keys) / 5
    ring.remove(4)
    assert {k: ring.owner(k) for k in keys} == before


def test_ring_guards():
    ring = HashRing()
    with pytest.raises(RuntimeError):
        ring.owner("x")
    ring.add(0)
    with pytest.raises(ValueError):
        ring.add(0)
    with pytest.raises(ValueError):
        HashRing(vnodes=0)


def test_ring_owners_equal_the_reference():
    keys = [f"digest{i}|pool{i}|{128 + i % 12}|exact" for i in range(1000)]
    rings = (HashRing(vnodes=32), jserve.HashRing(vnodes=32))
    steps = [("add", w) for w in range(3)] + [("add", 7), ("remove", 1),
                                              ("add", 9), ("remove", 0)]
    for op, w in steps:
        for ring in rings:
            getattr(ring, op)(w)
        assert [rings[0].owner(k) for k in keys] == \
            [rings[1].owner(k) for k in keys]
        assert rings[0].workers == rings[1].workers


# -- error -> status mapping --------------------------------------------------

def _all_subclasses(cls):
    out, stack = [], list(cls.__subclasses__())
    while stack:
        c = stack.pop()
        out.append(c)
        stack.extend(c.__subclasses__())
    return out


def test_error_status_mapping_exhaustive():
    subs = _all_subclasses(ServeError)
    assert len(subs) >= 6
    for cls in subs:
        if status_for(cls("boom")) == 500:
            assert cls in ERROR_STATUS or any(
                base in ERROR_STATUS and ERROR_STATUS[base] == 500
                for base in cls.__mro__), cls
    vals = list(ERROR_STATUS.values())
    assert len(vals) == len(set(vals))
    assert status_for(SolverFailedError("x")) == 500
    assert status_for(ServeError("x")) == 500
    codes = [c.code for c in subs]
    assert len(codes) == len(set(codes))


def test_error_status_equals_the_reference():
    def table(mapping):
        return {cls.__name__: (status, cls.code)
                for cls, status in mapping.items()}
    assert table(ERROR_STATUS) == table(jnet.ERROR_STATUS)
    assert sorted(c.__name__ for c in _all_subclasses(ServeError)) == \
        sorted(c.__name__ for c in _all_subclasses(jserve.ServeError))


def test_build_graph_digest_equals_the_reference():
    g = tnet._build_graph(2000, 4, 0, device="cpu")
    assert g.device == torch.device("cpu")
    assert csr_mod.graph_digest(g) == jcsr.graph_digest(
        jnet._build_graph(2000, 4, 0))


# -- HTTP end to end ----------------------------------------------------------

def test_http_end_to_end_parity_errors_and_drain(tmp_path):
    g = ba()
    probs = _mixed(g.n_nodes, THETA)

    async def go():
        svc = build_service({"graph": g}, ServeConfig(
            max_batch=8, batch_window_s=0.002, solver_opts=OPTS,
            spill_dir=str(tmp_path)))
        server = IMNetServer(svc, port=0)
        await server.start()
        c = IMClient("127.0.0.1", server.port)
        assert (await c.healthz())[0] == 200
        assert (await c.readyz()) == (200, {"ready": True,
                                            "draining": False})
        docs = await asyncio.gather(*(c.solve("graph", p) for p in probs))
        approx = await c.solve("graph", IMProblem(k=3, theta=THETA,
                                                  mode="approximate"))
        assert approx["result"]["spread_bounds"] is not None
        inproc = await asyncio.gather(*(svc.submit("graph", p)
                                        for p in probs))
        cold = IMMSolver(g, **OPTS)
        for p, doc, ip in zip(probs, docs, inproc):
            _wire_equals(doc, ip.result)
            _wire_equals(doc, cold.solve_problem(p))
        with pytest.raises(UnknownGraphError):
            await c.solve("nope", probs[0])
        with pytest.raises(InvalidProblemError):
            await c.solve("graph", IMProblem(
                k=1, theta=THETA, candidates=np.array([g.n_nodes + 5])))
        status, doc = await c.request(
            "POST", "/v1/solve", {"graph": "graph", "problem": {"k": 0}})
        assert status == 400
        assert doc["error"]["code"] == "invalid_problem"
        status, _doc = await c.request("GET", "/nope")
        assert status == 404
        status, _doc = await c.request("GET", "/v1/solve")
        assert status == 405
        st = await c.stats()
        assert st["serve"]["served"] >= len(probs) + 1
        assert st["serve"]["stacked_requests"] >= 2
        fp = st["approx_footprint"]
        assert fp["approx_entries"] == 1 and fp["exact_entries"] >= 1
        assert fp["exact_over_approx_ratio"] > 1.0
        assert any(e["mode"] == "approximate" for e in st["entries"])
        server.draining = True
        assert (await c.readyz())[0] == 503
        status, doc = await c.solve_raw("graph", probs[0])
        assert status == 503 and doc["error"]["code"] == "draining"
        server.draining = False
        await server.shutdown()
        assert server.draining
        assert svc.registry.snapshot().spills >= 1
        assert len(svc.registry.entries) == 0
        assert any(os.scandir(tmp_path))

    run(go())


def test_statsz_payload_shape():
    g = ba(120)

    async def go():
        svc = build_service({"graph": g}, ServeConfig(solver_opts=OPTS))
        async with svc:
            await svc.submit("graph", IMProblem(k=2, theta=128))
            payload = service_statsz(svc)
        assert payload["serve"]["served"] == 1
        assert payload["entries"][0]["mode"] == "exact"
        assert payload["approx_footprint"]["approx_entries"] == 0
        json.dumps(payload)
        # the reference's payload has the same keys at every level
        jsvc = jserve.build_service({"graph": jba(120)}, jserve.ServeConfig(
            solver_opts=REF_OPTS))
        async with jsvc:
            await jsvc.submit("graph", JProblem(k=2, theta=128))
            want = jnet.service_statsz(jsvc)

        def shape(d):
            return {k: shape(v) if isinstance(v, dict) else None
                    for k, v in d.items()}
        assert shape(payload) == shape(want)
        assert sorted(payload["entries"][0]) == sorted(want["entries"][0])

    run(go())


# -- the wire across the packages ---------------------------------------------

def test_reference_client_drives_the_port_server():
    g = ba()
    kws = [dict(k=2, theta=THETA), dict(k=5, theta=THETA),
           dict(k=1, theta=THETA)]

    async def go():
        svc = build_service({"graph": g}, ServeConfig(
            max_batch=8, batch_window_s=0.002, solver_opts=OPTS))
        server = IMNetServer(svc, port=0)
        await server.start()
        try:
            c = jserve.IMClient("127.0.0.1", server.port)
            docs = await asyncio.gather(*(c.solve("graph", JProblem(**kw))
                                          for kw in kws))
            inproc = [await svc.submit("graph", IMProblem(**kw))
                      for kw in kws]
            for doc, ip in zip(docs, inproc):
                _wire_equals(doc, ip.result)
            with pytest.raises(jserve.UnknownGraphError):
                await c.solve("nope", JProblem(**kws[0]))
            bad = JProblem(k=1, theta=THETA,
                           candidates=np.array([g.n_nodes + 5]))
            with pytest.raises(jserve.InvalidProblemError):
                await c.solve("graph", bad)
            status, doc = await c.solve_raw("nope", JProblem(**kws[0]))
            assert (status, doc["error"]["code"]) == (404, "unknown_graph")
            status, doc = await c.solve_raw("graph", bad)
            assert (status, doc["error"]["code"]) == (400, "invalid_problem")
        finally:
            await server.shutdown(spill=False)

    run(go())


def test_port_client_drives_the_reference_server():
    jg = jba()
    kws = [dict(k=2, theta=THETA), dict(k=5, theta=THETA),
           dict(k=1, theta=THETA)]

    async def go():
        jsvc = jserve.build_service({"graph": jg}, jserve.ServeConfig(
            max_batch=8, batch_window_s=0.002, solver_opts=REF_OPTS))
        server = jserve.IMNetServer(jsvc, port=0)
        await server.start()
        try:
            c = IMClient("127.0.0.1", server.port)
            docs = await asyncio.gather(*(c.solve("graph", IMProblem(**kw))
                                          for kw in kws))
            inproc = [await jsvc.submit("graph", JProblem(**kw))
                      for kw in kws]
            for doc, ip in zip(docs, inproc):
                _wire_equals(doc, ip.result)
            with pytest.raises(UnknownGraphError):
                await c.solve("nope", IMProblem(**kws[0]))
            bad = IMProblem(k=1, theta=THETA,
                            candidates=np.array([jg.n_nodes + 5]))
            with pytest.raises(InvalidProblemError):
                await c.solve("graph", bad)
            status, doc = await c.solve_raw("nope", IMProblem(**kws[0]))
            assert (status, doc["error"]["code"]) == (404, "unknown_graph")
            status, doc = await c.solve_raw("graph", bad)
            assert (status, doc["error"]["code"]) == (400, "invalid_problem")
        finally:
            await server.shutdown(spill=False)

    run(go())


def test_cli_serves_on_the_cpu_and_drains_on_sigterm(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.net", "--device", "cpu",
         "--port", "0", "--n", "200", "--spill-dir", str(tmp_path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], TIMEOUT_S)
        assert ready, "the server printed nothing"
        line = proc.stdout.readline()
        assert line.startswith("serving graph(n=200) on cpu at http://"), \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.rsplit(":", 1)[1])

        async def go():
            c = IMClient("127.0.0.1", port)
            return await c.solve("graph", IMProblem(k=3, theta=THETA))
        doc = run(go())
        g = tnet._build_graph(200, 4, 0, device="cpu")
        _wire_equals(doc, IMMSolver(g, **OPTS).solve(
            IMProblem(k=3, theta=THETA)))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained, warm pools spilled" in out
    assert any(os.scandir(tmp_path))


# -- cluster ------------------------------------------------------------------

def test_cluster_routing_handoff_parity():
    g = ba(160)
    thetas = list(range(128, 140))

    async def go():
        cl = IMCluster({"graph": g}, ServeConfig(
            max_batch=8, solver_opts=OPTS), workers=2)
        await cl.start()
        try:
            base = {}
            for t in thetas:
                r = await cl.submit("graph", IMProblem(k=3, theta=t))
                base[t] = r.result
            per_worker = [set(w.service.registry.entries.keys())
                          for w in cl._workers.values()]
            all_keys = set().union(*per_worker)
            assert sum(len(s) for s in per_worker) == len(all_keys)
            assert len(all_keys) == len(thetas)
            for w in cl._workers.values():
                for key, entry in w.service.registry.entries.items():
                    route = cl._entry_route(w.service.registry, key, entry)
                    assert cl.ring.owner(route) == w.wid
            # both workers' requests in flight at once answer as the cold
            # solves do
            both = await asyncio.gather(*(
                cl.submit("graph", IMProblem(k=2, theta=t)) for t in thetas))
            for t, r in zip(thetas, both):
                cold = IMMSolver(g, **OPTS).solve(IMProblem(k=2, theta=t))
                _same(cold, r.result)
            wid = cl.add_worker()
            hand = cl.handoffs
            assert hand > 0
            for w in cl._workers.values():
                for key, entry in w.service.registry.entries.items():
                    route = cl._entry_route(w.service.registry, key, entry)
                    assert cl.ring.owner(route) == w.wid
            new = cl._workers[wid].service.registry
            assert new.snapshot().handoffs_in == hand
            assert len(new.entries) == hand
            for t in thetas:
                r = await cl.submit("graph", IMProblem(k=4, theta=t))
                cold = IMMSolver(g, **OPTS).solve(IMProblem(k=4, theta=t))
                _same(cold, r.result)
            # the adopted pools served warm: nothing was built anew there
            assert new.snapshot().created == hand
            moved_back = cl.remove_worker(wid)
            assert moved_back == hand
            assert cl.handoffs == hand + moved_back
            for t in thetas:
                r = await cl.submit("graph", IMProblem(k=3, theta=t))
                _same(base[t], r.result)
            stz = await cl.statsz()
            assert stz["cluster"] and len(stz["workers"]) == 2
            assert stz["serve_total"]["served"] >= 2 * len(thetas)
            reg_hand = sum(s["serve"]["registry"]["handoffs_in"]
                           for s in stz["per_worker"])
            assert reg_hand >= moved_back
            json.dumps(stz)
        finally:
            await cl.stop()

    run(go())


def test_cluster_route_keys_equal_the_reference():
    g, jg = ba(120), jba(120)
    cl = IMCluster({"graph": g}, ServeConfig(solver_opts=OPTS))
    jcl = jserve.IMCluster({"graph": jg}, jserve.ServeConfig(
        solver_opts=REF_OPTS))
    for kw in (dict(k=3, theta=128), dict(k=3, eps=0.5),
               dict(k=2, theta=128, mode="approximate"),
               dict(k=2, theta=128, model="lt")):
        assert cl.route_key("graph", IMProblem(**kw)) == \
            jcl.route_key("graph", JProblem(**kw))
    with pytest.raises(UnknownGraphError):
        cl.route_key("nope", IMProblem(k=1, theta=64))


def test_cluster_unknown_graph_typed():
    g = ba(120)

    async def go():
        cl = IMCluster({"graph": g}, ServeConfig(solver_opts=OPTS),
                       workers=1)
        await cl.start()
        try:
            with pytest.raises(UnknownGraphError):
                await cl.submit("nope", IMProblem(k=1, theta=64))
            with pytest.raises(ValueError):
                cl.remove_worker(0)
        finally:
            await cl.stop()

    run(go())


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.seeds), np.asarray(b.seeds))
    np.testing.assert_array_equal(np.asarray(a.gains), np.asarray(b.gains))
    assert np.float32(a.frac).tobytes() == np.float32(b.frac).tobytes()
    assert np.float32(a.spread).tobytes() == np.float32(b.spread).tobytes()
    assert a.cost == b.cost
