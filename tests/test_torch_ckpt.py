"""Durable pool checkpoints on the port, against the JAX reference on the
CPU.

* ``repro_torch.ckpt.checkpoint`` writes the reference's format: the same
  keys (``jax.tree_util.keystr`` paths), dtypes, shapes, ``arrays.npz``
  names and manifest for one state, and each package reads the other's
  files; rotation and the latest step as the reference's.
* ``IMMSolver.save_pool``/``restore_pool`` in the ``im-pool`` format, both
  ways: a reference pool restored by the port holds the reference store's
  ``state()`` element for element, samples nothing more for its θ and
  selects the reference's seeds, gains and ``frac`` bytes; the port's pool
  restored by the reference does the same; a restored reference
  checkpoint saved again by the port gives the reference's arrays and
  meta (the port adds its seed stream under ``meta["rng"]``).  The same
  for the pool-free sketch store (version 2).
* Foreign, missing and unknown-version checkpoints raise as the
  reference's.
* Resume within the port: a ``checkpoint_every=2`` checkpoint taken in the
  middle of a fixed-θ solve, and one of an eps-driven solve that crashes
  at ``select`` once its LB loop has started, restored into a fresh
  solver, finish equal to the uninterrupted solve in every field; so does
  a pool exported in the middle of sampling and adopted by another
  solver; and a restore in a new Python process.

The reference side selects with ``fused`` (its ``bitset`` and ``auto``
raise under this JAX).
"""
import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core.imm import IMMSolver as JSolver
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.ft.failures import FaultInjector, FaultPolicy, InjectedFailure

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N, M = 300, 1500
THETA = 1024
OPTS = {"batch": 32, "seed": 7, "selection": "fused", "sketch_k": 64}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def graphs():
    src, dst = jgen.erdos_renyi(N, M, seed=0)
    jg = jw.wc_weights(jcsr.from_edges(src, dst, N))
    tg = convert.graph_from_arrays(np.asarray(jg.offsets),
                                   np.asarray(jg.indices),
                                   np.asarray(jg.weights), device=CPU)
    return jg, tg


@pytest.fixture(scope="module")
def ref_pool(graphs, tmp_path_factory):
    """A reference solve at θ and its pool checkpoint."""
    jg, _ = graphs
    d = str(tmp_path_factory.mktemp("ref_pool"))
    js = JSolver(jg, **OPTS)
    res = js.solve(JProblem(k=4, theta=THETA))
    js.save_pool(d)
    return {"dir": d, "res": res, "state": js.store.state(),
            "rounds": js.stats.rounds}


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.seeds), np.asarray(b.seeds))
    np.testing.assert_array_equal(np.asarray(a.gains), np.asarray(b.gains))
    assert np.float32(a.frac).tobytes() == np.float32(b.frac).tobytes()
    assert a.frac == b.frac and a.spread == b.spread


def _same_everywhere(a, b):
    """Equal in every field of the result and its stats."""
    _same(a, b)
    assert np.asarray(a.seeds).dtype == np.asarray(b.seeds).dtype
    assert (a.cost, a.degraded, a.spread_bounds) == \
        (b.cost, b.degraded, b.spread_bounds)
    assert asdict(a.stats) == asdict(b.stats)


def _arrays_equal(mine: dict, theirs: dict):
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        want = np.asarray(theirs[k])
        assert mine[k].dtype == want.dtype, k
        assert mine[k].shape == want.shape, k
        assert mine[k].tobytes() == want.tobytes(), k


# ------------------------------------------------------ the module itself

def test_checkpoint_files_match_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    state = {"w": rng.random((3, 4)).astype(np.float32),
             "b": np.arange(5, dtype=np.int64),
             "nested": {"z": np.zeros((), np.int32),
                        "a": np.array([True, False])},
             "seq": [np.uint32(7), np.ones(2, np.uint32)]}
    tstate = dict(state, w=torch.from_numpy(state["w"]))   # a tensor leaf
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    for step in (1, 2, 3, 4):
        jckpt.save(jd, step, state, keep=2, meta={"tag": step})
        tckpt.save(td, step, tstate, keep=2, meta={"tag": step})
    assert tckpt.all_steps(td) == jckpt.all_steps(jd) == [3, 4]
    assert tckpt.latest_step(td) == jckpt.latest_step(jd) == 4
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    assert not [n for n in os.listdir(td) if n.startswith(".tmp")]
    mine, theirs = tckpt.load_manifest(td, 4), jckpt.load_manifest(jd, 4)
    assert mine == theirs
    assert mine["keys"][:3] == ["['b']", "['nested']['a']",
                                "['nested']['z']"]
    with open(os.path.join(td, "step_000000000004", "manifest.json")) as f:
        raw_mine = f.read()
    with open(os.path.join(jd, "step_000000000004", "manifest.json")) as f:
        assert raw_mine == f.read()
    # each reads the other's files
    for a, b in ((tckpt.restore_items(jd, 4), jckpt.restore_items(td, 4)),
                 (tckpt.restore_items(td, 4), jckpt.restore_items(jd, 4))):
        _arrays_equal(a, b)
    # restore into a structure, on an explicit device
    back = tckpt.restore(jd, 3, tstate, device=CPU)
    assert torch.equal(back["w"], tstate["w"])
    assert back["nested"]["a"].dtype == torch.bool
    assert back["seq"][1].tolist() == [1, 1]
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore(jd, 3, {"w": tstate["w"]}, device=CPU)


# ------------------------------------------------ pools across packages

def test_port_restores_the_reference_pool(graphs, ref_pool):
    _, tg = graphs
    s = IMMSolver(tg, device=CPU, **OPTS)
    assert s.restore_pool(ref_pool["dir"]) == ref_pool["rounds"]
    _arrays_equal(s.store.state(), ref_pool["state"])
    n_rr = s.store.n_rr
    got = s.solve(IMProblem(k=4, theta=THETA))
    assert s.store.n_rr == n_rr                  # θ reached: no sampling
    assert got.stats.rounds == ref_pool["rounds"]
    _same_everywhere(got, ref_pool["res"])


def test_reference_restores_the_port_pool(graphs, tmp_path):
    jg, tg = graphs
    d = str(tmp_path / "port")
    s = IMMSolver(tg, device=CPU, **OPTS)
    mine = s.solve(IMProblem(k=4, theta=THETA))
    s.save_pool(d)
    js = JSolver(jg, **OPTS)
    js.restore_pool(d)
    _arrays_equal(s.store.state(), js.store.state())
    rounds = js.stats.rounds
    theirs = js.solve(JProblem(k=4, theta=THETA))
    assert js.stats.rounds == rounds
    _same_everywhere(mine, theirs)


def test_resaved_reference_checkpoint_is_the_reference_file(graphs,
                                                            ref_pool,
                                                            tmp_path):
    _, tg = graphs
    s = IMMSolver(tg, device=CPU, **OPTS)
    step = s.restore_pool(ref_pool["dir"])
    d = str(tmp_path / "again")
    s.save_pool(d)
    mine, theirs = (tckpt.load_manifest(d, step),
                    jckpt.load_manifest(ref_pool["dir"], step))
    for key in ("step", "keys", "dtypes", "shapes"):
        assert mine[key] == theirs[key], key
    assert mine["meta"].pop("rng") == {"kind": "counter", "seed": 7,
                                       "cursor": ref_pool["rounds"]}
    assert mine["meta"] == theirs["meta"]
    a, b = tckpt.restore_items(d, step), jckpt.restore_items(
        ref_pool["dir"], step)
    assert a.pop("['rng_key']").tolist() == [ref_pool["rounds"], 7]
    b.pop("['rng_key']")
    _arrays_equal(a, b)


def test_sketch_pool_checkpoints_both_ways(graphs, tmp_path):
    jg, tg = graphs
    p = dict(k=4, theta=512, mode="approximate")
    js = JSolver(jg, **dict(OPTS, sketch_k=256))
    want = js.solve(JProblem(**p))
    jd = str(tmp_path / "j")
    js.save_pool(jd)
    s = IMMSolver(tg, device=CPU, **dict(OPTS, sketch_k=256))
    s.restore_pool(jd)
    _arrays_equal(s.store.state(), js.store.state())
    got = s.solve(IMProblem(**p))
    _same_everywhere(got, want)
    # the port's pool-free pool, read by the reference
    td = str(tmp_path / "t")
    s2 = IMMSolver(tg, device=CPU, **dict(OPTS, sketch_k=256))
    mine = s2.solve(IMProblem(**p))
    s2.save_pool(td)
    assert tckpt.load_manifest(td, s2.stats.rounds)["meta"]["version"] == 2
    js2 = JSolver(jg, **dict(OPTS, sketch_k=256))
    js2.restore_pool(td)
    _same_everywhere(mine, js2.solve(JProblem(**p)))


def test_restore_refuses_foreign_missing_and_unknown(graphs, ref_pool,
                                                     tmp_path):
    jg, tg = graphs
    s = IMMSolver(tg, device=CPU, **OPTS)
    js = JSolver(jg, **OPTS)
    for solver in (s, js):
        with pytest.raises(FileNotFoundError, match="no pool checkpoint"):
            solver.restore_pool(str(tmp_path / "nope"))
    d = str(tmp_path / "train")
    tckpt.save(d, 1, {"w": np.zeros(3)}, meta={"format": "train"})
    msgs = []
    for solver in (s, js):
        with pytest.raises(ValueError, match="im-pool") as e:
            solver.restore_pool(d)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    v = str(tmp_path / "v9")
    tckpt.save(v, 1, {"w": np.zeros(3)},
               meta={"format": "im-pool", "version": 9})
    msgs = []
    for solver in (s, js):
        with pytest.raises(ValueError, match="not supported") as e:
            solver.restore_pool(v)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a solver of other options refuses the pool
    other = IMMSolver(tg, device=CPU, **dict(OPTS, sketch_k=128))
    with pytest.raises(ValueError, match="signature"):
        other.restore_pool(ref_pool["dir"])


# ------------------------------------------------------ resume in-port

def test_midstream_checkpoint_resume_equals_uninterrupted(graphs, tmp_path):
    _, tg = graphs
    p = IMProblem(k=4, theta=THETA)
    clean = IMMSolver(tg, device=CPU, **OPTS).solve(p)
    d = str(tmp_path / "ck")
    s1 = IMMSolver(tg, device=CPU, checkpoint_dir=d, checkpoint_every=2,
                   **OPTS)
    s1.prepare(p)
    s1.sample_until(THETA // 2)
    step = tckpt.latest_step(d)
    assert step is not None and step % 2 == 0 and step < s1.stats.rounds + 1
    s2 = IMMSolver(tg, device=CPU, **OPTS)
    assert s2.restore_pool(d) == step
    assert s2._cursor == step
    _same_everywhere(s2.solve(p), clean)


def test_exported_pool_adopted_elsewhere_equals_uninterrupted(graphs):
    _, tg = graphs
    p = IMProblem(k=4, theta=THETA)
    clean = IMMSolver(tg, device=CPU, **OPTS).solve(p)
    s1 = IMMSolver(tg, device=CPU, **OPTS)
    s1.prepare(p)
    s1.sample_until(THETA // 2)
    lease = s1.export_pool()
    assert lease.cursor == lease.stats.rounds > 0
    assert lease.pool_bytes() == lease.store.per_device_pool_bytes() + \
        lease.store.sketch_bytes() > 0
    assert s1.pool_bytes() == 0 and s1.store is None
    with pytest.raises(RuntimeError, match="nothing to export"):
        s1.export_pool()
    s2 = IMMSolver(tg, device=CPU, **OPTS)
    s2.adopt_pool(lease)
    _same_everywhere(s2.solve(p), clean)
    assert s2.drop_pool() > 0 and s2.pool_bytes() == 0
    other = IMMSolver(tg, device=CPU, **dict(OPTS, sketch_k=None))
    with pytest.raises(ValueError, match="signature"):
        other.adopt_pool(IMMSolver(tg, device=CPU, **OPTS).export_pool())


def test_eps_solve_crashing_at_select_resumes(graphs, tmp_path):
    _, tg = graphs
    p = IMProblem(k=4, eps=0.4, max_theta=2048)
    clean = IMMSolver(tg, device=CPU, **OPTS).solve(p)
    assert len([h for h in clean.stats.history if h[0] == "lb_iter"]) >= 2
    d = str(tmp_path / "ck")
    pol = FaultPolicy(injector=FaultInjector(fail_at={"select": {2}}),
                      max_retries=0, sleep=lambda s: None)
    s1 = IMMSolver(tg, device=CPU, fault_policy=pol, checkpoint_dir=d,
                   checkpoint_every=2, **OPTS)
    with pytest.raises(InjectedFailure):
        s1.solve_problem(p)
    assert s1.stats.lb_completed == 1           # the LB loop had started
    s2 = IMMSolver(tg, device=CPU, checkpoint_dir=d, checkpoint_every=2,
                   **OPTS)
    s2.restore_pool(d)
    assert s2._active_solve == p.signature_digest()
    got = s2.solve_problem(p)
    assert s2._active_solve is None
    _same_everywhere(got, clean)


def test_restore_in_a_new_process(graphs, tmp_path):
    _, tg = graphs
    p = IMProblem(k=4, theta=THETA)
    clean = IMMSolver(tg, device=CPU, **OPTS).solve(p)
    d = str(tmp_path / "ck")
    s1 = IMMSolver(tg, device=CPU, checkpoint_dir=d, checkpoint_every=3,
                   **OPTS)
    s1.prepare(p)
    s1.sample_until(THETA // 2)
    gpath = str(tmp_path / "g.npz")
    np.savez(gpath, *tg.numpy())
    code = f"""
import json, sys
import numpy as np, torch
from dataclasses import asdict
from repro_torch import convert
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
torch.set_num_threads(1)
a = np.load({gpath!r})
g = convert.graph_from_arrays(a["arr_0"], a["arr_1"], a["arr_2"], device="cpu")
s = IMMSolver(g, device="cpu", **{OPTS!r})
step = s.restore_pool({d!r})
r = s.solve(IMProblem(k=4, theta={THETA}))
print(json.dumps({{"step": step, "seeds": r.seeds.tolist(),
                   "gains": r.gains.tolist(), "frac": r.frac,
                   "stats": asdict(r.stats)}}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["step"] == tckpt.latest_step(d)
    assert got["seeds"] == clean.seeds.tolist()
    assert got["gains"] == clean.gains.tolist()
    assert got["frac"] == clean.frac
    want = json.loads(json.dumps(asdict(clean.stats)))
    assert got["stats"] == want
