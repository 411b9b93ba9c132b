"""The port's sharded solve against itself, on gloo ranks on the CPU.

One ``torch.multiprocessing`` spawn of 8 gloo ranks runs every check of
the file: the ranks form meshes of 1, 2 and 8 ranks (subgroups of the 8),
and on each mesh solve one problem with every plain selection (``fused``,
``bitset``, ``celf-sketch``, and ``auto`` with the θ early exit), with the
``queue`` engine (every rank draws the whole round; the store deals it)
and with ``queue_sharded`` at ``64 / D`` lanes a rank
(``launch.im_solve.solve`` and ``IMMSolver(engine="queue_sharded")``).
Each rank writes its results to a file; the tests hold them against the
same solves without a mesh: every rank of every mesh must give the
no-mesh ``queue`` solve at batch 64 in every result field but the mesh's
own (``mesh_shape``, ``pool_sharding``, ``per_device_pool_bytes``).  The
``queue_sharded`` engine's gathered round must equal the ``queue``
engine's round at batch D·b byte for byte, and each rank's block its rows.
On more than one rank, what the slice does not shard raises
``NotImplementedError`` naming ROADMAP [9b].
"""
import json
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.engine import make_engine
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.core.rrset import round_seed
from repro_torch.graph import csr, generators, weights
from repro_torch.launch import im_solve
from repro_torch.launch.mesh import SampleMesh

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

WORLD = 8
SIZES = (1, 2, 8)
BATCH, SEED = 64, 3
SOLVES = ("fused", "bitset", "celf-sketch", "auto+early_exit")
MESH_FIELDS = ("mesh_shape", "pool_sharding", "per_device_pool_bytes")


def _graph():
    src, dst = generators.erdos_renyi(60, 300, seed=6)
    return weights.wc_weights(csr.from_edges(src, dst, 60, device="cpu"))


def _problem(early_exit: bool = False) -> IMProblem:
    return IMProblem(k=4, eps=0.5, max_theta=256, early_exit=early_exit)


def _fields(res) -> dict:
    """A result's fields as JSON values; the mesh's own stats apart."""
    st = asdict(res.stats)
    mesh = {k: st.pop(k) for k in MESH_FIELDS}
    out = {"seeds": res.seeds.tolist(), "gains": res.gains.tolist(),
           "frac": float(res.frac), "spread": float(res.spread),
           "cost": float(res.cost), "stats": st,
           "bounds": res.spread_bounds}
    return json.loads(json.dumps({"fields": out, "mesh": mesh}))


def _solve(g, name: str, mesh=None, engine="queue", batch=BATCH):
    sel, _, early = name.partition("+")
    solver = IMMSolver(g, engine=engine, batch=batch, seed=SEED,
                       selection=sel, device="cpu", mesh=mesh)
    return _fields(solver.solve(_problem(bool(early))))


def _round_checks(g, mesh) -> dict:
    """The queue_sharded rounds against the queue engine's at D·b."""
    b = BATCH // mesh.size
    rev = csr.reverse(g)
    sharded = make_engine("queue_sharded", rev, mesh=mesh, batch=b)
    plain = make_engine("queue", rev, batch=BATCH)
    ok = {"sample": True, "sample_sharded": True}
    for t in range(3):
        s32 = round_seed(SEED, t)
        want = plain.sample(s32)
        got = sharded.sample(s32)
        ok["sample"] &= bool(
            all(torch.equal(x, y) for x, y in zip(
                (got.nodes, got.lengths, got.overflowed, got.roots),
                (want.nodes, want.lengths, want.overflowed, want.roots)))
            and got.steps == want.steps)
        blk = sharded.sample_sharded(s32)
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        ok["sample_sharded"] &= bool(
            torch.equal(blk.nodes, want.nodes[rows])
            and torch.equal(blk.lengths, want.lengths[rows])
            and torch.equal(blk.roots, want.roots[rows])
            and torch.equal(blk.overflowed, want.overflowed)
            and blk.steps == want.steps and blk.mesh is mesh)
    return ok


def _refusals(g, mesh) -> dict:
    """What raises NotImplementedError on this mesh (nothing on one rank
    but the listed calls run there)."""
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = "[9b]" if "ROADMAP [9b]" in str(e) else str(e)

    def solver(**kw):
        return IMMSolver(g, batch=BATCH, device="cpu", mesh=mesh, **kw)

    attempt("candidates", lambda: solver().solve(IMProblem(
        k=2, theta=128, candidates=np.arange(10))))
    attempt("approximate", lambda: solver(sketch_k=64).solve(IMProblem(
        k=2, eps=0.5, mode="approximate", max_theta=128)))
    attempt("solve_stacked", lambda: solver().solve_stacked(
        [IMProblem(k=2, theta=128)]))
    attempt("deadline", lambda: solver().solve_problem(
        IMProblem(k=2, theta=128), deadline_s=100.0))
    attempt("checkpoint", lambda: solver(checkpoint_dir="unused"))
    return out


def _ranks(rank, size, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        # every rank creates every subgroup, in the same order
        groups = {d: (None if d == size else dist.new_group(list(range(d))))
                  for d in SIZES}
        g = _graph()
        results = {}
        for d in SIZES:
            if rank >= d:
                continue
            mesh = SampleMesh(groups[d], rank, d, "samples", "cpu")
            res = {name: _solve(g, name, mesh) for name in SOLVES}
            res["queue_sharded"] = _solve(g, "fused", mesh,
                                          engine="queue_sharded",
                                          batch=BATCH // d)
            seeds, spread, st = im_solve.solve(
                g, batch_per_dev=BATCH // d, seed=SEED, selection="fused",
                mesh=mesh, problem=_problem())
            res["im_solve"] = {"seeds": seeds.tolist(), "spread": spread,
                               "theta": st["theta"],
                               "sampled": st["sampled"],
                               "devices": st["devices"],
                               "pool_sharding": st["pool_sharding"]}
            res["rounds"] = _round_checks(g, mesh)
            res["refusals"] = _refusals(g, mesh)
            results[str(d)] = res
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("im_solve")
    mp.spawn(_ranks, nprocs=WORLD,
             args=(WORLD, f"file://{tmp / 'rdzv'}", str(tmp)))
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def no_mesh():
    g = _graph()
    return {name: _solve(g, name) for name in SOLVES}


@pytest.mark.parametrize("name", SOLVES)
@pytest.mark.parametrize("size", SIZES)
def test_mesh_solve_equals_no_mesh_solve(ranks, no_mesh, size, name):
    want = no_mesh[name]
    assert want["mesh"]["mesh_shape"] == [1]
    for rank in range(size):
        got = ranks[rank][str(size)][name]
        assert got["fields"] == want["fields"], (size, rank, name)
        assert got["mesh"]["mesh_shape"] == [size]
        assert got["mesh"]["pool_sharding"] == f"samples:{size}"


def test_selections_agree_without_a_mesh(no_mesh):
    flat = no_mesh["fused"]["fields"]
    for name in ("bitset", "celf-sketch"):
        got = dict(no_mesh[name]["fields"])
        want = dict(flat)
        got["stats"] = {k: v for k, v in got["stats"].items()
                        if k != "selection"}
        want["stats"] = {k: v for k, v in want["stats"].items()
                         if k != "selection"}
        assert got == want, name


@pytest.mark.parametrize("size", SIZES)
def test_queue_sharded_solve_equals_queue_at_the_whole_batch(ranks, no_mesh,
                                                             size):
    want = no_mesh["fused"]["fields"]
    for rank in range(size):
        got = ranks[rank][str(size)]["queue_sharded"]["fields"]
        assert got == want, (size, rank)
        launched = ranks[rank][str(size)]["im_solve"]
        assert launched["seeds"] == want["seeds"]
        assert launched["spread"] == want["spread"]
        assert launched["theta"] == want["stats"]["theta"]
        assert launched["sampled"] == want["stats"]["n_rr_sampled"]
        assert launched["devices"] == size
        assert launched["pool_sharding"] == f"samples:{size}"


@pytest.mark.parametrize("size", SIZES)
def test_queue_sharded_rounds_are_the_queue_rounds(ranks, size):
    for rank in range(size):
        assert ranks[rank][str(size)]["rounds"] == {
            "sample": True, "sample_sharded": True}, (size, rank)


@pytest.mark.parametrize("size", SIZES)
def test_what_is_not_sharded_raises_on_more_than_one_rank(ranks, size):
    want = ("[9b]" if size > 1 else "ran")
    for rank in range(size):
        got = ranks[rank][str(size)]["refusals"]
        assert got == {name: want for name in got} and len(got) == 5, \
            (size, rank, got)


def test_main_runs_one_rank(capsys):
    im_solve.main(["--n", "120", "--k", "3", "--eps", "0.5", "--batch",
                   "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "devices=1 mesh=samples:1" in out
    seeds = json.loads(out.split("seeds=")[1].split(" estimate")[0])
    assert len(set(seeds)) == 3
