"""The persistent-lane (refill) sampler of the port (``core/rrset.py::
sample_rrsets_refill``, ``kernels/ref.py::refill_round_ref``, the
``refill`` engine) against the JAX reference and the queue sampler.

* At p = 1 every row is the reverse-reachable set of its root.
* The law: each node's share of the rows against the reference's
  ``sample_rrsets_refill`` and the oracle's ``rr_set_ic`` (4.5σ, as the
  reference's ``tests/test_refill_engine.py``).
* Row r is the queue round's lane r: the refill batch, in row-id order,
  equals the queue engine's batch at ``batch = quota`` row for row at 1, 3
  and 64 lanes, and ``imm(engine="refill")`` equals ``imm(engine=
  "queue")`` in every field but the steps.
* The plain loop's micro-steps equal ``refill_schedule_steps`` of the
  rows' counts, and for 512 rows 128 lanes take fewer lock-step steps than
  four queue rounds of 128 lanes (the reference's claim).
* ``refill_to_lists``, ``refill_to_padded`` and ``refill_to_padded_device``
  fed the reference's own arrays give the reference's outputs.
* Overflow at a small ``out_cap`` sets the lane's flag and emits no partial
  set; weighted roots above 2^22 nodes are refused as in the reference.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine, oracle, rrset as jrrset
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core import rrset
from repro_torch.core.engine import (ONE_UNIFORM_MAX_N, list_engines,
                                     make_engine)
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"


def _wc(n, m, seed, kind="er"):
    src, dst = (generators.erdos_renyi(n, m, seed=seed) if kind == "er"
                else generators.barabasi_albert(n, m, seed=seed))
    return weights.wc_weights(csr.from_edges(src, dst, n, device=CPU))


def _reverse_reachable(g_rev, root):
    offs, idx, _ = g_rev.numpy()
    seen, stack = {root}, [root]
    while stack:
        u = stack.pop()
        for v in idx[offs[u]:offs[u + 1]].tolist():
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


def test_engines_registry_and_refill_defaults():
    assert list_engines() == ["dense", "lt", "mrim", "queue",
                              "queue_sharded", "refill"]
    assert list_engines() == jengine.list_engines()
    g_rev = csr.reverse(_wc(40, 160, 1))
    jg_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(
        *jgen.erdos_renyi(40, 160, seed=1), 40)))
    for batch in (16, 256, 512, 4096):
        mine = make_engine("refill", g_rev, batch=batch)
        theirs = jengine.make_engine("refill", jg_rev, batch=batch)
        assert (mine.lanes, mine.out_cap) == (theirs.lanes, theirs.out_cap)
        assert mine.item_space == 40


def test_p1_rows_are_reverse_reachable():
    src, dst = generators.erdos_renyi(40, 160, seed=1)
    g = weights.uniform_weights(csr.from_edges(src, dst, 40, device=CPU),
                                p=1.0)
    g_rev = csr.reverse(g)
    s = rrset.sample_rrsets_refill(g_rev, 4, 7, quota=12, out_cap=6 * 40)
    assert not bool(s.overflowed.any()) and int(s.n_done.sum()) == 12
    rows = rrset.refill_to_lists(s)
    assert sorted(s.rows[s.rows >= 0].tolist()) == list(range(12))
    for row in rows:
        assert len(set(row)) == len(row)
        assert set(row) == _reverse_reachable(g_rev, row[0])


@pytest.mark.parametrize("other", ["reference", "oracle"])
def test_law_matches_reference_and_oracle(other):
    """Each node's share of the rows, 4 x 256 rows each way, within 4.5σ."""
    src, dst = jgen.erdos_renyi(40, 200, seed=2)
    g_rev = csr.reverse(weights.wc_weights(csr.from_edges(src, dst, 40,
                                                          device=CPU)))
    jg_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(src, dst, 40)))
    occ = np.zeros((2, 40))
    totals = [0, 0]
    rng = np.random.default_rng(3)
    offs, idx, w = (np.asarray(a) for a in jg_rev)
    for i in range(4):
        for row in rrset.refill_to_lists(rrset.sample_rrsets_refill(
                g_rev, 64, rrset.round_seed(11, i), quota=256,
                out_cap=40 * 8)):
            occ[0, row] += 1
            totals[0] += 1
        if other == "reference":
            rows = jrrset.refill_to_lists(jrrset.sample_rrsets_refill(
                jax.random.key(100 + i), jg_rev, batch=64, quota=256,
                out_cap=40 * 8))
        else:
            rows = [oracle.rr_set_ic(offs, idx, w, int(rng.integers(40)), rng)
                    for _ in range(256)]
        for row in rows:
            occ[1, row] += 1
            totals[1] += 1
    assert totals[0] == 1024
    p1, p2 = occ[0] / totals[0], occ[1] / totals[1]
    se = np.sqrt((p1 * (1 - p1) + p2 * (1 - p2)) / min(totals)) + 1e-9
    assert (np.abs(p1 - p2) / se).max() < 4.5


@pytest.mark.parametrize("lanes", [1, 3, 64])
def test_refill_batch_equals_queue_batch(lanes):
    g_rev = csr.reverse(_wc(200, 3, 1, kind="ba"))
    queue = make_engine("queue", g_rev, batch=64).sample(123)
    eng = make_engine("refill", g_rev, batch=64, lanes=lanes)
    got = eng.sample(123)
    assert not bool(got.overflowed.any()) and got.n_sets == 64
    width = got.nodes.shape[1]
    assert width == queue.nodes.shape[1]
    assert torch.equal(got.nodes, queue.nodes)
    assert torch.equal(got.lengths, queue.lengths)
    assert torch.equal(got.roots, queue.roots)
    got.validate(200)
    dev = eng.sample_device(123)
    assert dev.nodes.shape == (64, eng.out_cap) and dev.steps == 0
    assert torch.equal(dev.nodes[:, :width], got.nodes)
    assert torch.equal(dev.lengths, got.lengths)
    # the plain loop's own count is the schedule of the rows' counts
    out = ref.refill_round_ref(eng.g_rev.offsets, eng.g_rev.indices,
                               eng.g_rev.weights, 123, lanes, quota=64,
                               out_cap=eng.out_cap,
                               max_sets=rrset.default_sets_per_lane(64, lanes),
                               ec=128)
    assert out[6] == got.steps
    if lanes == 1:     # one lane runs the rows one after another
        assert got.steps == int(out[5].sum())


def test_refill_solve_equals_queue_solve():
    g = _wc(300, 3, 4, kind="ba")
    fields = []
    for engine in ("queue", "refill"):
        solver = IMMSolver(g, engine=engine, batch=64, seed=6, device=CPU)
        res = solver.solve(IMProblem(k=4, eps=0.5))
        st = res.stats
        fields.append((st.theta, st.lb, st.lb_iters, st.rounds,
                       solver.store.n_rr, solver.store.n_elems,
                       res.seeds.tolist(), res.gains.tolist(),
                       np.float32(res.frac).tobytes(), res.spread,
                       st.overflow_fraction, solver.engine_name))
    assert fields[0][:-1] == fields[1][:-1]
    assert (fields[0][-1], fields[1][-1]) == ("queue", "refill")


def test_refill_takes_fewer_steps_than_queue_rounds():
    """512 RR sets: 128 persistent lanes against four rounds of 128."""
    g_rev = csr.coalesce_ic(csr.reverse(_wc(2000, 6, 0, kind="ba")))
    steps_round = sum(rrset.sample_rrsets_queue(g_rev, 128, 100 + i).steps
                      for i in range(4))
    s = rrset.sample_rrsets_refill(g_rev, 128, 9, quota=512, out_cap=2048)
    assert not bool(s.overflowed.any()) and int(s.n_done.sum()) == 512
    assert s.steps < 0.75 * steps_round, (s.steps, steps_round)


def test_unpack_functions_equal_reference():
    src, dst = jgen.erdos_renyi(40, 200, seed=5)
    jg_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(src, dst, 40)))
    js = jrrset.sample_rrsets_refill(jax.random.key(4), jg_rev, batch=8,
                                     quota=40, out_cap=160)
    arrays = [np.asarray(a) for a in (js.flat, js.lengths, js.n_done,
                                      js.overflowed)]
    mine = rrset.RefillSample(*arrays, steps=int(js.steps))
    assert rrset.refill_to_lists(mine) == jrrset.refill_to_lists(js)
    for got, want in zip(rrset.refill_to_padded(mine),
                         jrrset.refill_to_padded(js)):
        np.testing.assert_array_equal(got, want)
    got = rrset.refill_to_padded_device(
        *(torch.from_numpy(a.copy()) for a in arrays[:3]))
    want = jrrset.refill_to_padded_device(js.flat, js.lengths, js.n_done)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_overflow_sets_the_flag_and_emits_no_partial_set():
    g_rev = csr.reverse(_wc(200, 3, 1, kind="ba"))
    eng = make_engine("refill", g_rev, batch=64, lanes=4, out_cap=24)
    s = rrset.sample_rrsets_refill(eng.g_rev, 4, 5, quota=64, out_cap=24)
    assert bool(s.overflowed.any())
    queue = make_engine("queue", g_rev, batch=64).sample(5)
    lists = rrset.refill_to_lists(s)
    ids = s.rows[s.rows >= 0].tolist()
    assert len(lists) == len(ids) == int(s.n_done.sum()) < 64
    for r, row in zip(ids, lists):
        assert row == queue.nodes[r, :queue.lengths[r]].tolist()
    flat, lengths = s.flat.numpy(), s.lengths.numpy()
    for lane in range(4):
        assert not flat[lane, lengths[lane].sum():].any()
    batch = eng.sample(5)
    assert bool(batch.overflowed.any())
    assert int((batch.lengths > 0).sum()) == len(ids)


def test_weighted_roots_refused_above_one_uniform_bound():
    n = ONE_UNIFORM_MAX_N + 1
    g_rev = csr.from_edges([0, 1], [1, 0], n, device=CPU)
    with pytest.raises(ValueError, match="one-uniform alias draw"):
        make_engine("refill", g_rev, root_weights=np.ones(n, np.float32))
    small = csr.reverse(_wc(40, 160, 1))
    eng = make_engine("refill", small, batch=64,
                      root_weights=(np.arange(40) % 3).astype(np.float32))
    batch = eng.sample(3)
    assert (batch.roots.numpy() % 3 != 0).all()
    queue = make_engine("queue", small, batch=64,
                        root_weights=(np.arange(40) % 3).astype(np.float32))
    assert torch.equal(batch.nodes, queue.sample(3).nodes[
        :, :batch.nodes.shape[1]])
