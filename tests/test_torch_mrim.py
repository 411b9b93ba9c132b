"""Multi-round IM (MRIM, paper §4.8) in the port: the ``mrim`` engine
(T lanes of one queue round that share a root, ``queue_bfs``'s
``root_tile``), ``IMProblem(t_rounds=T)`` and ``core/mrim.py`` against the
JAX reference.

* At T = 1 the MRIM round equals the queue round byte for byte.
* Every merged row is the concatenation of its T encoded BFS (``round * n
  + node``) of the tiled queue round, all from one root.
* KS of the MRIM sizes against the oracle's (one root, T independent IC
  BFS), as ``tests/test_conformance.py`` does.
* On the reference's tagged pool (its ``MRIMEngine`` batches as numpy) the
  port's ``flat``, ``bitset`` and ``celf`` selections under
  ``SelectionSpec(n_group=n, n_groups=T, group_quota=k)`` give the
  reference's ``fused`` seeds, gains and ``frac``, bit for bit.
* ``seeds_per_round`` and ``solve_mrim`` equal the ``IMMSolver`` path, the
  validation messages are the reference's, and a tagged engine instance
  waits for a problem with the matching ``t_rounds``.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats as sps

from repro.core import coverage as jcov, oracle
from repro.core.engine import make_engine as jmake_engine
from repro.core.problem import IMProblem as JProblem
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core import coverage as tcov, mrim
from repro_torch.core.engine import MRIMEngine, make_engine
from repro_torch.core.imm import IMMSolver, imm
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr, weights
from repro_torch.kernels import ref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N = 60


def _graphs(n=N, seed=8):
    src, dst = jgen.erdos_renyi(n, 5 * n, seed=seed)
    return (weights.wc_weights(csr.from_edges(src, dst, n, device=CPU)),
            jw.wc_weights(jcsr.from_edges(src, dst, n)))


def _bits(x):
    return np.asarray(x).tobytes()


def test_mrim_round_at_one_round_equals_queue_round():
    g, _ = _graphs()
    got = make_engine("mrim", csr.reverse(g), batch=32, t_rounds=1).sample(7)
    want = make_engine("queue", csr.reverse(g), batch=32).sample(7)
    for x, y in zip(got[:3] + (got.roots,), want[:3] + (want.roots,)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert got.steps == want.steps


@pytest.mark.parametrize("t", [2, 3])
def test_merged_rows_are_the_tagged_bfs_of_one_root(t):
    g, _ = _graphs()
    g_rev = csr.coalesce_ic(csr.reverse(g))
    eng = make_engine("mrim", g_rev, batch=24, t_rounds=t)
    b = eng.sample(9)
    b.validate(eng.item_space)
    queue, lengths, over, steps, roots = ref.queue_round_ref(
        g_rev.offsets, g_rev.indices, g_rev.weights, 9, 24 * t, qcap=N,
        ec=128, root_tile=t)
    assert b.steps == int(steps.max())
    np.testing.assert_array_equal(b.roots.numpy(), roots.numpy()[::t])
    nodes, lens = b.nodes.numpy(), b.lengths.numpy()
    for s in range(24):
        want = []
        for r in range(t):
            lane = s * t + r
            seg = queue[lane, :lengths[lane]].numpy()
            assert seg[0] == roots[s * t]
            want += (seg + r * N).tolist()
        assert nodes[s, :lens[s]].tolist() == want
        assert not nodes[s, lens[s]:].any()
    assert torch.equal(b.overflowed, over.reshape(24, t).any(dim=1))
    # the rounds' trials differ: some sample's rounds reach different sets
    assert any(len(set(nodes[s, :lens[s]] % N)) < lens[s] or
               len(set((nodes[s, :lens[s]] // N).tolist())) == t
               for s in range(24))


def test_ks_mrim_sizes_against_oracle():
    g, jg = _graphs()
    eng = make_engine("mrim", csr.reverse(g), batch=128, t_rounds=2)
    sizes = np.concatenate([eng.sample(i).lengths.numpy() for i in range(4)])
    jg_rev = jcsr.reverse(jg)
    offs, idx, w = (np.asarray(a) for a in jg_rev)
    rng = np.random.default_rng(1)
    want = []
    for _ in range(sizes.size):
        root = int(rng.integers(N))
        want.append(sum(len(oracle.rr_set_ic(offs, idx, w, root, rng))
                        for _ in range(2)))
    res = sps.ks_2samp(sizes, want)
    assert res.pvalue > 0.01, (res, sizes.mean(), np.mean(want))


@pytest.fixture(scope="module")
def tagged_pool():
    """Three batches of the reference's MRIM engine (T = 3), as numpy."""
    _, jg = _graphs(seed=4)
    eng = jmake_engine("mrim", jcsr.reverse(jg), batch=64, t_rounds=3)
    out, key = [], jax.random.key(2)
    for _ in range(3):
        key, sub = jax.random.split(key)
        b = eng.sample(sub)
        out.append((np.asarray(b.nodes), np.asarray(b.lengths)))
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_selections_on_the_reference_pool_equal_fused(tagged_pool, k):
    t = 3
    js = jcov.ShardedDeviceRRStore(N * t)
    ps = tcov.DeviceRRStore(N * t, sketch_k=256, device=CPU)
    for nodes, lens in tagged_pool:
        js.append_batch((nodes, lens))
        ps.append_batch((nodes.copy(), lens))

    def spec(mod):
        return mod.SelectionSpec(k_steps=k * t, n_group=N, n_groups=t,
                                 group_quota=k)
    want = jcov.select_variant(js, spec(jcov), method="flat")
    got = {m: tcov.select_variant(ps, spec(tcov), method=m)
           for m in ("flat", "bitset")}
    got["celf"] = tcov.select_seeds_celf(ps, 0, spec=spec(tcov),
                                         eval_batch=4)
    for m, res in got.items():
        for f in ("seeds", "gains", "frac"):
            assert _bits(getattr(res, f).numpy()) == \
                _bits(getattr(want, f)), (m, f)
    seeds = got["flat"].seeds.numpy()
    assert (np.bincount(seeds // N, minlength=t) == k).all()


def test_seeds_per_round_and_solve_mrim_equal_the_solver():
    g, _ = _graphs()
    outs, res = {}, None
    for sel in ("flat", "bitset", "celf"):
        res = IMMSolver(g, seed=0, batch=128, selection=sel,
                        device=CPU).solve(IMProblem(k=2, t_rounds=3,
                                                    theta=512))
        per_round = res.seeds_per_round()
        assert len(per_round) == 3 and all(len(s) == 2 for s in per_round)
        assert res.stats.variant == "mrim"
        outs[sel] = (res.seeds.tolist(), res.gains.tolist(),
                     _bits(np.float32(res.frac)))
    assert outs["flat"] == outs["bitset"] == outs["celf"]
    wrapped = mrim.solve_mrim(g, k=2, t_rounds=3, n_rr=512, batch=128,
                              seed=0, device=CPU)
    assert wrapped.seeds_per_round == res.seeds_per_round()
    assert wrapped.n_rr == res.stats.n_rr_sampled >= 512
    assert wrapped.spread_estimate == pytest.approx(N * res.frac)
    nodes, lens, over = mrim.sample_mrim_round(csr.reverse(g), 16, 3, 5)
    assert nodes.shape[0] == 16 and lens.min() >= 3 and not over.any()
    seeds, spread, st = imm(g, k=2, t_rounds=3, theta=512, batch=128,
                            device=CPU)
    assert seeds.tolist() == res.seeds.tolist() and st.variant == "mrim"
    assert spread == pytest.approx(N * res.frac)


@pytest.mark.parametrize("kw,msg", [
    (dict(k=2, t_rounds=2, mode="approximate"), "MRIM needs the tagged pool"),
    (dict(budget=2.0, t_rounds=2), "budgeted MRIM"),
    (dict(k=2, t_rounds=0), "t_rounds must be >= 1"),
    (dict(k=2, t_rounds=2, model="lt"), "IC-only")])
def test_validation_messages_equal_reference(kw, msg):
    for cls in (IMProblem, JProblem):
        with pytest.raises(ValueError, match=msg):
            cls(**kw)


def test_engine_instances_and_names():
    g, _ = _graphs()
    eng = MRIMEngine(csr.reverse(g), MRIMEngine.Config(batch=16, t_rounds=3))
    assert eng.item_space == 3 * N
    solver = IMMSolver(g, engine=eng, seed=1, device=CPU)
    assert solver.engine is None          # waits for its tagged problem
    res = solver.solve(IMProblem(k=2, t_rounds=3, theta=128))
    assert len(res.seeds_per_round()) == 3 and solver.engine is eng
    with pytest.raises(ValueError, match="item space"):
        IMMSolver(g, engine=eng, seed=1, device=CPU).solve(
            IMProblem(k=2, eps=0.5))
    with pytest.raises(ValueError, match="item space"):
        IMMSolver(g, engine="mrim", device=CPU)
    with pytest.raises(ValueError, match="no effect"):
        IMMSolver(g, engine=eng, batch=16, device=CPU)
    b = make_engine("mrim", csr.reverse(g), batch=16, t_rounds=3).sample(0)
    nodes, lens = b.nodes.numpy(), b.lengths.numpy()
    assert b.n_sets == 16
    for i in range(16):
        row = nodes[i, :lens[i]]
        assert len(set(row.tolist())) == len(row)
        assert set((row // N).tolist()) == {0, 1, 2}
    # a solver switches to the mrim engine for a t_rounds problem and back
    solver = IMMSolver(g, batch=16, device=CPU)
    solver.solve(IMProblem(k=1, t_rounds=2, theta=64))
    assert solver.engine_name == "mrim" and solver.store.n_nodes == 2 * N
    solver.solve(IMProblem(k=1, theta=64))
    assert solver.engine_name == "queue" and solver.store.n_nodes == N
