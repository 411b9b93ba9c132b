"""The stacked selection on the port against the JAX reference, on the CPU.

* On one JAX-sampled pool fed to both stores, ``select_seeds_stacked``
  equals the reference's in seeds, gains and the float32 bytes of
  ``frac`` and ``spent`` (tolerance 0), for R = 1, 2, 3 and 5 requests
  that mix plain rows, candidates, budgets and group quotas, and for an
  MRIM geometry (three groups of n ids).
* ``ref.greedy_stacked_ref`` (the kernel's plain version) equals a loop of
  the solo plain versions, ``greedy_flat_ref`` and
  ``greedy_flat_variant_ref``, row by row.
* The refusals (a row-weighted store, no request) carry the reference's
  messages, and the CPU route launches no kernel.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import coverage as jcov
from repro.core.engine import make_engine as jmake_engine
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch.core import coverage as tcov
from repro_torch.kernels import ops, ref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
N = 220


@pytest.fixture(scope="module")
def stores():
    """The reference's and the port's stores on the same four batches of
    the reference's queue engine (64 rows each), and the same batches
    shifted into a 3n item space (row r's nodes in block r mod 3)."""
    src, dst = jgen.barabasi_albert(N, 3, seed=2)
    eng = jmake_engine("queue", jcsr.reverse(
        jw.wc_weights(jcsr.from_edges(src, dst, N))), batch=64)
    key = jax.random.key(5)
    out = {}
    for shift in (False, True):
        out[shift] = (jcov.ShardedDeviceRRStore(N * (3 if shift else 1)),
                      tcov.DeviceRRStore(N * (3 if shift else 1), device=CPU))
    for _ in range(4):
        key, sub = jax.random.split(key)
        b = eng.sample(sub)
        nodes, lens = np.asarray(b.nodes), np.asarray(b.lengths)
        for shift, (js, ps) in out.items():
            x = nodes + N * (np.arange(nodes.shape[0]) % 3)[:, None] \
                if shift else nodes
            x = np.where(nodes < N, x, N * (3 if shift else 1))
            js.append_batch((x, lens))
            ps.append_batch((x.copy(), lens))
    return out


_COSTS = (1 + np.arange(N) % 5).astype(np.float32)
_CAND = np.arange(N) % 3 == 0
# a request: (k_steps, plain, cand, costs, budget, quota)
_REQ = {
    "plain5": (5, True, None, None, None, 0),
    "plain12": (12, True, None, None, None, 0),
    "cand": (6, False, _CAND, None, None, 0),
    "budget": (9, False, None, _COSTS, 9.0, 0),
    "unit_budget": (4, False, None, None, 4.0, 0),
    "cand_budget": (7, False, _CAND, _COSTS, 8.0, 0),
    "exhausted": (4, False, np.isin(np.arange(N), [7, 9]), None, None, 0),
}
_MIXES = {
    "one_plain": ["plain12"],
    "one_variant": ["cand_budget"],
    "two": ["plain5", "cand"],
    "three": ["budget", "plain12", "exhausted"],
    "five": ["plain5", "cand", "budget", "unit_budget", "plain12"],
}


def _reqs(mod, mix):
    return [mod.StackedRequest(k_steps=k, plain=p, cand=c, costs=co,
                               budget=b, quota=q)
            for k, p, c, co, b, q in (_REQ[name] for name in mix)]


def _assert_stacked_equal(got, want):
    assert got.n_requests == want.n_requests
    for f in ("seeds", "gains", "frac", "spent"):
        x, y = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), (f, x, y)


@pytest.mark.parametrize("mix", sorted(_MIXES))
def test_select_seeds_stacked_equals_reference(stores, mix):
    js, ps = stores[False]
    want = jcov.select_seeds_stacked(js, _reqs(jcov, _MIXES[mix]))
    got = tcov.select_seeds_stacked(ps, _reqs(tcov, _MIXES[mix]))
    _assert_stacked_equal(got, want)
    assert got.seeds.shape[0] == 1 << (len(_MIXES[mix]) - 1).bit_length()


def test_select_seeds_stacked_mrim_geometry_equals_reference(stores):
    """Three groups of n ids (MRIM's T = 3 rounds), quotas 2 and 1 next to
    a plain row, over the shifted pool."""
    js, ps = stores[True]
    items = 3 * N

    def reqs(mod):
        return [mod.StackedRequest(k_steps=6, plain=False, quota=2),
                mod.StackedRequest(k_steps=3, plain=False, quota=1),
                mod.StackedRequest(k_steps=4)]

    want = jcov.select_seeds_stacked(js, reqs(jcov), n_group=N, n_groups=3)
    got = tcov.select_seeds_stacked(ps, reqs(tcov), n_group=N, n_groups=3)
    _assert_stacked_equal(got, want)
    s = got.seeds[0].numpy()
    live = s[s < items]
    assert np.bincount(live // N, minlength=3).max() <= 2


def test_stacked_rows_equal_their_solo_selections(stores):
    """Each row of the stacked selection is the store's solo ``flat``
    selection: ``select_seeds_device`` for a plain row, ``select_variant``
    for a variant row."""
    _, ps = stores[False]
    mix = _MIXES["five"]
    got = tcov.select_seeds_stacked(ps, _reqs(tcov, mix))
    for r, name in enumerate(mix):
        k, plain, cand, costs, budget, _ = _REQ[name]
        if plain:
            solo = tcov.select_seeds_device(ps, k, method="flat")
            spent = np.float32(0)
        else:
            solo = tcov.select_variant(ps, tcov.SelectionSpec(
                k_steps=k, n_group=N, group_quota=k, cand=cand, costs=costs,
                budget=budget))
            spent = solo.spent.numpy()
        assert torch.equal(got.seeds[r, :k], solo.seeds)
        assert torch.equal(got.gains[r, :k], solo.gains)
        assert got.frac[r].numpy().tobytes() == solo.frac.numpy().tobytes()
        assert got.spent[r].numpy().tobytes() == np.float32(spent).tobytes()


def _row_kw(n, rows, device=CPU):
    """greedy_stacked's operands for rows that cycle through plain k = 7,
    candidates, a budget, and three groups of quota 2."""
    v = np.arange(n)
    cols = dict(cand=np.ones((rows, n), bool),
                costs=np.ones((rows, n), np.float32),
                budget=np.full(rows, np.inf, np.float32),
                ks=np.zeros(rows, np.int32), quota=np.zeros(rows, np.int32),
                plain=np.ones(rows, bool), use_costs=np.zeros(rows, bool))
    for r in range(rows):
        kind = r % 4
        cols["ks"][r] = cols["quota"][r] = (7, 6, 9, 8)[kind]
        cols["plain"][r] = kind == 0
        if kind == 1:
            cols["cand"][r] = v % 3 == 0
        if kind == 2:
            cols["costs"][r] = 1 + v % 5
            cols["budget"][r] = 10.0
            cols["use_costs"][r] = True
        if kind == 3:
            cols["quota"][r] = 2
    return dict({k: torch.from_numpy(x).to(device) for k, x in cols.items()},
                n=n, k_max=16, n_group=-(-n // 3), n_groups=3)


@pytest.mark.parametrize("rows", [1, 3, 4])
def test_greedy_stacked_ref_equals_solo_plain_versions(stores, rows):
    _, ps = stores[False]
    t = ps.n_elems
    args = (ps.flat[:t], ps.ids[:t], ps.valid[:t])
    num_rows = ps.row_capacity()
    kw = _row_kw(N, rows)
    before = ops.launch_counts()
    seeds, gains, spent = ops.greedy_stacked(*args, num_rows=num_rows, **kw)
    assert ops.launch_counts() == before          # the CPU route
    assert seeds.shape == gains.shape == (rows, 16) and spent.shape == (rows,)
    for r in range(rows):
        k = int(kw["ks"][r])
        if bool(kw["plain"][r]):
            s, g = ref.greedy_flat_ref(*args, n=N, num_rows=num_rows, k=k)
            sp = torch.zeros((), dtype=torch.float32)
        else:
            s, g, sp = ref.greedy_flat_variant_ref(
                *args, n=N, num_rows=num_rows, k=k, cand=kw["cand"][r],
                costs=kw["costs"][r] if bool(kw["use_costs"][r]) else None,
                budget=float(kw["budget"][r]), n_group=kw["n_group"],
                n_groups=kw["n_groups"], group_quota=int(kw["quota"][r]))
        assert torch.equal(seeds[r, :k], s) and torch.equal(gains[r, :k], g)
        assert bool((seeds[r, k:] == N).all()) and not bool(gains[r, k:].any())
        assert spent[r].numpy().tobytes() == sp.numpy().tobytes()


def test_stacked_refusals_match_reference():
    for mod, store in ((jcov, jcov.ShardedDeviceRRStore(8, row_weighted=True)),
                       (tcov, tcov.DeviceRRStore(8, row_weighted=True,
                                                 device=CPU))):
        with pytest.raises(ValueError) as weighted:
            mod.select_seeds_stacked(store, [mod.StackedRequest(k_steps=1)])
        assert "does not support row-weighted stores" in str(weighted.value)
    plain_stores = (jcov.ShardedDeviceRRStore(8),
                    tcov.DeviceRRStore(8, device=CPU))
    msgs = []
    for mod, store in zip((jcov, tcov), plain_stores):
        with pytest.raises(ValueError) as empty:
            mod.select_seeds_stacked(store, [])
        msgs.append(str(empty.value))
    assert msgs[0] == msgs[1] == \
        "select_seeds_stacked needs at least one request"
