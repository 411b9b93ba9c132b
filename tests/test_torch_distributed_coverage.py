"""The port's host-list API and its legacy sharded selection.

``select_seeds_sharded`` on 8 gloo ranks (one ``torch.multiprocessing``
spawn for the file) must give the exact greedy of the union of the
shards' RR sets (``oracle.greedy_max_coverage``), as the reference's
``tests/test_distributed_coverage.py`` holds its own on 8 host devices,
and every rank the same seeds and gains.  On one process the host-list API
(``build_store``, ``IncrementalRRStore``, ``merge_stores``,
``occur_histogram``, ``select_seeds``, ``shard_stores``) is held against
the reference's functions array for array and seed for seed.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import coverage as cov
from repro_torch.core import oracle
from repro_torch.launch.mesh import make_sample_mesh

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

WORLD = 8
N, K = 64, 5


def _per_shard(seed: int = 0, rows: int = 40):
    """8 shards of ``rows`` RR sets of 1-8 distinct nodes each (the
    reference test's pools; with ``rows=None`` the shards hold 30-40)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(WORLD):
        count = rows if rows is not None else int(rng.integers(30, 41))
        out.append([rng.choice(N, size=int(rng.integers(1, 9)),
                               replace=False).tolist()
                    for _ in range(count)])
    return out


def _legacy_ranks(rank, size, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        mesh = make_sample_mesh(device="cpu")
        results = {}
        for name, per in (("uniform", _per_shard(0)),
                          ("ragged", _per_shard(1, rows=None))):
            shards = cov.shard_stores(per, N, device="cpu")
            before = mesh.collectives
            seeds, gains = cov.select_seeds_sharded(mesh, shards, K, N)
            results[name] = {"seeds": seeds.tolist(),
                             "gains": gains.tolist(),
                             "collectives": mesh.collectives - before}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("legacy")
    mp.spawn(_legacy_ranks, nprocs=WORLD,
             args=(WORLD, f"file://{tmp / 'rdzv'}", str(tmp)))
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("name,seed,rows", [("uniform", 0, 40),
                                            ("ragged", 1, None)])
def test_sharded_selection_matches_oracle(legacy, name, seed, rows):
    per = _per_shard(seed, rows)
    union = [rr for shard in per for rr in shard]
    want, frac = oracle.greedy_max_coverage(union, N, K)
    got = legacy[0][name]
    assert got["seeds"] == want
    assert sum(got["gains"]) == round(frac * len(union))
    assert all(res[name]["seeds"] == got["seeds"]
               and res[name]["gains"] == got["gains"] for res in legacy)
    # one all_reduce of the Occur, then one a seed
    assert got["collectives"] == K + 1


# ------------------------------------------------------- one process

def _ref():
    from repro.core import coverage as jcov
    return jcov


def _host(x):
    return np.asarray(x)


def _store_arrays(st):
    return [_host(a) for a in (st.rr_flat, st.rr_ids, st.valid)] + \
        [st.n_rr, st.n_nodes]


def _assert_same_store(got, want):
    for a, b in zip(_store_arrays(got), _store_arrays(want)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert (a == b).all()
        else:
            assert a == b


def _padded_batch(rng, rows=33, n=N):
    lens = rng.integers(0, 9, rows)
    w = max(int(lens.max()), 1)
    nodes = np.zeros((rows, w), np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    lens[0] += w                    # an overflowed lane: its length clamps
    return nodes, lens


@pytest.mark.parametrize("pad_to", [None, 400])
def test_build_store_matches_reference(pad_to):
    jcov = _ref()
    per = _per_shard(2)[0]
    _assert_same_store(cov.build_store(per, N, pad_to=pad_to, device="cpu"),
                       jcov.build_store(per, N, pad_to=pad_to))
    batch = _padded_batch(np.random.default_rng(3))
    _assert_same_store(cov.build_store(batch, N, device="cpu"),
                       jcov.build_store(batch, N))


def test_incremental_and_merge_match_reference():
    jcov = _ref()
    rng = np.random.default_rng(4)
    batches = [_padded_batch(rng, rows=r) for r in (5, 40, 17)]
    inc = cov.IncrementalRRStore(N, capacity=4, device="cpu")
    jinc = jcov.IncrementalRRStore(N, capacity=4)
    for b in batches:
        inc.append_batch(b)
        jinc.append_batch(b)
        _assert_same_store(inc.snapshot(), jinc.snapshot())
        assert inc.n_rr == jinc.n_rr
    assert inc.snapshot() is inc.snapshot()
    parts = [cov.build_store(p, N, pad_to=len(sum(p, [])) + 7, device="cpu")
             for p in _per_shard(5)[:3]]
    jparts = [jcov.build_store(p, N, pad_to=len(sum(p, [])) + 7)
              for p in _per_shard(5)[:3]]
    _assert_same_store(cov.merge_stores(parts), jcov.merge_stores(jparts))


@pytest.mark.parametrize("seed", [0, 6])
def test_select_seeds_and_occur_match_reference(seed):
    jcov = _ref()
    per = _per_shard(seed)[1] + _per_shard(seed)[2]
    st = cov.build_store(per, N, pad_to=500, device="cpu")
    jst = jcov.build_store(per, N, pad_to=500)
    assert (_host(cov.occur_histogram(st))
            == _host(jcov.occur_histogram(jst))).all()
    got, want = cov.select_seeds(st, K), jcov.select_seeds(jst, K)
    assert got.seeds.tolist() == _host(want.seeds).tolist()
    assert got.gains.tolist() == _host(want.gains).tolist()
    assert got.frac.numpy().tobytes() == \
        _host(want.frac).astype(np.float32).tobytes()


def test_shard_stores_match_reference():
    jcov = _ref()
    per = _per_shard(1, rows=None)
    _assert_same_store(cov.shard_stores(per, N, device="cpu"),
                       jcov.shard_stores(per, N))


def test_select_seeds_sharded_wants_a_shard_a_rank():
    class OneRank:
        size, rank = 1, 0
    with pytest.raises(ValueError, match="8 shards for a mesh of 1"):
        cov.select_seeds_sharded(
            OneRank(), cov.shard_stores(_per_shard(0), N, device="cpu"), K, N)
