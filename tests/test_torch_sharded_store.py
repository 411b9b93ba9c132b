"""The port's sharded pool against the reference's mesh-8 store.

The same four batches (seeded numpy: empty rows, 61 rows, which 8 does not
divide) go to the reference's ``ShardedDeviceRRStore`` on an 8-device host
mesh, in a subprocess with ``--xla_force_host_platform_device_count=8``
(device count is fixed at JAX's first use, as in the reference's own
``tests/test_sharded_store.py``), and to the port's
``ShardedDeviceRRStore`` on 8 gloo ranks, started once for the whole file
by ``torch.multiprocessing.spawn``.  Rank d's buffers, capacity and counts
must equal the reference's shard d element for element; its sketch words
(incremental at 32 and 256 buckets, and built on demand without one) the
reference's; its ``flat`` and ``select_seeds_celf`` selections the
reference's seeds, gains, ``frac`` and CELF counts; and its ``bitset``
selection the reference's ``fused`` one (the reference's own ``bitset``
raises under jax 0.9, ROADMAP Queue 3 [1]).  Each rank writes its checks
to a file; each check is a test.

On one process: the ``row0`` offset of the queue round (0 keeps the bytes;
rank d's block of a round equals rows ``[d·b, (d+1)·b)`` of the whole
round) and the plain versions of the new kernels against direct numpy
counts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.convert import shard_from_arrays, sketch_words_from_arrays
from repro_torch.core import coverage as cov
from repro_torch.core.roots import row_seeds
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bernoulli import counter_uniform_u32
from repro_torch.launch.mesh import make_sample_mesh

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
N, K = 50, 6
# (tag, sketch_k) of the three stores
STORES = (("k32", 32), ("k256", 256), ("none", None))
CHECKS = ("buffers", "capacity", "counts", "sketch", "flat", "celf",
          "bitset_equals_fused")

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import coverage as cov

src = np.load(sys.argv[1])
n, k = int(src["n"]), int(src["k"])
batches = [(src[f"nodes{i}"], src[f"lens{i}"]) for i in range(int(src["nb"]))]
assert len(jax.devices()) == 8
mesh8 = Mesh(np.asarray(jax.devices()), ("samples",))
out = {}
for tag, sketch_k in (("k32", 32), ("k256", 256), ("none", None)):
    st = cov.ShardedDeviceRRStore(n, capacity=64, sketch_k=sketch_k,
                                  mesh=mesh8)
    for b in batches:
        st.append_batch(b)
    for name, a in zip(("flat", "ids", "valid"), jax.device_get(
            (st._flat, st._ids, st._valid))):
        out[f"{tag}_{name}"] = np.asarray(a)
    out[f"{tag}_t"], out[f"{tag}_nrr"] = st._t_loc, st._nrr_loc
    out[f"{tag}_sketch"] = np.asarray(jax.device_get(st.sketch_words()))
    r = st.select(k, method="flat")
    so = {}
    c = cov.select_seeds_celf(st, k, stats_out=so)
    for name, res in (("fused", r), ("celf", c)):
        s, g, f = jax.device_get((res.seeds, res.gains, res.frac))
        out[f"{tag}_{name}_seeds"] = np.asarray(s)
        out[f"{tag}_{name}_gains"] = np.asarray(g)
        out[f"{tag}_{name}_frac"] = np.asarray(f)
    out[f"{tag}_celf_stats"] = np.asarray(
        [so["n_exact_evals"], so["n_eval_calls"]])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _batches():
    """The four batches: 61 rows of up to 7 distinct nodes, empty rows
    among them."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(4):
        lens = rng.integers(0, 8, 61)
        w = max(int(lens.max()), 1)
        nodes = np.zeros((61, w), np.int64)
        for i, ln in enumerate(lens):
            if ln:
                nodes[i, :ln] = rng.choice(N, size=ln, replace=False)
        out.append((nodes, lens))
    return out


def _same(res, want, tag, name) -> bool:
    return (res.seeds.tolist() == want[f"{tag}_{name}_seeds"].tolist()
            and res.gains.tolist() == want[f"{tag}_{name}_gains"].tolist()
            and res.frac.numpy().tobytes()
            == want[f"{tag}_{name}_frac"].astype(np.float32).tobytes())


def _store_ranks(rank, size, init, ref_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        mesh = make_sample_mesh(device="cpu")
        want = np.load(ref_path)
        results = {}
        for tag, sketch_k in STORES:
            st = cov.ShardedDeviceRRStore(N, capacity=64, sketch_k=sketch_k,
                                          mesh=mesh)
            for b in _batches():
                st.append_batch(b)
            flat, ids, valid = shard_from_arrays(
                want[f"{tag}_flat"], want[f"{tag}_ids"],
                want[f"{tag}_valid"], rank, device="cpu")
            results[f"{tag}:capacity"] = st.capacity == flat.shape[0]
            results[f"{tag}:buffers"] = bool(
                st.capacity == flat.shape[0] and torch.equal(st.flat, flat)
                and torch.equal(st.ids, ids) and torch.equal(st.valid, valid))
            results[f"{tag}:counts"] = bool(
                (st._t_loc == want[f"{tag}_t"]).all()
                and (st._nrr_loc == want[f"{tag}_nrr"]).all()
                and st._t == want[f"{tag}_t"][rank]
                and st._nrr == want[f"{tag}_nrr"][rank])
            results[f"{tag}:sketch"] = torch.equal(
                st.sketch_words(),
                sketch_words_from_arrays(want[f"{tag}_sketch"], device="cpu"))
            results[f"{tag}:flat"] = _same(st.select(K, method="flat"), want,
                                           tag, "fused")
            so = {}
            celf = cov.select_seeds_celf(st, K, stats_out=so)
            results[f"{tag}:celf"] = bool(
                _same(celf, want, tag, "celf")
                and [so["n_exact_evals"], so["n_eval_calls"]]
                == want[f"{tag}_celf_stats"].tolist())
            results[f"{tag}:bitset_equals_fused"] = _same(
                st.select(K, method="bitset"), want, tag, "fused")
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_store")
    data = {"n": N, "k": K, "nb": 4}
    for i, (nodes, lens) in enumerate(_batches()):
        data[f"nodes{i}"], data[f"lens{i}"] = nodes, lens
    np.savez(tmp / "batches.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "batches.npz"),
         str(tmp / "ref.npz")], env=env, capture_output=True, text=True,
        cwd=str(ROOT), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mp.spawn(_store_ranks, nprocs=WORLD,
             args=(WORLD, f"file://{tmp / 'rdzv'}", str(tmp / "ref.npz"),
                   str(tmp)))
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("tag", [t for t, _ in STORES])
def test_rank_matches_reference_shard(rank_results, tag, check):
    bad = [r for r, res in enumerate(rank_results)
           if not res[f"{tag}:{check}"]]
    assert not bad, f"ranks {bad} differ from the reference's mesh-8 store"


# ------------------------------------------------------- one process

@pytest.fixture(scope="module")
def g_rev():
    src, dst = generators.erdos_renyi(120, 600, seed=3)
    return csr.coalesce_ic(csr.reverse(weights.wc_weights(
        csr.from_edges(src, dst, 120, device="cpu"))))


def test_row0_zero_keeps_the_round_bytes(g_rev):
    seed32 = 0x9E3779B9
    lanes = torch.arange(48, dtype=torch.int64)
    assert torch.equal(row_seeds(seed32, 48, "cpu"),
                       counter_uniform_u32(seed32, lanes))
    assert torch.equal(row_seeds(seed32, 48, "cpu", row0=0),
                       row_seeds(seed32, 48, "cpu"))
    args = (g_rev.offsets, g_rev.indices, g_rev.weights, seed32, 48)
    for a, b in zip(ops.queue_bfs(*args, qcap=120, ec=8),
                    ops.queue_bfs(*args, qcap=120, ec=8, row0=0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ranks,b", [(2, 24), (8, 6), (3, 16)])
def test_row0_block_is_the_rounds_rows(g_rev, ranks, b):
    seed32 = 12345
    whole = ops.queue_bfs(g_rev.offsets, g_rev.indices, g_rev.weights,
                          seed32, ranks * b, qcap=120, ec=16)
    for d in range(ranks):
        block = ops.queue_bfs(g_rev.offsets, g_rev.indices, g_rev.weights,
                              seed32, b, qcap=120, ec=16, row0=d * b)
        for got, want in zip(block, whole):
            assert torch.equal(got, want[d * b:(d + 1) * b])
    assert torch.equal(row_seeds(seed32, b, "cpu", row0=(1 << 32) - 3),
                       counter_uniform_u32(
                           seed32, (torch.arange(b) + (1 << 32) - 3)
                           % (1 << 32)))


def _random_shard(rng, n, rows, valid_share=0.9):
    lists = [rng.choice(n, size=int(rng.integers(0, 9)), replace=False)
             for _ in range(rows)]
    st = cov.build_store([list(x) for x in lists], n, pad_to=None,
                         device="cpu")
    valid = st.valid & torch.from_numpy(rng.random(st.valid.shape[0])
                                        < valid_share)
    return lists, st.rr_flat, st.rr_ids, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occur_flat_plain_version_counts_valid_nodes(seed):
    rng = np.random.default_rng(seed)
    n = 70
    _, flat, _, valid = _random_shard(rng, n, 90)
    got = ops.occur_flat(flat, valid, n=n)
    want = np.bincount(flat.numpy()[valid.numpy()], minlength=n)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shard_flat_step_plain_version_against_numpy(seed):
    rng = np.random.default_rng(seed)
    n, rows = 64, 96
    lists, flat, ids, valid = _random_shard(rng, n, rows)
    cov_np = rng.random(rows) < 0.3
    cov_np[31] = True                       # bit 31 of the first word
    words = np.zeros(rows // 32, np.int64)
    for r in np.nonzero(cov_np)[0]:
        words[r >> 5] |= 1 << (r & 31)
    cov_words = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    f, i, v = flat.numpy(), ids.numpy(), valid.numpy()
    for u in (int(f[v][0]), int(rng.integers(0, n)), n - 1):
        has = np.zeros(rows, bool)
        has[i[v & (f == u)]] = True
        new = has & ~cov_np
        want = np.bincount(f[v & new[np.minimum(i, rows - 1)]
                             & (i < rows)], minlength=n + 1)[:n + 1].copy()
        want[n] = new.sum()
        cw = cov_words.clone()
        dec = ops.shard_flat_step(flat, ids, valid, cw,
                                  torch.tensor([u]), n=n)
        assert dec.dtype == torch.int32 and dec.tolist() == want.tolist()
        got_cov = np.unpackbits(cw.numpy().view(np.uint8),
                                bitorder="little").astype(bool)
        assert (got_cov == (cov_np | new)).all()
        cov_np, cov_words = cov_np | new, cw
