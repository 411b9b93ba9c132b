"""The fused greedy max-coverage of the flat pool (``kernels/greedy.py``,
``csrc/greedy.cu``) on the CPU, against the JAX reference.

Both stores receive the same batches (the reference's RRBatches, or random
ones, carried over as numpy).  ``ref.greedy_flat_ref``,
``ops.greedy_flat`` on CPU tensors and the port's ``flat`` selection must
equal the reference's fused scan (``select_seeds_device`` with
``method="flat"``, which runs ``fused``) in seeds, gains and the float32
bytes of ``frac``.  The kernel cannot run here, so its pieces are held
against numpy and the plain version: the index construction that the
wrapper runs on the card, the argmax by 64-bit keys as the kernel reduces
them (threads, warps, blocks, then an atomicMax), and a torch replay of the
kernel's steps (rows of the seed from the node-major index, one owner a
row, a flag a row, gains read off the keys).
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import coverage as jcov
from repro.core.engine import make_engine
from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.core import coverage as tcov
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import greedy as tgreedy

CPU = "cpu"
THREADS = tgreedy.THREADS


def _random_batch(rng, n, count, max_len=12):
    """Padded batch with empty rows and bit-31 ids (n > 32)."""
    lens = rng.integers(0, max_len, count)
    nodes = np.full((count, max(int(lens.max()), 1)), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    return nodes, lens


def _jax_batches(n=400, rounds=((64, 3), (160, 2), (32, 4))):
    """Batches sampled by the reference's queue engine, at a width that
    takes the plain append and one that takes the packed append."""
    src, dst = jgen.barabasi_albert(n, 3, seed=2)
    g_rev = jcsr.reverse(jw.wc_weights(jcsr.from_edges(src, dst, n)))
    out, key = [], jax.random.key(11)
    for batch, count in rounds:
        eng = make_engine("queue", g_rev, batch=batch)
        for _ in range(count):
            key, sub = jax.random.split(key)
            b = eng.sample(sub)
            out.append((np.asarray(b.nodes), np.asarray(b.lengths)))
    return out


def _pool(name):
    """(n, batches): ``jax`` the reference's sampled pool (n = 400, the
    buffers grow past 4,096); ``ragged`` random batches with empty rows
    that grow the buffers, n = 97; ``small`` one batch of 45 rows, n = 70
    (neither n nor the row count a multiple of 32)."""
    if name == "jax":
        return 400, _jax_batches()
    rng = np.random.default_rng(3)
    if name == "ragged":
        return 97, [_random_batch(rng, 97, int(rng.integers(1, 900)))
                    for _ in range(12)]
    return 70, [_random_batch(rng, 70, 45, max_len=9)]


@pytest.fixture(scope="module")
def stores():
    """name -> (reference store, port store on the CPU), built once."""
    out = {}
    for name in ("jax", "ragged", "small"):
        n, batches = _pool(name)
        jref = jcov.ShardedDeviceRRStore(n)
        port = tcov.DeviceRRStore(n, device=CPU)
        for nodes, lens in batches:
            jref.append_batch((nodes, lens))
            port.append_batch(convert.batch_from_arrays(
                nodes, lens, np.zeros(len(lens), bool), 0, device=CPU))
        out[name] = (jref, port)
    return out


def _pool_args(port):
    t = port.n_elems
    return (port.flat[:t], port.ids[:t], port.valid[:t]), dict(
        n=port.n_nodes, num_rows=port.row_capacity())


def _k(port, which):
    """k = 1, 50, or past the last positive gain (seeds repeat at 0)."""
    return {"1": 1, "50": 50, "past": port.n_nodes + 3}[which]


def test_pools_cover_the_cases(stores):
    jref, port = stores["jax"]
    assert port.capacity > 4096                              # grown
    _, port = stores["ragged"]
    assert port.capacity > 4096
    empties = sum(int((l == 0).sum()) for _, l in _pool("ragged")[1])
    assert empties > 0
    for name in ("ragged", "small"):
        _, port = stores[name]
        assert port.n_nodes % 32 and port.n_rr % 32, name


@pytest.mark.parametrize("which", ["1", "50", "past"])
@pytest.mark.parametrize("name", ["jax", "ragged", "small"])
def test_greedy_flat_equals_reference_fused(stores, name, which):
    jref, port = stores[name]
    k = _k(port, which)
    ws, wg, wf = (np.asarray(x) for x in
                  jcov.select_seeds_device(jref, k, method="flat"))
    args, kw = _pool_args(port)
    ops.reset_launch_counts()
    for seeds, gains in (ref.greedy_flat_ref(*args, **kw, k=k),
                         ops.greedy_flat(*args, **kw, k=k)):
        assert seeds.dtype == gains.dtype == torch.int32
        np.testing.assert_array_equal(seeds.numpy(), ws)
        np.testing.assert_array_equal(gains.numpy(), wg)
    got = port.select(k, method="flat")
    np.testing.assert_array_equal(got.seeds.numpy(), ws)
    np.testing.assert_array_equal(got.gains.numpy(), wg)
    assert got.frac.dtype == torch.float32
    assert got.frac.numpy().tobytes() == wf.tobytes()
    assert not any(ops.launch_counts().values())      # plain version on CPU
    if which == "past":                               # Occur ran out
        assert wg[-1] == 0 and ws[-1] == 0
        assert len(set(ws.tolist())) < k


def _numpy_index(flat, ids, valid, n, num_rows):
    flat, ids, valid = (x.numpy() for x in (flat, ids, valid))
    row_start = np.searchsorted(ids, np.arange(num_rows + 1), side="left")
    node = np.where(valid, flat, n)
    order = np.argsort(node, kind="stable")
    inv_start = np.searchsorted(node[order], np.arange(n + 1), side="left")
    return node, row_start, inv_start, ids[order]


def _with_invalid(port, seed=5):
    """The pool with about a tenth of its elements marked invalid."""
    (flat, ids, valid), kw = _pool_args(port)
    rng = np.random.default_rng(seed)
    drop = torch.from_numpy(rng.random(flat.shape[0]) < 0.1)
    return (flat, ids, valid & ~drop), kw


@pytest.mark.parametrize("invalid", [False, True], ids=["valid", "invalid"])
@pytest.mark.parametrize("name", ["jax", "ragged", "small"])
def test_flat_index_equals_numpy(stores, name, invalid):
    _, port = stores[name]
    args, kw = _with_invalid(port) if invalid else _pool_args(port)
    idx = tgreedy.flat_index(*args, **kw)
    want = _numpy_index(*args, kw["n"], kw["num_rows"])
    for got, w, what in zip(idx, want, tgreedy.FlatIndex._fields):
        assert got.dtype == torch.int32, what
        np.testing.assert_array_equal(got.numpy(), w, err_msg=what)
    flat, _, valid = args
    occur0 = torch.zeros(kw["n"] + 1, dtype=torch.int32).index_add_(
        0, flat.long(), valid.to(torch.int32))[:kw["n"]]
    assert torch.equal(idx.inv_start[1:] - idx.inv_start[:-1], occur0)
    assert int(idx.inv_start[-1]) == int(valid.sum())


def _redux_max_key(occ, low):
    """Two redux.sync maxima over the last axis (the largest occ, then the
    largest low among the entries that hold it) -> key."""
    best = occ.max(dim=-1).values
    first = torch.where(occ == best[..., None], low, 0).max(dim=-1).values
    return (best << 32) | first


def kernel_argmax(occur, blocks):
    """The kernel's argmax of ``occur`` on ``blocks`` blocks of THREADS:
    thread g folds v = g, g + G, ... (G the grid's threads) keeping the
    first maximum; warps and then blocks reduce (occ, low = 0xFFFFFFFF -
    v) pairs by two maxima; an atomicMax over the blocks' keys.  Returns
    (u, occur[u])."""
    n = occur.shape[0]
    gsize = blocks * THREADS
    slots = -(-n // gsize) * gsize
    occ = torch.zeros(slots, dtype=torch.int64)
    low = torch.zeros(slots, dtype=torch.int64)
    occ[:n] = occur.to(torch.int64)
    low[:n] = 0xFFFFFFFF - torch.arange(n, dtype=torch.int64)
    occ, low = occ.view(-1, gsize), low.view(-1, gsize)    # (pass, thread)
    t_occ, t_low = occ[0].clone(), low[0].clone()
    for p in range(1, occ.shape[0]):
        take = (low[p] != 0) & ((t_low == 0) | (occ[p] > t_occ))
        t_occ = torch.where(take, occ[p], t_occ)
        t_low = torch.where(take, low[p], t_low)
    warp = _redux_max_key(t_occ.view(blocks, THREADS // 32, 32),
                          t_low.view(blocks, THREADS // 32, 32))
    block = _redux_max_key(warp >> 32, warp & 0xFFFFFFFF)
    key = int(block.max())
    return 0xFFFFFFFF - (key & 0xFFFFFFFF), key >> 32


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("case", ["ties", "zeros", "last", "int32_max",
                                  "tiny"])
def test_key_argmax_is_torch_first_maximum(case, blocks):
    rng = np.random.default_rng(len(case) * 7 + blocks)
    n = {"tiny": 5}.get(case, 75_879 if blocks == 132 else 3_001)
    occur = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    if case == "zeros":
        occur.zero_()
    elif case == "last":
        occur[-1] = 7
    elif case == "int32_max":
        occur[rng.choice(n, 3, replace=False)] = 2 ** 31 - 1
    u, occ = kernel_argmax(occur, blocks)
    assert u == int(torch.argmax(occur)) and occ == int(occur[u])
    if case == "ties":
        assert int((occur == occur.max()).sum()) > 1
    if case == "last":
        assert u == n - 1
    if case == "zeros":
        assert u == 0 and occ == 0


def kernel_replay(flat, ids, valid, *, n, num_rows, k, blocks):
    """The kernel's steps in torch, from the wrapper's index: Occur from
    inv_start; each step's argmax by keys (:func:`kernel_argmax`), gains
    read off the key; u's rows from inv_rows, each owned by warp (i - a) %
    W of the grid's W warps and visited in the owners' order; an uncovered
    row sets its flag and takes one off Occur at each of its elements
    below n."""
    idx = tgreedy.flat_index(flat, ids, valid, n=n, num_rows=num_rows)
    occur = (idx.inv_start[1:] - idx.inv_start[:-1]).clone()
    covered = torch.zeros(num_rows, dtype=torch.bool)
    nwarps = blocks * THREADS // 32
    seeds, gains = [], []
    for _ in range(k):
        u, gain = kernel_argmax(occur, blocks)
        seeds.append(u)
        gains.append(gain)
        a, b = int(idx.inv_start[u]), int(idx.inv_start[u + 1])
        rows = idx.inv_rows[a:b].long()
        owner = torch.arange(b - a) % nwarps
        for r in rows[torch.argsort(owner, stable=True)].tolist():
            if covered[r]:
                continue
            covered[r] = True
            elems = idx.nodes[idx.row_start[r]:idx.row_start[r + 1]].long()
            elems = elems[elems < n]
            occur.index_add_(0, elems, torch.full_like(elems, -1,
                                                       dtype=torch.int32))
        assert int(occur.min()) >= 0
    return (torch.tensor(seeds, dtype=torch.int32),
            torch.tensor(gains, dtype=torch.int32))


@pytest.mark.parametrize("blocks", [1, 132])
@pytest.mark.parametrize("name,invalid", [("jax", False), ("ragged", False),
                                          ("small", False), ("ragged", True)])
def test_kernel_replay_equals_plain(stores, name, invalid, blocks):
    _, port = stores[name]
    args, kw = _with_invalid(port) if invalid else _pool_args(port)
    k = min(50, port.n_nodes + 3) if name != "small" else port.n_nodes + 3
    want = ref.greedy_flat_ref(*args, **kw, k=k)
    got = kernel_replay(*args, **kw, k=k, blocks=blocks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_greedy_wrapper_rejects_cpu_tensors_before_building():
    """The CUDA wrapper refuses a CPU pool before it builds anything."""
    flat = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tgreedy.greedy_flat(flat, flat, torch.ones(8, dtype=torch.bool),
                            n=4, num_rows=32, k=2)
    assert tgreedy._GREEDY._fn is None and "greedy" not in _build.PTXAS_REPORT
