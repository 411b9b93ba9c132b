"""The queue sampler's round (``kernels/ops.py::queue_bfs``) against a numpy
emulation of its CUDA kernel and against live-edge reachability under the
JAX reference's hash.

``emulate_queue_bfs`` repeats ``csrc/queue.cu``'s warp algorithm in numpy:
one lane's BFS at a time, the dequeued node's row walked 32 edges a pass,
the trial as the kernel makes it (the counter hash on uint32, kept iff
``h < t(w)``, ``t`` from ``kernels/ref.py::trial_threshold_ref``), every
visited word of a pass read before any of the pass's writes, the accepted
edges ranked as ``__popc(ballot & lanemask_lt)`` ranks them, only the first
``qcap - tail`` taken (written and marked visited), ``overflowed`` set when
any accepted edge is not taken, and the lane's lock-step count ``sum
max(1, ceil(deg / ec))``.  On the CPU ``ops.queue_bfs`` runs the plain
version (``ref.queue_bfs_ref``, EC-wide micro-steps); the two must agree
byte for byte in ``queue``, ``lengths``, ``overflowed`` and ``steps``.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``).

The graphs: Barabasi-Albert with 40, 200 and 1,500 nodes and Erdos-Renyi
with 30, WC weights, and a 210-node graph with a planted hub (node 63,
id = 31 mod 32) whose reverse row spans five 32-edge passes, holds ids =
31 mod 32, weights 0 and 1 and ten nodes of reverse degree 0, and is
reached by most lanes; qcap 2, 5 and n (lanes overflow at the small ones);
EC 1, 32 and 128.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import counter_uniform_u32_ref
from repro_torch.core import rrset
from repro_torch.core.engine import QueueEngine
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ops, ref
from repro_torch.kernels import queue as tqueue

CPU = "cpu"
WARP = 32
GOLDEN = np.uint32(0x9E3779B9)
GRAPHS = ("ba40", "er30", "ba200", "ba1500", "hub")
QCAPS = (2, 5, None)            # None: qcap = n
ECS = (1, 32, 128)
HUB = 63


def _hub_graph():
    """210 nodes: BA(200, 2) at weight 0.1; 150 edges u -> HUB (HUB's
    reverse row; weights 0.45, three of them 1.0 and three 0.0), among them
    the ten nodes 200..209, which no edge enters (reverse rows of degree
    0); and 100 edges HUB -> x at weight 0.9, so that most RR sets reach
    the hub."""
    rng = np.random.default_rng(31)
    n = 210
    bs, bd = generators.barabasi_albert(200, 2, seed=4)
    others = np.setdiff1d(np.arange(200), [HUB])
    into = np.union1d(rng.choice(others, 135, replace=False),
                      [31, 95, 127, 159, 191])[:140]
    into = np.concatenate([into, np.arange(200, n)])
    out = rng.choice(others, 100, replace=False)
    w_in = np.full(into.size, 0.45)
    w_in[:3], w_in[-3:] = 1.0, 0.0
    src = np.concatenate([bs, into, np.full(out.size, HUB)])
    dst = np.concatenate([bd, np.full(into.size, HUB), out])
    w = np.concatenate([np.full(bs.size, 0.1), w_in, np.full(out.size, 0.9)])
    return csr.from_edges(src, dst, n, weights=w.astype(np.float32),
                          device=CPU)


@functools.cache
def graph(name):
    """The coalesced reverse CSR of a named graph, on the CPU."""
    if name == "hub":
        g = _hub_graph()
    else:
        n = int(name[2:])
        src, dst = (generators.erdos_renyi(n, 150, seed=2) if name == "er30"
                    else generators.barabasi_albert(n, 3 if n < 1000 else 4,
                                                    seed=n % 97))
        g = weights.wc_weights(csr.from_edges(src, dst, n, device=CPU))
    return csr.coalesce_ic(csr.reverse(g))


def batch_of(name):
    return 128 if name in ("ba1500", "hub") else 64


def round_inputs(name, seed32=0xC0FFEE):
    """(row seeds, roots) of one round, as the sampler draws them."""
    g = graph(name)
    seeds = rrset.row_seeds(seed32, batch_of(name), CPU)
    return seeds, rrset.draw_roots(seeds, g.n_nodes)


def _fmix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def hash_u32(seed, e):
    """The kernel's counter hash on uint32 arrays."""
    e = np.asarray(e, np.uint32)
    return _fmix32(_fmix32(e * GOLDEN + np.uint32(seed)) ^ GOLDEN)


@functools.cache
def emulate_queue_bfs(name, qcap, ec=None):
    """``csrc/queue.cu`` in numpy: (queue (B, qcap), lengths, overflowed,
    steps or None when ``ec`` is None, most accepted edges in one pass)."""
    g = graph(name)
    offs, idx, w = g.numpy()
    t = ref.trial_threshold_ref(torch.from_numpy(w)).numpy()
    n = g.n_nodes
    qcap = n if qcap is None else qcap
    seeds, roots = (x.numpy() for x in round_inputs(name))
    b = roots.size
    queue = np.zeros((b, qcap), np.int32)
    lengths = np.zeros(b, np.int32)
    over = np.zeros(b, bool)
    steps = np.zeros(b, np.int64)
    most = 0
    lanes = np.arange(WARP)
    for lane in range(b):
        vis = np.zeros((n + 31) // 32, np.uint32)
        q = queue[lane]
        q[0] = roots[lane]
        vis[roots[lane] >> 5] |= np.uint32(1) << np.uint32(roots[lane] & 31)
        head, tail = 0, 1
        while head < tail:
            u = q[head]
            start, deg = int(offs[u]), int(offs[u + 1] - offs[u])
            if ec is not None:
                steps[lane] += max(1, -(-deg // ec))
            for base in range(0, deg, WARP):
                i = base + lanes
                valid = i < deg
                e = start + np.where(valid, i, 0)
                v = idx[e]
                live = valid & (hash_u32(seeds[lane], e).astype(np.int64)
                                < t[e])
                seen = (vis[v >> 5] >> (v & 31).astype(np.uint32)) & 1
                accept = live & (seen == 0)       # reads before any write
                rank = np.cumsum(accept) - accept  # popc(ballot & lt)
                count = int(accept.sum())
                take = min(count, qcap - tail)
                taken = accept & (rank < take)
                q[tail + rank[taken]] = v[taken]
                for x in v[taken]:                 # atomicOr
                    vis[x >> 5] |= np.uint32(1) << np.uint32(x & 31)
                over[lane] |= count > take
                tail += take
                most = max(most, count)
            head += 1
        lengths[lane] = tail
    return queue, lengths, over, (steps if ec is not None else None), most


def _port_round(name, qcap, ec):
    g = graph(name)
    seeds, roots = round_inputs(name)
    return ops.queue_bfs(g.offsets, g.indices, g.weights, seeds, roots,
                         qcap=g.n_nodes if qcap is None else qcap, ec=ec)


@pytest.mark.parametrize("ec", ECS)
@pytest.mark.parametrize("qcap", QCAPS, ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("name", GRAPHS)
def test_emulated_kernel_equals_plain_round(name, qcap, ec):
    """Byte for byte: the queue rows (zeros after each length), lengths,
    overflow flags and per-lane steps."""
    want = emulate_queue_bfs(name, qcap, ec)
    got = _port_round(name, qcap, ec)
    for x, y, what in zip(got, want, ("queue", "lengths", "overflowed",
                                      "steps")):
        x = x.numpy()
        assert x.dtype == y.dtype, what
        assert x.tobytes() == y.tobytes(), what


@pytest.mark.parametrize("qcap", (2, 5))
@pytest.mark.parametrize("name", GRAPHS)
def test_overflow_keeps_the_unbounded_prefix(name, qcap):
    """Under overflow the kept queue is the first qcap nodes of the
    unbounded run, and a lane overflows iff its full RR set is longer."""
    full_q, full_len = emulate_queue_bfs(name, None)[:2]
    q, lens, over = emulate_queue_bfs(name, qcap)[:3]
    assert over.any() and (~over).any()
    np.testing.assert_array_equal(over, full_len > qcap)
    np.testing.assert_array_equal(lens, np.minimum(full_len, qcap))
    np.testing.assert_array_equal(q, full_q[:, :qcap])


def test_hub_graph_spans_passes_and_bit_31():
    """The planted hub's row takes five or more passes, a pass accepts
    several edges (ranks above 0), nodes with id = 31 mod 32 are visited,
    and nodes whose reverse row is empty are dequeued."""
    deg = np.diff(graph("hub").offsets.numpy())
    assert deg[HUB] > 4 * WARP
    q, lens, _, _, most = emulate_queue_bfs("hub", None)
    assert most >= 4
    sets = [q[i, :lens[i]] for i in range(lens.size)]
    assert sum(HUB in s for s in sets) > len(sets) // 2
    assert len({int(v) for s in sets for v in s if v % 32 == 31}) >= 4
    assert sum((deg[s] == 0).any() for s in sets) >= 4


def _live_reachable(offs, idx, w, row_seed, root):
    """Nodes reachable from ``root`` over the edges live for ``row_seed``
    under the reference's hash."""
    bits = np.asarray(counter_uniform_u32_ref(
        np.uint32(row_seed), jnp.arange(idx.size, dtype=jnp.uint32)))
    live = bits.astype(np.float32) * np.float32(2.0 ** -32) < w
    seen, stack = {int(root)}, [int(root)]
    while stack:
        u = stack.pop()
        for e in range(offs[u], offs[u + 1]):
            v = int(idx[e])
            if live[e] and v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


@pytest.mark.parametrize("qcap", QCAPS, ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("name", GRAPHS)
def test_lanes_are_live_edge_reachability(name, qcap):
    """Every lane that did not overflow holds exactly the nodes reachable
    from its root over the live edges of the reference's hash, root
    first, each once."""
    g = graph(name)
    offs, idx, w = g.numpy()
    seeds, roots = (x.numpy() for x in round_inputs(name))
    q, lens, over, _ = (x.numpy() for x in _port_round(name, qcap, 128))
    assert (~over).any()
    for b in np.flatnonzero(~over):
        row = q[b, :lens[b]].tolist()
        assert row[0] == roots[b] and len(set(row)) == len(row)
        assert set(row) == _live_reachable(offs, idx, w, seeds[b], roots[b])


@pytest.mark.parametrize("ec", ECS)
@pytest.mark.parametrize("name", GRAPHS)
def test_sample_trims_and_reports_lockstep_steps(name, ec):
    """``sample_rrsets_queue`` trims the rows to the longest set and
    reports the most steps of any lane, the count recomputed here from the
    degrees of the nodes each lane dequeued."""
    g = graph(name)
    s = rrset.sample_rrsets_queue(g, batch_of(name), 0xC0FFEE, ec=ec,
                                  dedup="none")
    q, lens = emulate_queue_bfs(name, None)[:2]
    assert s.nodes.shape == (lens.size, max(int(lens.max()), 1))
    np.testing.assert_array_equal(s.nodes.numpy(), q[:, :s.nodes.shape[1]])
    deg = np.diff(g.offsets.numpy())
    per_lane = [np.maximum(1, -(-deg[q[b, :lens[b]]] // ec)).sum()
                for b in range(lens.size)]
    assert s.steps == max(per_lane) == emulate_queue_bfs(name, None,
                                                         ec)[3].max()


def test_engine_round_goes_through_ops_and_keeps_stats():
    """``QueueEngine.sample`` returns the round ``ops.queue_bfs`` computed
    (trimmed), with ``steps`` the lanes' most."""
    g = graph("ba200")
    eng = QueueEngine(g, QueueEngine.Config(batch=64, qcap=5))
    b = eng.sample(0xC0FFEE)
    q, lens, over, steps = _port_round("ba200", 5, rrset.EC_DEFAULT)
    assert torch.equal(b.lengths, lens) and torch.equal(b.overflowed, over)
    assert torch.equal(b.nodes, q[:, :b.nodes.shape[1]])
    assert b.steps == int(steps.max())


def test_wrapper_rejects_cpu_tensors_before_building():
    g = graph("er30")
    seeds, roots = round_inputs("er30")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tqueue.queue_bfs(g.offsets, g.indices, g.weights, seeds, roots,
                         qcap=30, ec=128)
