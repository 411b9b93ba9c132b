"""The queue sampler's round (``kernels/ops.py::queue_bfs``) against a numpy
replay of its CUDA kernel and against live-edge reachability under the
JAX reference's hash.

``emulate_queue_bfs`` repeats ``csrc/queue.cu``'s algorithm in numpy, one
lane (one block) at a time: the row seed and root drawn from the round
seed in uint32 (the root's product in uint64), as the kernel draws them;
then the BFS, each dequeued node's row cut into tiles of a given width
(the kernel's own is ``kernels/queue.py::SEGMENT_EDGES``), each tile one
compaction.  In a tile, the trial as the kernel makes it (the counter hash
on uint32, kept iff ``float32(h) * 2^-32 < w``), every visited read
before any of the tile's writes, and each accepted edge's rank from the kernel's
exclusive scans: the tile's 32-edge ballots spread over ``WARPS`` warps in
contiguous runs, the warps' counts, the ballots' counts inside a warp and
``__popc(ballot & lanemask_lt)``.  Only the first ``qcap - tail`` are taken
(written and marked visited), ``overflowed`` is set when any accepted
edge is not, and the lane's lock-step count is ``sum max(1, ceil(deg /
ec))``.  The replay also checks the kernel's premise: on simple rows, the
visited bits that a tile reads are those of the row's start.  On the CPU
``ops.queue_bfs`` runs the plain version (``ref.queue_round_ref``: torch's
row seeds and roots, then EC-wide micro-steps); the two must agree byte
for byte in ``queue``, ``lengths``, ``overflowed``, ``steps`` and
``roots``, at tile widths 32, 256 and the kernel's own.  The kernel itself
runs only on a card (``tests/test_torch_cuda.py``).

The graphs: Barabasi-Albert with 40, 200 and 1,500 nodes and Erdos-Renyi
with 30, WC weights; a 210-node graph with a planted hub (node 63, id =
31 mod 32) whose reverse row spans five 32-edge tiles, holds ids = 31 mod
32, weights 0 and 1 and ten nodes of reverse degree 0, and is reached by
most lanes; and a 33,200-node graph whose hub row of 33,040 edges spans
three of the kernel's tiles.  qcap 2, 5 and n (lanes overflow at the small
ones); EC 1, 32 and 128 (32 and 128 on the long row).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import counter_uniform_u32_ref
from repro_torch.core import roots as troots
from repro_torch.core import rrset
from repro_torch.core.engine import QueueEngine
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ops
from repro_torch.kernels import queue as tqueue

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
WARP = 32
GOLDEN = np.uint32(0x9E3779B9)
ROUND_SEED = 0xC0FFEE
GRAPHS = ("ba40", "er30", "ba200", "ba1500", "hub")
QCAPS = (2, 5, None)            # None: qcap = n
ECS = (1, 32, 128)
OWN_TILE = tqueue.SEGMENT_EDGES
TILES = (32, 256, OWN_TILE)
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


def _long_row_graph():
    """33,200 nodes: BA(200, 2) at weight 0.1; 40 BA nodes (ids = 31 mod
    32 among them) into HUB at 0.45 and the 33,000 leaves 200..33,199 into
    HUB at 0.01 (HUB's reverse row: 33,040 edges, three of the kernel's
    tiles, about 330 live a visit); HUB -> x at 0.9 for 100 BA nodes and
    the first 32,000 leaves, so that most RR sets reach the hub; the last
    1,000 leaves have reverse degree 0."""
    rng = np.random.default_rng(57)
    n = 33_200
    bs, bd = generators.barabasi_albert(200, 2, seed=4)
    leaves = np.arange(200, n)
    others = np.setdiff1d(np.arange(200), [HUB])
    into = np.union1d(rng.choice(others, 35, replace=False),
                      [31, 95, 127, 159, 191])
    out = np.concatenate([rng.choice(others, 100, replace=False),
                          leaves[:32_000]])
    src = np.concatenate([bs, into, leaves, np.full(out.size, HUB)])
    dst = np.concatenate([bd, np.full(into.size + leaves.size, HUB), out])
    w = np.concatenate([np.full(bs.size, 0.1), np.full(into.size, 0.45),
                        np.full(leaves.size, 0.01), np.full(out.size, 0.9)])
    return csr.from_edges(src, dst, n, weights=w.astype(np.float32),
                          device=CPU)


@functools.cache
def graph(name):
    """The coalesced reverse CSR of a named graph, on the CPU."""
    if name == "hub":
        g = _hub_graph()
    elif name == "longrow":
        g = _long_row_graph()
    else:
        n = int(name[2:])
        src, dst = (generators.erdos_renyi(n, 150, seed=2) if name == "er30"
                    else generators.barabasi_albert(n, 3 if n < 1000 else 4,
                                                    seed=n % 97))
        g = weights.wc_weights(csr.from_edges(src, dst, n, device=CPU))
    return csr.coalesce_ic(csr.reverse(g))


def batch_of(name):
    return 128 if name in ("ba1500", "hub") else 64


def _fmix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def hash_u32(seed, e):
    """The kernel's counter hash on uint32 arrays."""
    e = np.asarray(e, np.uint32)
    return _fmix32(_fmix32(e * GOLDEN + np.asarray(seed, np.uint32)) ^ GOLDEN)


def in_launch_draw(seed32, batch, n):
    """Block b's row seed and root as ``csrc/queue.cu`` draws them: uint32
    ``s = h(round_seed, b)``, root ``(uint64(h(s, 0xFFFFFFFF)) * n) >>
    32``."""
    seeds = hash_u32(np.uint32(seed32 & 0xFFFFFFFF), np.arange(batch))
    u = hash_u32(seeds, np.uint32(0xFFFFFFFF)).astype(np.uint64)
    return seeds, ((u * np.uint64(n)) >> np.uint64(32)).astype(np.int32)


def tile_ranks(accept):
    """Each edge's rank among a tile's accepted edges as the kernel scans
    it: 32-edge ballots, ``WARPS`` warps taking contiguous runs of
    ``ceil(ballots / WARPS)`` ballots, an exclusive scan of the warps'
    counts, one of the ballots' counts inside each warp, and
    ``__popc(ballot & lanemask_lt)``."""
    seg = accept.size
    ballots = -(-seg // WARP)
    per_warp = -(-ballots // tqueue.WARPS)
    flags = np.zeros(tqueue.WARPS * per_warp * WARP, np.int64)
    flags[:seg] = accept
    flags = flags.reshape(tqueue.WARPS, per_warp, WARP)
    lane_rank = np.cumsum(flags, axis=2) - flags          # popc(mask & lt)
    counts = flags.sum(axis=2)                            # a ballot's
    ballot_base = np.cumsum(counts, axis=1) - counts      # in its warp
    warp_counts = counts.sum(axis=1)
    warp_base = np.cumsum(warp_counts) - warp_counts
    rank = warp_base[:, None, None] + ballot_base[:, :, None] + lane_rank
    return rank.reshape(-1)[:seg]


def _bit(vis, v):
    return (vis[v >> 5] >> (v & 31).astype(np.uint32)) & 1


def lane_steps(name, queue, lengths, ec):
    """Each lane's lock-step count: the sum over the nodes it dequeued (its
    queue, also under overflow) of max(1, ceil(deg / ec))."""
    deg = np.diff(graph(name).offsets.numpy().astype(np.int64))
    return np.array([np.maximum(1, -(-deg[queue[b, :lengths[b]]] // ec)).sum()
                     for b in range(lengths.size)], np.int64)


@functools.cache
def emulate_queue_bfs(name, qcap, tile):
    """``csrc/queue.cu`` in numpy with rows ranked ``tile`` edges at a time:
    (queue (B, qcap), lengths, overflowed, roots, most accepted edges in
    one tile, most tiles in one walked row)."""
    g = graph(name)
    offs, idx, w = g.numpy()
    n = g.n_nodes
    qcap = n if qcap is None else qcap
    seeds, roots = in_launch_draw(ROUND_SEED, batch_of(name), n)
    b = roots.size
    queue = np.zeros((b, qcap), np.int32)
    lengths = np.zeros(b, np.int32)
    over = np.zeros(b, bool)
    most = most_tiles = 0
    for lane in range(b):
        vis = np.zeros((n + 31) // 32, np.uint32)
        q = queue[lane]
        q[0] = roots[lane]
        vis[roots[lane] >> 5] |= np.uint32(1) << np.uint32(roots[lane] & 31)
        head, tail = 0, 1
        while head < tail:
            u = q[head]
            head += 1
            start, deg = int(offs[u]), int(offs[u + 1] - offs[u])
            row_seen = _bit(vis, idx[start:start + deg])
            most_tiles = max(most_tiles, -(-deg // tile))
            for base in range(0, deg, tile):
                e = np.arange(start + base, start + min(deg, base + tile))
                v = idx[e]
                live = (hash_u32(seeds[lane], e).astype(np.float32)
                        * np.float32(2.0 ** -32)) < w[e]
                seen = _bit(vis, v)               # reads before any write
                assert np.array_equal(seen, row_seen[e - start])
                accept = live & (seen == 0)
                rank = tile_ranks(accept)
                count = int(accept.sum())
                take = min(count, qcap - tail)
                taken = accept & (rank < take)
                q[tail + rank[taken]] = v[taken]
                for x in v[taken]:                # atomicOr
                    vis[x >> 5] |= np.uint32(1) << np.uint32(x & 31)
                over[lane] |= count > take
                tail += take
                most = max(most, count)
        lengths[lane] = tail
    return queue, lengths, over, roots, most, most_tiles


@functools.cache
def _port_round(name, qcap, ec):
    g = graph(name)
    return ops.queue_bfs(g.offsets, g.indices, g.weights, ROUND_SEED,
                         batch_of(name),
                         qcap=g.n_nodes if qcap is None else qcap, ec=ec)


def _assert_round_equal(name, qcap, tile, ec):
    queue, lengths, over, roots = emulate_queue_bfs(name, qcap, tile)[:4]
    want = (queue, lengths, over, lane_steps(name, queue, lengths, ec), roots)
    got = _port_round(name, qcap, ec)
    for x, y, what in zip(got, want, ("queue", "lengths", "overflowed",
                                      "steps", "roots")):
        x = x.numpy()
        assert x.dtype == y.dtype, what
        assert x.tobytes() == y.tobytes(), what


@pytest.mark.parametrize("ec", ECS)
@pytest.mark.parametrize("qcap", QCAPS, ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("name", GRAPHS)
def test_emulated_kernel_equals_plain_round(name, qcap, ec):
    """Byte for byte, at the kernel's own tile: the queue rows (zeros after
    each length), lengths, overflow flags, per-lane steps and roots."""
    _assert_round_equal(name, qcap, OWN_TILE, ec)


@pytest.mark.parametrize("ec", ECS)
@pytest.mark.parametrize("qcap", QCAPS, ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("tile", TILES[:2], ids=["tile32", "tile256"])
def test_emulated_narrow_tiles_equal_plain_round(tile, name, qcap, ec):
    """The same at tiles of 32 and 256 edges: the tile width does not
    change the round."""
    _assert_round_equal(name, qcap, tile, ec)


@pytest.mark.parametrize("ec", (32, 128))
@pytest.mark.parametrize("qcap", QCAPS, ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("tile", TILES, ids=["tile32", "tile256", "own"])
def test_emulated_kernel_equals_plain_round_on_a_long_row(tile, qcap, ec):
    """The long-row graph, whose hub row spans several tiles at every
    width, byte for byte."""
    _assert_round_equal("longrow", qcap, tile, ec)


@pytest.mark.parametrize("qcap", (2, 5))
@pytest.mark.parametrize("name", GRAPHS)
def test_overflow_keeps_the_unbounded_prefix(name, qcap):
    """Under overflow the kept queue is the first qcap nodes of the
    unbounded run, and a lane overflows iff its full RR set is longer."""
    full_q, full_len = emulate_queue_bfs(name, None, OWN_TILE)[:2]
    q, lens, over = emulate_queue_bfs(name, qcap, OWN_TILE)[:3]
    assert over.any() and (~over).any()
    np.testing.assert_array_equal(over, full_len > qcap)
    np.testing.assert_array_equal(lens, np.minimum(full_len, qcap))
    np.testing.assert_array_equal(q, full_q[:, :qcap])


def test_hub_graph_spans_passes_and_bit_31():
    """At 32-edge tiles the planted hub's row takes five or more tiles, a
    tile accepts several edges (ranks above 0), nodes with id = 31 mod 32
    are visited, and nodes whose reverse row is empty are dequeued."""
    deg = np.diff(graph("hub").offsets.numpy())
    assert deg[HUB] > 4 * WARP
    q, lens, *_, most, most_tiles = emulate_queue_bfs("hub", None, WARP)
    assert most >= 4 and most_tiles >= 5
    sets = [q[i, :lens[i]] for i in range(lens.size)]
    assert sum(HUB in s for s in sets) > len(sets) // 2
    assert len({int(v) for s in sets for v in s if v % 32 == 31}) >= 4
    assert sum((deg[s] == 0).any() for s in sets) >= 4


@pytest.mark.parametrize("tile", TILES[1:], ids=["tile256", "own"])
def test_long_row_spans_tiles_and_bit_31(tile):
    """At 256 edges and at the kernel's own tile the long row spans three
    or more tiles, a tile accepts several edges, most lanes walk it, nodes
    with id = 31 mod 32 are visited and nodes with empty rows dequeued."""
    deg = np.diff(graph("longrow").offsets.numpy())
    assert deg[HUB] > 2 * OWN_TILE
    q, lens, *_, most, most_tiles = emulate_queue_bfs("longrow", None, tile)
    assert most >= 4 and most_tiles >= 3
    sets = [q[i, :lens[i]] for i in range(lens.size)]
    assert sum(HUB in s for s in sets) > len(sets) // 2
    assert len({int(v) for s in sets for v in s if v % 32 == 31}) >= 4
    assert sum((deg[s] == 0).any() for s in sets) >= 4


@pytest.mark.parametrize("seed32,n,batch", [
    (ROUND_SEED, 210, 128), (0xDEADBEEF, 75_879, 509),
    (0xFFFFFFFF, 1_000_003, 257), (0x80000000, 3, 1),
    (rrset.round_seed(0, 0), 75_879, 512)])
def test_in_launch_draw_equals_row_seeds_and_draw_roots(seed32, n, batch):
    """The kernel's draw, replayed in numpy uint32 with the root's product
    in uint64, equals ``row_seeds`` and ``draw_roots`` and the JAX
    package's hash; seeds with bit 31 set occur, n is not a power of two
    and the batch is not a multiple of a warp or of the block's warps."""
    seeds, roots = in_launch_draw(seed32, batch, n)
    t_seeds = troots.row_seeds(seed32, batch, CPU)
    assert t_seeds.numpy().astype(np.uint32).tobytes() == seeds.tobytes()
    assert troots.draw_roots(t_seeds, n).numpy().tobytes() == roots.tobytes()
    jax_seeds = np.asarray(counter_uniform_u32_ref(
        np.uint32(seed32), jnp.arange(batch, dtype=jnp.uint32)))
    np.testing.assert_array_equal(jax_seeds, seeds)
    assert roots.min() >= 0 and roots.max() < n
    if batch > 100:
        assert (seeds >= 1 << 31).any() and (seeds < 1 << 31).any()


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


def _assert_reachability(name, qcap):
    g = graph(name)
    offs, idx, w = g.numpy()
    seeds, _ = in_launch_draw(ROUND_SEED, batch_of(name), g.n_nodes)
    q, lens, over, _, roots = (x.numpy() for x in _port_round(name, qcap,
                                                              128))
    assert (~over).any()
    for b in np.flatnonzero(~over):
        row = q[b, :lens[b]].tolist()
        assert row[0] == roots[b] and len(set(row)) == len(row)
        assert set(row) == _live_reachable(offs, idx, w, seeds[b], roots[b])


@pytest.mark.parametrize("qcap", QCAPS, ids=["qcap2", "qcap5", "qcapn"])
@pytest.mark.parametrize("name", GRAPHS)
def test_lanes_are_live_edge_reachability(name, qcap):
    """Every lane that did not overflow holds exactly the nodes reachable
    from its root over the live edges of the reference's hash, root
    first, each once."""
    _assert_reachability(name, qcap)


def test_long_row_lanes_are_live_edge_reachability():
    _assert_reachability("longrow", None)


@pytest.mark.parametrize("ec", ECS)
@pytest.mark.parametrize("name", GRAPHS)
def test_sample_trims_and_reports_lockstep_steps(name, ec):
    """``sample_rrsets_queue`` trims the rows to the longest set and
    reports the most steps of any lane, the count recomputed here from the
    degrees of the nodes each lane dequeued."""
    g = graph(name)
    s = rrset.sample_rrsets_queue(g, batch_of(name), ROUND_SEED, ec=ec,
                                  dedup="none")
    q, lens = emulate_queue_bfs(name, None, OWN_TILE)[:2]
    assert s.nodes.shape == (lens.size, max(int(lens.max()), 1))
    np.testing.assert_array_equal(s.nodes.numpy(), q[:, :s.nodes.shape[1]])
    deg = np.diff(g.offsets.numpy())
    per_lane = [np.maximum(1, -(-deg[q[b, :lens[b]]] // ec)).sum()
                for b in range(lens.size)]
    assert s.steps == max(per_lane)


def test_engine_round_goes_through_ops_and_keeps_stats():
    """``QueueEngine.sample`` returns the round ``ops.queue_bfs`` computed
    (trimmed), with ``steps`` the lanes' most and the round's roots."""
    g = graph("ba200")
    eng = QueueEngine(g, QueueEngine.Config(batch=64, qcap=5))
    b = eng.sample(ROUND_SEED)
    q, lens, over, steps, roots = _port_round("ba200", 5, rrset.EC_DEFAULT)
    assert torch.equal(b.lengths, lens) and torch.equal(b.overflowed, over)
    assert torch.equal(b.nodes, q[:, :b.nodes.shape[1]])
    assert torch.equal(b.roots, roots)
    assert b.steps == int(steps.max())


def test_wrapper_rejects_cpu_tensors_before_building():
    g = graph("er30")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tqueue.queue_bfs(g.offsets, g.indices, g.weights, ROUND_SEED, 64,
                         qcap=30, ec=128)


def test_visited_bits_go_to_shared_memory_while_they_fit():
    """The size rule: ceil(n / 32) words of 4 bytes in the 230,400 bytes
    left of a block's 232,448 (n up to 1,843,200), else global scratch."""
    assert tqueue.MAX_SHARED_VISITED_BYTES == 230_400
    assert tqueue.visited_in_shared(1) and tqueue.visited_in_shared(75_879)
    assert tqueue.visited_in_shared(1_843_200)
    assert not tqueue.visited_in_shared(1_843_201)
    assert not tqueue.visited_in_shared(1_900_000)
