"""Host-side graph generators (numpy).  The same edges as
``repro.graph.generators`` for the same arguments and seed.

* :func:`barabasi_albert` — the paper's §4.6 scalability workload.
* :func:`erdos_renyi` — fixed edge-count G(n, m).
"""
from __future__ import annotations

import numpy as np


def barabasi_albert(n: int, r: int, seed: int = 0):
    """Undirected BA preferential-attachment graph -> directed both ways.

    Repeated-endpoints pool, so attachment is proportional to degree.  The
    pool is frozen per block of 65536 new nodes (the batched-BA
    approximation the reference uses).  Returns (src, dst) int64 with both
    edge directions.
    """
    if r < 1 or n <= r:
        raise ValueError("need n > r >= 1")
    rng = np.random.default_rng(seed)
    r0 = r + 1                                   # initial clique
    init_src, init_dst = np.triu_indices(r0, k=1)
    srcs = [init_src.astype(np.int64)]
    dsts = [init_dst.astype(np.int64)]
    pool_list = [np.concatenate([init_src, init_dst]).astype(np.int64)]
    for start in range(r0, n, 65536):
        stop = min(start + 65536, n)
        block = np.arange(start, stop, dtype=np.int64)
        pool = np.concatenate(pool_list)
        blk_src = np.repeat(block, r)
        picks = rng.integers(0, pool.shape[0], size=blk_src.shape[0])
        blk_dst = pool[picks]
        srcs.append(blk_src)
        dsts.append(blk_dst)
        pool_list.append(np.concatenate([blk_src, blk_dst]))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    keep = src != dst                            # drop self loops
    src, dst = src[keep], dst[keep]
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def erdos_renyi(n: int, m: int, seed: int = 0, directed: bool = True):
    """G(n, m): m directed edges sampled uniformly (self-loops removed)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=int(m * 1.1) + 8)
    dst = rng.integers(0, n, size=src.shape[0])
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    if not directed:
        return np.concatenate([src, dst]), np.concatenate([dst, src])
    return src.astype(np.int64), dst.astype(np.int64)
