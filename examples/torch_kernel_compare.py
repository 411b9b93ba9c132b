#!/usr/bin/env python3
"""Time the port's bit-set, trial, sketch and queue kernels of two checkouts
on one card, in turns.

    python3 examples/torch_kernel_compare.py OTHER_ROOT [--iters 20]
    python3 examples/torch_kernel_compare.py --chunks [--iters 20]

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each checkout builds its own ``csrc/occur.cu``,
``csrc/bitops.cu``, ``csrc/bernoulli.cu``, ``csrc/sketch.cu`` and
``csrc/queue.cu`` and is run in its own process, in the order other,
this, this, other, so that a drift of the card's clocks shows as a
difference between the two runs of one tree.  Each run calls the entry
points of ``repro_torch.kernels.ops`` on the same inputs (made on the card
from a fixed seed):

* ``bernoulli_edges`` at 512 seeds x 607,012 uniform weights (the dense
  solve's shape);
* ``sketch_union_popcount`` on (75880, 4) random words (the approximate
  solve's sketch) and on (75880, 512);
* ``bitset_or`` and ``bitset_andnot`` on (512, 2372) random words (the
  packed sampler's shape), beside ``torch.bitwise_or`` on the same words;
* ``occur_from_bitset`` and ``occur_from_bitset_masked`` (bool mask) on
  (131072, 2372) random words with a half mask, and on a (16384, 2372)
  matrix of the exact path's density (4 nodes a row of the 75,904-node
  stand-in) with a mask of 2,469 rows;
* ``queue_bfs`` at the exact path's first round on the stand-in
  (``barabasi_albert(75879, 4, seed=0)``, WC weights, reverse,
  coalesced; 512 lanes, ``round_seed(0, 0)``, qcap = n, EC 128), called
  as that checkout's ``ops.queue_bfs`` takes it (a checkout whose kernel
  takes row seeds and roots gets them drawn beforehand, outside the
  timed call), and the whole round, ``rrset.sample_rrsets_queue``
  (draws, launch and the host read).  Both checkouts must give the same
  bytes (the ``digest`` of queue rows, lengths, overflow flags and steps).

For each it prints, in one JSON line, ``ms`` (CUDA events over ``--iters``
back-to-back calls after one warm-up), ``device_ms`` (the device time a
call from torch.profiler, all device work of the call) and ``enqueue_us``
(host clock per call with no sync inside).  The last lines are the card's
name and power limit and a JSON summary.

With ``--chunks`` it times only this checkout's Occur kernels on the same
two inputs at several chunk sizes (rows a thread walks), through their C
entry points, and prints the device time a call (the output's memset and
the kernel) for each: the measurement behind
``kernels/bitset.py::rows_per_chunk``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _inputs(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(16)

    def words(rows, cols):
        return torch.randint(-(1 << 31), 1 << 31, (rows, cols), device=dev,
                             dtype=torch.int64, generator=gen).to(torch.int32)

    def sparse(rows, cols, per_row):
        # per_row distinct nodes a row: distinct bits, so a sum is an OR
        r = torch.arange(rows, device=dev).repeat_interleave(per_row)
        node = torch.randint(0, cols * 32, (r.numel(),), device=dev,
                             generator=gen)
        key = torch.unique(r * (cols * 32) + node)
        acc = torch.zeros(rows * cols, dtype=torch.int64, device=dev)
        acc.index_add_(0, key >> 5, torch.ones_like(key) << (key & 31))
        acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
        return acc.to(torch.int32).view(rows, cols)

    a, b = words(512, 2372), words(512, 2372)
    sk4, sk512 = words(75880, 4), words(75880, 512)
    cov4, cov512 = words(1, 4)[0], words(1, 512)[0]
    weights = torch.rand(607012, device=dev, generator=gen)
    seeds = torch.arange(512, device=dev, dtype=torch.int64) * 0x9E3779B1
    big = words(131072, 2372)
    big_mask = torch.rand(131072, device=dev, generator=gen) < 0.5
    path = sparse(16384, 2372, 4)
    path_mask = torch.zeros(16384, dtype=torch.bool, device=dev)
    path_mask[torch.randperm(16384, device=dev, generator=gen)[:2469]] = True
    return (a, b, big, big_mask, path, path_mask, sk4, sk512, cov4, cov512,
            weights, seeds)


def _device_ms(torch, fn, iters: int) -> float:
    """Device time a call from torch.profiler: the mean duration of each
    device operation that the calls run (each runs once a call), summed
    (robust to a trace that drops a few records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total / e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count) / 1e3


def chunk_sweep(iters: int) -> None:
    """Both Occur kernels of this checkout at chunk sizes 256 .. 4096."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import _build, bitset, ref
    dev = torch.device("cuda")
    _, _, big, big_mask, path, path_mask, *_ = _inputs(torch, dev)
    out = {}
    for name, words, mask in (("131072", big, big_mask),
                              ("16384", path, path_mask)):
        b, w = words.shape
        occur = torch.empty(w * 32, dtype=torch.int32, device=dev)
        want = (ref.occur_from_bitset_ref(words),
                ref.occur_from_bitset_masked_ref(words, mask))
        card = words.get_device()
        row = {"rows_per_chunk": bitset.rows_per_chunk(b, w)}
        for per in (256, 384, 512, 768, 1024, 2048, 4096):
            planes = bitset.occur_planes(per)
            calls = (
                lambda: bitset._OCCUR(words.data_ptr(), b, w, per, planes,
                                      occur.data_ptr(), card,
                                      _build.raw_stream(card)),
                lambda: bitset._OCCUR_MASKED(
                    words.data_ptr(), mask.data_ptr(), 1, b, w, per, planes,
                    occur.data_ptr(), card, _build.raw_stream(card)))
            for fn, expect in zip(calls, want):
                if fn() != 0 or not torch.equal(occur, expect):
                    raise AssertionError(f"Occur wrong at {per} rows a chunk")
            row[per] = [_device_ms(torch, fn, iters) for fn in calls]
        out[name] = row
    print(json.dumps({"device_ms [unmasked, masked] by rows a chunk": out}),
          flush=True)


def _queue_calls(torch, dev):
    """(kernel call, plain call, round call) of the queue sampler at the
    exact path's first round, in this checkout's signature."""
    import inspect
    from repro_torch.core import rrset
    from repro_torch.graph import csr, generators, weights
    from repro_torch.kernels import ops, ref
    src, dst = generators.barabasi_albert(75879, 4, seed=0)
    g_rev = csr.coalesce_ic(csr.reverse(weights.wc_weights(
        csr.from_edges(src, dst, 75879, device=dev))))
    seed32, n, lanes = rrset.round_seed(0, 0), g_rev.n_nodes, 512
    csr_args = (g_rev.offsets, g_rev.indices, g_rev.weights)
    if "seeds" in inspect.signature(ops.queue_bfs).parameters:
        row_seeds = rrset.row_seeds(seed32, lanes, dev)
        args = csr_args + (row_seeds, rrset.draw_roots(row_seeds, n))

        def plain():
            return ref.queue_bfs_ref(*args, qcap=n, ec=128)
    else:
        args = csr_args + (seed32, lanes)

        def plain():
            return ref.queue_round_ref(*args, qcap=n, ec=128)[:4]
    return (lambda: ops.queue_bfs(*args, qcap=n, ec=128)[:4], plain,
            lambda: rrset.sample_rrsets_queue(g_rev, lanes, seed32,
                                              dedup="none"))


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root: str, iters: int) -> None:
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    (a, b, big, big_mask, path, path_mask, sk4, sk512, cov4, cov512,
     weights, seeds) = _inputs(torch, dev)
    queue_kernel, queue_plain, queue_round = _queue_calls(torch, dev)
    calls = {
        "bernoulli_edges 512x607012": lambda: ops.bernoulli_edges(weights,
                                                                  seeds),
        "sketch_union_popcount 75880x4": lambda:
            ops.sketch_union_popcount(sk4, cov4),
        "sketch_union_popcount 75880x512": lambda:
            ops.sketch_union_popcount(sk512, cov512),
        "bitset_or": lambda: ops.bitset_or(a, b),
        "bitset_andnot": lambda: ops.bitset_andnot(a, b),
        "torch.bitwise_or": lambda: torch.bitwise_or(a, b),
        "occur_from_bitset 131072": lambda: ops.occur_from_bitset(big),
        "occur_from_bitset_masked 131072": lambda:
            ops.occur_from_bitset_masked(big, big_mask),
        "occur_from_bitset 16384": lambda: ops.occur_from_bitset(path),
        "occur_from_bitset_masked 16384": lambda:
            ops.occur_from_bitset_masked(path, path_mask),
        "queue_bfs 512 lanes": queue_kernel,
        "queue round 512 lanes": queue_round,
    }
    checks = {
        "bernoulli_edges 512x607012": ref.bernoulli_edges_ref(weights, seeds),
        "sketch_union_popcount 75880x4": ref.sketch_union_popcount_ref(sk4,
                                                                       cov4),
        "sketch_union_popcount 75880x512":
            ref.sketch_union_popcount_ref(sk512, cov512),
        "bitset_or": ref.bitset_or_ref(a, b),
        "bitset_andnot": ref.bitset_andnot_ref(a, b),
        "occur_from_bitset 131072": ref.occur_from_bitset_ref(big),
        "occur_from_bitset_masked 131072":
            ref.occur_from_bitset_masked_ref(big, big_mask),
        "occur_from_bitset 16384": ref.occur_from_bitset_ref(path),
        "occur_from_bitset_masked 16384":
            ref.occur_from_bitset_masked_ref(path, path_mask),
        "queue_bfs 512 lanes": queue_plain(),
    }
    out = []
    for name, fn in calls.items():
        got, want = fn(), checks.get(name)
        if isinstance(want, tuple):
            same = all(torch.equal(x, y) for x, y in zip(got, want))
        else:
            same = want is None or torch.equal(got, want)
        if not same:
            raise AssertionError(f"{root}: {name} != plain version")
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        dev_ms = _device_ms(torch, fn, iters)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out.append({"call": name, "ms": ms,
                    "device_ms": dev_ms if dev_ms else "not measured",
                    "enqueue_us": host / iters * 1e6})
        if isinstance(want, tuple):
            out[-1]["digest"] = _digest(got)
    print(json.dumps({"root": root, "runs": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--chunks", action="store_true",
                    help="sweep this checkout's Occur chunk sizes instead")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.iters)
        return 0
    if args.other is None and not args.chunks:
        ap.error("give the other checkout's root, or --chunks")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi
    if args.chunks:
        chunk_sweep(args.iters)
        print(nvidia_smi(), flush=True)
        return 0
    other = str(Path(args.other).resolve())
    runs: dict[str, list] = {other: [], str(ROOT): []}
    for root in (other, str(ROOT), str(ROOT), other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root, "--iters",
             str(args.iters)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[root].append(rec["runs"])
    print(nvidia_smi(), flush=True)
    summary = {}
    for i, r in enumerate(runs[other][0]):
        summary[r["call"]] = {
            key: [run[i][key] for run in (runs[other][0], runs[str(ROOT)][0],
                                          runs[str(ROOT)][1],
                                          runs[other][1])]
            for key in ("ms", "device_ms", "enqueue_us")}
    print(json.dumps({"order": "other, this, this, other", "other": other,
                      "calls": summary}), flush=True)
    digests = {r.get("digest") for run in runs.values() for rr in run
               for r in rr if "digest" in r}
    if len(digests) > 1:
        print(f"the two checkouts' queue rounds differ: {digests}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
