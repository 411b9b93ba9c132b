#!/usr/bin/env python3
"""Time the fused greedy (``csrc/greedy.cu``'s ``greedy_flat``) against its
earlier two-barrier design on one card, in turns.

    python3 examples/torch_greedy_variants.py [--iters 20] [--turns 2]

The pools are the exact cell's final pools: the default-options solves
``IMMSolver(g, engine="queue", batch=512, seed=0).solve(IMProblem(50,
eps))`` at ε = 0.5 and 0.25 on the stand-in (``barabasi_albert(75879, 4,
seed=0)``, WC weights).  On each pool, k = 50:

* ``kernel``: ``ops.greedy_flat``, one launch that builds the pool's index
  itself and runs k + 3 grid barriers;
* ``two barriers + index``: the earlier call, the pool's index built by
  torch operations (``ref.flat_index``: a sort, two searches, a gather)
  and ``two_barrier_flat`` of ``examples/greedy_variants.cu`` (2k grid
  barriers, Occur in global memory);
* ``two barriers``: that launch alone, on an index built beforehand;
* ``barriers k+3`` and ``barriers 2k``: the same grid running those grid
  barriers and nothing else;
* ``selection``: ``store.select(50, method="flat")`` (the kernel and
  ``_frac``);
* ``stamped``: the kernel built with clock stamps of its phases in every
  block (``examples/greedy_variants.cu``), which also prints its
  breakdown in SM clocks: block 0's prologue, covers, argmaxes and
  barriers, and each step's slowest block.

Every call must give the plain version's seeds and gains
(``ref.greedy_flat_ref`` on the card).  It prints the variant's ptxas
report; each call's CUDA-event milliseconds of every turn (the calls in
order, then back); for ``kernel`` and ``two barriers + index``, in turns
(kernel, earlier, earlier, kernel), the device time of each one's own
kernel and of its other device operations (torch.profiler) and the host's
enqueue time a call; and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

K = 50
EPS = (0.5, 0.25)
# each call's own kernel as torch.profiler names it
OWN_KERNEL = {"kernel": r"greedy_flat_kernel",
              "two barriers + index": r"two_barrier_flat_kernel"}


def build():
    """(library, ptxas report) of ``examples/greedy_variants.cu``."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libgreedy_variants.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib),
                           str(ROOT / "examples" / "greedy_variants.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def calls_on(store, lib):
    """name -> call returning ``(seeds, gains)`` (None for the barriers
    alone) on one pool, and the pool and greedy_flat's keywords."""
    import torch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import greedy as tgreedy
    t, n, k = store.n_elems, store.n_nodes, K
    num_rows = store.row_capacity()
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    kw = dict(n=n, num_rows=num_rows, k=k)
    dev = store.flat.device
    two = ctypes.CDLL(str(lib)).two_barrier_flat
    vp, i32, i64, cint = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                          ctypes.c_int)
    two.argtypes = [vp, vp, vp, vp, i32, i64, i32, vp, vp, cint, vp]
    two.restype = cint
    scratch = torch.empty(8 * k + 4 * n + num_rows, dtype=torch.uint8,
                          device=dev)
    out = torch.empty(2, k, dtype=torch.int32, device=dev)

    def launch(idx):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on(two(*(x.data_ptr() for x in idx), n, num_rows, k,
                            scratch.data_ptr(), out.data_ptr(), dev.index,
                            stream), "two_barrier_flat")
        return out[0], out[1]

    built = ref.flat_index(*pool, n=n, num_rows=num_rows)
    stamped = ctypes.CDLL(str(lib)).greedy_flat
    stamped.argtypes = tgreedy._GREEDY.argtypes
    stamped.restype = cint
    blocks, shared_bytes = tgreedy.flat_grid(dev)
    size = tgreedy.flat_scratch_bytes(n, num_rows, t, k, blocks,
                                      shared_bytes)
    stamped_scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    stamped_out = torch.empty(2, k, dtype=torch.int32, device=dev)

    def run_stamped():
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on(stamped(*(x.data_ptr() for x in pool), t, n,
                                num_rows, k, stamped_scratch.data_ptr(),
                                size, stamped_out.data_ptr(), dev.index,
                                stream), "stamped greedy_flat")
        return stamped_out[0], stamped_out[1]

    def select():
        res = store.select(k, method="flat")
        return res.seeds, res.gains

    calls = {
        "kernel": lambda: ops.greedy_flat(*pool, **kw),
        "two barriers + index": lambda: launch(
            ref.flat_index(*pool, n=n, num_rows=num_rows)),
        "two barriers": lambda: launch(built),
        "barriers k+3": lambda: tgreedy.grid_barriers(k + 3, dev),
        "barriers 2k": lambda: tgreedy.grid_barriers(2 * k, dev),
        "selection": select,
        "stamped": run_stamped,
    }
    return calls, pool, kw


def stamp_breakdown(lib, k: int, blocks: int) -> dict:
    """The last stamped launch's phases in SM clocks: block 0's prologue
    (phases A-C, then D with step 0's argmax and record) and, over the k
    steps, the sums of block 0's exchanges (from its record to the step's
    seed), covers, and argmaxes with their records, and of each step's
    slowest block's cover and argmax (from the step's seed to its next
    record), with that block's cover each step and which block it was."""
    per = 5 + 3 * 256
    got = (ctypes.c_longlong * (per * blocks))()
    fn = ctypes.CDLL(str(lib)).greedy_flat_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    if fn(ctypes.addressof(got), blocks):
        raise RuntimeError("greedy_flat_stamps failed")
    st = [list(got[b * per:(b + 1) * per]) for b in range(blocks)]
    # step s: 4 + 3s record out, 5 + 3s seed known, 6 + 3s cover done
    walked = range(k - 1)
    cover = [[row[6 + 3 * s] - row[5 + 3 * s] for s in walked] for row in st]
    busy = [[row[7 + 3 * s] - row[5 + 3 * s] for s in walked] for row in st]
    slowest = [max(range(blocks), key=lambda b: busy[b][s]) for s in walked]
    st0 = st[0]
    return {"prologue": {ph: st0[i + 1] - st0[i]
                         for i, ph in enumerate("ABCD")},
            "exchange": sum(st0[5 + 3 * s] - st0[4 + 3 * s]
                            for s in range(k)),
            "cover": sum(cover[0]),
            "argmax": sum(st0[7 + 3 * s] - st0[6 + 3 * s] for s in walked),
            "total": st0[5 + 3 * (k - 1)] - st0[0],
            "slowest_busy": sum(busy[b][s] for s, b in zip(walked, slowest)),
            "slowest_cover_each": [cover[b][s]
                                   for s, b in zip(walked, slowest)],
            "slowest_block_each": slowest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_greedy_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem
    from repro_torch.graph import csr, generators, weights
    from repro_torch.kernels import greedy as tgreedy, ref
    lib, ptxas = build()
    print(ptxas, flush=True)
    dev = torch.device("cuda")
    src, dst = generators.barabasi_albert(75879, 4, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 75879, device=dev))
    calls, stores = {}, []
    for eps in EPS:
        solver = IMMSolver(g, engine="queue", batch=512, seed=0, device=dev)
        solver.solve(IMProblem(k=K, eps=eps))
        store = solver.store
        stores.append(store)                 # the calls read its pool
        these, pool, kw = calls_on(store, lib)
        want = ref.greedy_flat_ref(*pool, **kw)
        for name, call in these.items():
            got = call()
            torch.cuda.synchronize()
            if got is not None and not (torch.equal(got[0], want[0])
                                        and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} at eps {eps} != plain version")
            calls[f"{name} @eps{eps}"] = call
        for _ in range(3):                   # warm, then the last's stamps
            these["stamped"]()
        torch.cuda.synchronize()
        print(json.dumps({"stamps": eps, **stamp_breakdown(
            lib, K, tgreedy.grid_blocks(dev))}), flush=True)
        print(json.dumps({"eps": eps, "n_rr": store.n_rr,
                          "pool_elements": store.n_elems,
                          "num_rows": kw["num_rows"],
                          "gains_sum": int(want[1].sum())}), flush=True)
    order = list(calls) + list(calls)[::-1]
    ms = {key: [] for key in calls}
    for _ in range(args.turns):
        for key in order:
            ms[key].append(chip_smoke.cuda_ms(calls[key], args.iters))
    for key in calls:
        print(json.dumps({"variant": key, "ms": ms[key],
                          "min": min(ms[key]), "max": max(ms[key])}),
              flush=True)
    for eps in EPS:
        pair = [f"{name} @eps{eps}" for name in OWN_KERNEL]
        out = {key: [] for key in pair}
        for key in pair + pair[::-1]:
            name = key.split(" @")[0]
            dev_t = chip_smoke.device_ms(calls[key], args.iters,
                                         OWN_KERNEL[name])
            out[key].append({
                "device_ms": dev_t["device_ms"],
                "device_other_ms": dev_t["device_other_ms"],
                "device_ms_source": dev_t["device_ms_source"],
                "device_kernels": dev_t["device_kernels"],
                "enqueue_us": chip_smoke.enqueue_us(calls[key],
                                                    args.iters)})
        for key, turns in out.items():
            print(json.dumps({"variant": key, "turns": turns}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
