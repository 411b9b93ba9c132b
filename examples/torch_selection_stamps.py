#!/usr/bin/env python3
"""Where the time of the two selection kernels goes: SM clock stamps of
``greedy_sketch``'s and ``celf_select``'s phases, at the cells' shapes.

    python3 examples/torch_selection_stamps.py [--reps 3]

The stamped copies are the port's own sources built with the stamps on
(``examples/sketch_stamps.cu`` includes ``csrc/greedy.cu``,
``examples/celf_stamps.cu`` includes ``csrc/celf.cu``, both with
``examples/phase_clock.cuh``).  A stamped launch goes through the port's
own wrapper, whose bound entry point is swapped for the stamped library's
for the call, so the arguments, scratch and layout are the wrapper's.

Shapes (the stand-in ``barabasi_albert(75879, 4, seed=0)``, WC weights,
queue engine, 512 lanes, seed 0, k = 50, eps = 0.5):

* ``celf_select`` on the CELF cell's pool (8,704 RR sets, 35,538
  elements) and its sketch at 1,024 and 16,384 buckets, c = 32;
* ``greedy_sketch`` on the approximate cell's sketch (``max_theta`` 8,192:
  75,880 x 4 words) and on the exact pool folded at sketch_k 1,024, 4,096
  and 16,384 (W = 32, 128 and 512, chip_smoke's phase 8).

Each launch must equal the port's unstamped one (and so the plain
version, which chip_smoke and the card tests hold it to).  Each shape
prints one JSON line: each phase's SM clocks summed over the launch in
block 0, their mean and largest over the blocks, the blocks' totals, the
stamped and the unstamped launch's CUDA-event milliseconds, and the clock
rate that block 0's total over the stamped time gives.  The last line is
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

K, EPS, BATCH, N_NODES, BA_R = 50, 0.5, 512, 75879, 4
CELF_SKETCH_K = (1024, 16384)
PROBE_SKETCH_K = (1024, 4096, 16384)
APPROX_MAX_THETA = 8192
SLOTS = 16                         # examples/phase_clock.cuh: kClockSlots
# the phases of csrc/greedy.cu's SketchPhase and csrc/celf.cu's SelectPhase
SKETCH_PHASES = ("prologue", "sweep", "argmax", "barrier", "key",
                 "seed_row")
CELF_PHASES = ("prologue", "delta_sweep", "lazy_sweep", "top_c_chunks",
               "top_c", "records", "list_load", "list_keep", "merge",
               "digits", "ties", "pick", "evaluation", "commit", "barriers")


def build_one(name: str) -> Path:
    """``examples/<name>.cu`` built with the port's flags into the build
    directory unless a library of the same sources and flags is there (the
    tag hashes the stamped file, the port's source it includes, the
    headers of ``examples/`` and ``csrc/`` and the flags, as
    ``_build.build`` does); its path."""
    from repro_torch.kernels import _build
    src = ROOT / "examples" / f"{name}.cu"
    text = src.read_bytes()
    included = re.findall(rb'#include "(\w+\.cu)"', text)
    parts = [text, *((_build.CSRC / inc.decode()).read_bytes()
                     for inc in included),
             *(h.read_bytes() for h in sorted((ROOT / "examples").glob(
                 "*.cuh"))),
             *(h.read_bytes() for h in sorted(_build.CSRC.glob("*.cuh"))),
             " ".join(_build.NVCC_FLAGS).encode()]
    tag = hashlib.sha256(b"".join(parts)).hexdigest()[:16]
    out = _build.BUILD_DIR / "stamps"
    lib = out / f"lib{name}_{tag}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
    os.close(fd)
    try:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                               f"-I{_build.CSRC}", f"-I{ROOT / 'examples'}",
                               "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build() -> dict:
    """{"sketch": library, "celf": library}, built together."""
    names = {"sketch": "sketch_stamps", "celf": "celf_stamps"}
    with ThreadPoolExecutor(2) as pool:
        libs = dict(zip(names, pool.map(build_one, names.values())))
    return {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}


@contextlib.contextmanager
def stamped(kernel, lib):
    """The port's bound entry point ``kernel`` (a ``_build.Kernel``) swapped
    for the same symbol of the stamped library ``lib`` while inside."""
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    kept = kernel._fn
    kernel._fn = fn
    try:
        yield
    finally:
        kernel._fn = kept


def clocks(lib, blocks: int, phases) -> dict:
    """The last stamped launch's clocks: each phase's block-0 sum, mean and
    largest over the blocks, and the blocks' totals."""
    got = (ctypes.c_longlong * ((SLOTS + 1) * blocks))()
    fn = lib.phase_clocks_copy
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    if fn(ctypes.addressof(got), blocks):
        raise RuntimeError("phase_clocks_copy failed")
    rows = [list(got[b * (SLOTS + 1):(b + 1) * (SLOTS + 1)])
            for b in range(blocks)]
    out = {name: {"block0": rows[0][i],
                  "mean": sum(r[i] for r in rows) / blocks,
                  "max": max(r[i] for r in rows)}
           for i, name in enumerate(phases)}
    totals = [r[SLOTS] for r in rows]
    return {"phases": out, "total_block0": totals[0],
            "total_mean": sum(totals) / blocks, "total_max": max(totals)}


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` by CUDA events over ``iters``
    back-to-back calls, after one warm-up call."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def split(lib, kernel, call, blocks: int, phases, reps: int = 3) -> dict:
    """Run ``call`` (the port's wrapper) on the stamped library ``reps``
    times, check it against the port's own launch, and return the last
    launch's clocks beside both launches' CUDA-event milliseconds."""
    import torch
    want = call()
    with stamped(kernel, lib):
        for _ in range(reps):
            got = call()
        torch.cuda.synchronize()
        out = clocks(lib, blocks, phases)
        stamped_ms = cuda_ms(call, reps)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"the stamped {kernel.symbol} differs from the "
                             f"port's")
    port_ms = cuda_ms(call, reps)
    mhz = out["total_block0"] / (stamped_ms * 1e3)
    return dict(out, stamped_ms=stamped_ms, port_ms=port_ms,
                clock_mhz_from_events=mhz,
                phase_us_block0={name: v["block0"] / mhz
                                 for name, v in out["phases"].items()})


def sketch_split(lib, words, n: int, reps: int = 3) -> dict:
    """``greedy_sketch``'s stamped split on ``words`` (k = 50)."""
    from repro_torch.kernels import greedy
    blocks, shared_words = greedy.sketch_grid(words.device)
    lay = greedy.sketch_layout(words.shape[1], words.data_ptr() % 16 == 0,
                               n=n, blocks=blocks, shared_words=shared_words)
    out = split(lib, greedy._SKETCH,
                lambda: greedy.greedy_sketch(words, n=n, k=K), blocks,
                SKETCH_PHASES, reps)
    return dict(kernel="greedy_sketch", shape=list(words.shape), n=n, k=K,
                layout=lay._asdict(), **out)


def celf_split(lib, store, c: int = 32, reps: int = 3) -> dict:
    """``celf_select``'s stamped split on the store's final pool and
    sketch (k = 50, ``c`` candidates an eval call)."""
    from repro_torch.kernels import celf
    t, n = store.n_elems, store.n_nodes
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    sketch = store.sketch_words()
    kw = dict(n=n, num_rows=store.row_capacity(), k=K, c=c)
    blocks, shared_words = celf.select_grid(pool[0].device)
    lay = celf.select_layout(n, kw["num_rows"], c, sketch.shape[1], blocks,
                             shared_words, t)
    got = celf.celf_select(*pool, sketch=sketch, **kw)
    out = split(lib, celf._SELECT,
                lambda: celf.celf_select(*pool, sketch=sketch, **kw), blocks,
                CELF_PHASES, reps)
    evals, calls = got[2].tolist()
    return dict(kernel="celf_select", sketch_k=store.sketch_k,
                sketch_words=sketch.shape[1], c=c, pool_elements=t,
                layout=lay._asdict(),
                exact_evals=evals, eval_calls=calls,
                grid_barriers=int(got[3]), **out)


def stand_in(dev):
    from repro_torch.graph import csr, generators, weights
    src, dst = generators.barabasi_albert(N_NODES, BA_R, seed=0)
    return weights.wc_weights(csr.from_edges(src, dst, N_NODES, device=dev))


def celf_store(g, sketch_k: int):
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem
    solver = IMMSolver(g, engine="queue", batch=BATCH, selection="celf",
                       sketch_k=sketch_k, seed=0, device=g.device)
    solver.solve(IMProblem(k=K, eps=EPS))
    return solver.store


def approximate_words(g):
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem
    solver = IMMSolver(g, engine="queue", batch=BATCH, seed=0,
                       device=g.device)
    solver.solve(IMProblem(k=K, eps=EPS, mode="approximate",
                           max_theta=APPROX_MAX_THETA))
    return solver.store.words


def probe_words(store, sketch_k: int):
    """The exact pool folded into a sketch of ``sketch_k`` buckets
    (chip_smoke's phase 8)."""
    from repro_torch.core import sketch as sketch_mod
    t = store.n_elems
    return sketch_mod.sketch_packed_from_flat(
        store.flat[:t], store.ids[:t], store.valid[:t],
        n_rows=store.n_nodes + 1, k=sketch_k, mode="mod")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_selection_stamps: no CUDA card", file=sys.stderr)
        return 2
    libs = build()
    dev = torch.device("cuda")
    g = stand_in(dev)
    for sketch_k in CELF_SKETCH_K:
        store = celf_store(g, sketch_k)
        print(json.dumps(celf_split(libs["celf"], store, reps=args.reps)),
              flush=True)
        if sketch_k == CELF_SKETCH_K[0]:
            for probe in PROBE_SKETCH_K:
                words = probe_words(store, probe)
                print(json.dumps(dict(sketch_split(
                    libs["sketch"], words, store.n_nodes, args.reps),
                    sketch_k=probe)), flush=True)
                del words
        del store
        torch.cuda.empty_cache()
    words = approximate_words(g)
    print(json.dumps(dict(sketch_split(libs["sketch"], words, N_NODES,
                                       args.reps), cell="approximate")),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
