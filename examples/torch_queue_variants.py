#!/usr/bin/env python3
"""Time the queue sampler's kernel (``csrc/queue.cu``) against variants of
it on one card, in turns.

    python3 examples/torch_queue_variants.py [--iters 20] [--turns 3]
                                             [--sass-dir DIR]

Each variant is the checkout's source with text substitutions, built with
the port's nvcc flags into ``build/kernels/variants/`` and called through
its C entry point at the exact path's first round on the stand-in
(``barabasi_albert(75879, 4, seed=0)``, WC weights, reverse, coalesced;
``round_seed(0, 0)``, qcap = n, EC 128):

* ``this``: the source as it is;
* ``integer threshold``: the trial as ``h <= trial_limit(w)``
  (``counter_hash.cuh``) in place of the float compare;
* ``branchy trials``: each trial behind ``trial_limit``'s branches and the
  visited test, one after another, as the kernel's first version ran
  them (this one runs a batch's trials branch-free into a word of live
  bits, and tests visited bits only when one is set);
* ``prefetch``: the next batch's weights load while this batch's trials
  run;
* ``scalar fill`` and ``streaming scalar fill``: the queue's zeros
  written 4 bytes a store, plain and evict-first (``__stcs``), in place
  of 16-byte evict-first stores between a 4-byte head and tail;
* ``no mirror``: every dequeue reads the queue in global memory, with no
  copy of its head in shared memory;
* ``one row path``: rows of at most 32 edges go through the segment path
  too (two barriers a row) instead of one ballot in every warp;
* ``256 threads`` and ``1024 threads``: blocks of 8 and 32 warps (the
  segment shrinks and grows with them);
* ``batch 4`` and ``batch 16``: tiles a warp loads before it ranks them.

Every variant must give the plain version's bytes (``ref.queue_round_ref``
on the card).  Each is also timed at B = 64 (the first 64 lanes, one to
an SM, among them one that walks all five hub rows), and ``this`` at qcap
= 64 (the same BFS without writing 155 MB of queue zeros).  For each it prints
the registers and spills that ptxas reports, the kernel's SASS
instructions, and the CUDA-event milliseconds a call of every turn (the
order: the variants, then back), then the card's name and power limit.
With ``--sass-dir`` each variant's SASS is written there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BATCH_TRIALS = """        uint32_t live = 0;
#pragma unroll
        for (int t = 0; t < kBatch; ++t)
          live |= uint32_t(is_live(w[t], seed,
                                   first + uint32_t(i0 + t) * 32u + lane))
                  << t;
        if (__any_sync(kFullMask, live != 0)) {
#pragma unroll
          for (int t = 0; t < kBatch; ++t) {
            bool acc = false;
            if ((live >> t) & 1u)
              acc = !vis.seen(__ldg(indices + first +
                                    uint32_t(i0 + t) * 32u + lane));"""
# each trial behind trial_limit's branches and the visited test, as the
# first version of this kernel wrote it
BRANCHY_TRIALS = """        {
#pragma unroll
          for (int t = 0; t < kBatch; ++t) {
            const uint32_t e = first + uint32_t(i0 + t) * 32u + lane;
            uint32_t limit;
            bool acc = false;
            if (trial_limit(w[t], &limit) &&
                counter_uniform_u32(seed, e) <= limit)
              acc = !vis.seen(__ldg(indices + e));"""
FLOAT_TRIAL = ("  return __uint2float_rn(counter_uniform_u32(seed, e)) "
               "* 0x1p-32f < w;")
INTEGER_TRIAL = """  uint32_t limit;
  const bool ok = trial_limit(w, &limit);
  return ok & (counter_uniform_u32(seed, e) <= limit);"""
LOADS = """      for (int32_t i0 = 0; i0 < per_warp; i0 += kBatch) {
        float w[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const uint32_t e = first + uint32_t(i0 + t) * 32u + lane;
          w[t] = e < end ? __ldg(weights + e) : 0.f;
        }
"""
# the next batch's weights load while this batch's trials run
PREFETCH = """      auto load = [&](float* w, int32_t i0) {
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const uint32_t e = first + uint32_t(i0 + t) * 32u + lane;
          w[t] = e < end ? __ldg(weights + e) : 0.f;
        }
      };
      auto swap = [](float* w, const float* next) {
#pragma unroll
        for (int t = 0; t < kBatch; ++t) w[t] = next[t];
      };
      float w[kBatch], next[kBatch];
      load(w, 0);
      for (int32_t i0 = 0; i0 < per_warp; i0 += kBatch, swap(w, next)) {
        load(next, i0 + kBatch);
"""
FILL = """    for (uintptr_t p = lo + 4 * tid; p < a; p += 4 * kThreads)
      __stcs(reinterpret_cast<int32_t*>(p), 0);
    for (uintptr_t p = a + 16 * tid; p < z; p += 16 * kThreads)
      __stcs(reinterpret_cast<int4*>(p), make_int4(0, 0, 0, 0));
    for (uintptr_t p = z + 4 * tid; p < hi; p += 4 * kThreads)
      __stcs(reinterpret_cast<int32_t*>(p), 0);"""
# 4-byte stores, plain and evict-first
SCALAR_FILL = ("    for (int64_t i = tail + tid; i < qcap; i += kThreads) "
               "q[i] = 0;")
THREADS = "constexpr int kThreads = 512;"
BOUNDS = "__launch_bounds__(kThreads, 2)"
BATCH = "constexpr int kBatch = 8;"
VARIANTS = {
    "this": [],
    "integer threshold": [(FLOAT_TRIAL, INTEGER_TRIAL)],
    "branchy trials": [(BATCH_TRIALS, BRANCHY_TRIALS)],
    "prefetch": [(LOADS, PREFETCH)],
    "scalar fill": [(FILL, SCALAR_FILL)],
    "streaming scalar fill": [(FILL, SCALAR_FILL.replace(
        "q[i] = 0;", "__stcs(q + i, 0);"))],
    "no mirror": [("head < kMirror ? mirror[head] : __ldcg(q + head)",
                   "__ldcg(q + head)"),
                  ("    if (pos < kMirror) mirror[pos] = v;\n", "")],
    "one row path": [("    if (deg <= 32 && __any_sync(kFullMask, live0)) {",
                      "    if (false) {"),
                     ("deg > 32 && base < deg", "base < deg")],
    "256 threads": [(THREADS, "constexpr int kThreads = 256;"),
                    (BOUNDS, "__launch_bounds__(kThreads, 4)")],
    "1024 threads": [(THREADS, "constexpr int kThreads = 1024;"),
                     (BOUNDS, "__launch_bounds__(kThreads, 1)")],
    "batch 4": [(BATCH, "constexpr int kBatch = 4;")],
    "batch 16": [(BATCH, "constexpr int kBatch = 16;")],
}


def build(name: str, subs: list) -> tuple:
    """(library, ptxas report) of a variant."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "queue.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {name!r}: text not found in the source")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = "queue_" + name.replace(" ", "_")
    src = out / f"{stem}.cu"
    src.write_text(text)
    lib = out / f"lib{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def launcher(lib: Path, g, seed32: int, batch: int, qcap: int):
    """(call, outputs) of a variant's C entry point on this round."""
    import torch
    from repro_torch.kernels import queue as tqueue
    fn = ctypes.CDLL(str(lib)).queue_bfs
    fn.argtypes = tqueue._BFS.argtypes
    fn.restype = ctypes.c_int
    dev = g.offsets.device
    outs = (torch.empty(batch, qcap, dtype=torch.int32, device=dev),
            torch.empty(batch, dtype=torch.int32, device=dev),
            torch.empty(batch, dtype=torch.bool, device=dev),
            torch.empty(batch, dtype=torch.int64, device=dev),
            torch.empty(batch, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream().cuda_stream
    q, lengths, over, steps, roots = (t.data_ptr() for t in outs)

    def call():
        err = fn(g.offsets.data_ptr(), g.indices.data_ptr(),
                 g.weights.data_ptr(), seed32, batch, g.n_nodes, qcap, 128,
                 q, None, roots, lengths, over, steps, None, None,
                 0, 1, 0, dev.index or 0, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return call, outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--sass-dir")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_queue_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core.rrset import round_seed
    from repro_torch.graph import csr, generators, weights
    from repro_torch.kernels import ref
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS,
                                            VARIANTS.values())))
    dev = torch.device("cuda")
    src, dst = generators.barabasi_albert(75879, 4, seed=0)
    g = csr.coalesce_ic(csr.reverse(weights.wc_weights(
        csr.from_edges(src, dst, 75879, device=dev))))
    seed32, n = round_seed(0, 0), g.n_nodes
    shapes = {"B512": (512, n), "B64": (64, n), "qcap64": (512, 64)}
    want = {key: ref.queue_round_ref(g.offsets, g.indices, g.weights, seed32,
                                     b, qcap=q, ec=128)
            for key, (b, q) in shapes.items()}
    calls, info = {}, {}
    for name, (lib, ptxas) in built.items():
        keys = shapes if name == "this" else ("B512", "B64")
        for key in keys:
            call, outs = launcher(lib, g, seed32, *shapes[key])
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(outs, want[key])):
                raise AssertionError(f"variant {name!r} at {key} != plain "
                                     "version")
            calls[f"{name} {key}"] = call
        sass = chip_smoke.cuobjdump_sass(lib)
        if args.sass_dir:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"{name.replace(' ', '_')}.sass"
             ).write_text(sass)
        regs = re.findall(r"Used (\d+) registers", ptxas)
        spills = re.findall(r"(\d+) bytes spill stores", ptxas)
        info[name] = {"registers": regs, "spill_stores": spills,
                      "sass_instructions": len(re.findall(
                          r"/\*[0-9a-f]{4}\*/\s+[A-Z@]", sass))}
    order = list(calls) + list(calls)[::-1]
    ms = {key: [] for key in calls}
    for _ in range(args.turns):
        for key in order:
            ms[key].append(chip_smoke.cuda_ms(calls[key], args.iters))
    for key in calls:
        name = key.rsplit(" ", 1)[0]
        print(json.dumps({"variant": key, **info[name], "ms": ms[key]}),
              flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
