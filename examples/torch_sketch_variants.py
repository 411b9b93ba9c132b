#!/usr/bin/env python3
"""Time two variants of the approximate greedy against the port's
``greedy_sketch`` on one card, in turns.

    python3 examples/torch_sketch_variants.py [--iters 20] [--turns 2]

``examples/sketch_variants.cu``: ``poll`` is the port's register form with
the records as the barrier (step-tagged words polled with relaxed loads,
no grid barrier a step); ``cluster8``/``cluster16`` run the whole greedy
in one thread-block cluster of 8 or 16 blocks, the rows in the blocks'
shared memory and each step's exchange through distributed shared memory
behind one cluster barrier.  The shapes: the approximate cell's sketch
(the stand-in ``barabasi_albert(75879, 4, seed=0)``, WC weights, queue
engine, 512 lanes, seed 0, k = 50, eps = 0.5, ``max_theta`` 8,192: 75,880
x 4 words), and random sketches of 75,880 x 1 and 3 words.  Every call
must equal the plain version (``ref.greedy_sketch_ref`` on the card).  It
prints each variant's CUDA-event milliseconds of every turn (the variants
in order, then back), and the card's name and power limit.
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
sys.path.insert(0, str(ROOT / "examples"))

K = 50


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libsketch_variants.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib),
                           str(ROOT / "examples" / "sketch_variants.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    print(proc.stdout + proc.stderr, flush=True)
    return ctypes.CDLL(str(lib))


def cluster_call(lib, words, n: int, blocks: int):
    """A call of the cluster variant on ``words``: -> (seeds, gains,
    steps) as ``greedy_sketch``'s."""
    import torch
    from repro_torch.kernels import _build
    fn = lib.sketch_cluster
    vp, i32, cint = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int
    fn.argtypes = [vp, i32, i32, cint, i32, cint, vp, vp, cint, vp]
    fn.restype = cint
    w = words.shape[1]
    vector = w == 4 and words.data_ptr() % 16 == 0
    scratch = torch.empty(n, dtype=torch.uint8, device=words.device)
    out = torch.empty(2 * K + 1, dtype=torch.int32, device=words.device)
    index = words.get_device()

    def call():
        _build.raise_on(fn(words.data_ptr(), n, w, int(vector), K, blocks,
                           scratch.data_ptr(), out.data_ptr(), index,
                           _build.raw_stream(index)), "sketch_cluster")
        return out[:K], out[K:2 * K], out[2 * K:]
    return call


def poll_call(lib, words, n: int):
    """A call of the polling variant on ``words`` (the port's register
    form's rows a thread): -> (seeds, gains, steps)."""
    import torch
    from repro_torch.kernels import _build, greedy
    fn = lib.sketch_poll
    vp, i32, cint = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int
    fn.argtypes = [vp, i32, i32, cint, i32, cint, vp, vp, cint, vp]
    fn.restype = cint
    w = words.shape[1]
    blocks, shared_words = greedy.sketch_grid(words.device)
    lay = greedy.sketch_layout(w, words.data_ptr() % 16 == 0, n=n,
                               blocks=blocks, shared_words=shared_words)
    scratch = torch.empty(64 * K * blocks, dtype=torch.uint8,
                          device=words.device)
    out = torch.empty(2 * K + 1, dtype=torch.int32, device=words.device)
    index = words.get_device()

    def call():
        _build.raise_on(fn(words.data_ptr(), n, w, int(lay.vector), K,
                           lay.rows, scratch.data_ptr(), out.data_ptr(),
                           index, _build.raw_stream(index)), "sketch_poll")
        return out[:K], out[K:2 * K], out[2 * K:]
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sketch_variants: no CUDA card", file=sys.stderr)
        return 2
    import torch_selection_stamps as stamps
    from repro_torch.kernels import greedy, ref
    lib = build()
    dev = torch.device("cuda")
    g = stamps.stand_in(dev)
    shapes = {"approximate": stamps.approximate_words(g)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for w in (1, 3):
        shapes[f"random_w{w}"] = torch.randint(
            -(1 << 31), 1 << 31, (75_880, w), dtype=torch.int32, device=dev,
            generator=gen) & torch.randint(
            -(1 << 31), 1 << 31, (75_880, w), dtype=torch.int32, device=dev,
            generator=gen)
    calls = {}
    for name, words in shapes.items():
        n = words.shape[0] - 1
        want = ref.greedy_sketch_ref(words, n=n, k=K)
        variants = {"port": lambda words=words, n=n: greedy.greedy_sketch(
            words, n=n, k=K)}
        variants["poll"] = poll_call(lib, words, n)
        for blocks in (8, 16):
            variants[f"cluster{blocks}"] = cluster_call(lib, words, n, blocks)
        for key, call in variants.items():
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{key} at {name} != plain version")
            calls[f"{key} @{name}"] = call
    order = list(calls) + list(calls)[::-1]
    ms = {key: [] for key in calls}
    for _ in range(args.turns):
        for key in order:
            ms[key].append(stamps.cuda_ms(calls[key], args.iters))
    for key in calls:
        print(json.dumps({"variant": key, "ms": ms[key], "min": min(ms[key]),
                          "max": max(ms[key])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
