#!/usr/bin/env python3
"""Time the edge-trial kernel (``csrc/bernoulli.cu``) against variants of
its loop on one card, in turns.

    python3 examples/torch_trial_variants.py [--iters 100] [--turns 3]

Each variant is the checkout's source with one text substitution, built
with the port's nvcc flags into ``build/kernels/variants/`` and called
through its C entry point at the dense solve's shape (512 seeds x 607,012
uniform weights from a fixed seed):

* ``this``: the source as it is;
* ``umulhi shifts``: the finalizers' shifts written as ``__umulhi`` by a
  power of two, which moves them from the integer ALU to the IMAD pipe;
* ``or packing``: each compare packed as ``word |= (h <= limit) << 8j``
  instead of a predicated add.

Every variant must give the plain version's output exactly.  For each it
prints the instructions a trial by class (``chip_smoke.sass_ops_per_store``
on its SASS) and the CUDA-event milliseconds a call of every turn (the
order this, the variants, then back), then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

HASH = """  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;"""
VARIANTS = {
    "this": [],
    "umulhi shifts": [(HASH, HASH.replace("x >> 16", "__umulhi(x, 0x10000u)")
                       .replace("x >> 13", "__umulhi(x, 0x80000u)"))],
    "or packing": [("if (h <= limit[g][j]) word += 1u << (8 * j);",
                    "word |= uint32_t(h <= limit[g][j]) << (8 * j);")],
}


def build(name: str, subs: list) -> Path:
    from repro_torch.kernels import _build
    text = (_build.CSRC / "bernoulli.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {name!r}: text not found in the source")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_")
    src = out / f"{stem}.cu"
    src.write_text(text)
    lib = out / f"lib{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_trial_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ref
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS,
                                           VARIANTS.values())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    w = torch.rand(607012, device=dev, generator=gen)
    seeds = torch.arange(512, device=dev, dtype=torch.int64) * 0x9E3779B1
    want = ref.bernoulli_edges_ref(w, seeds)
    calls, ops = {}, {}
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, lib in libs.items():
        ops[name] = chip_smoke.sass_ops_per_store(
            chip_smoke.cuobjdump_sass(lib), chip_smoke.BERNOULLI_LOOP)
        fn = ctypes.CDLL(str(lib)).bernoulli_edges
        fn.argtypes = [vp, vp, i64, i64, vp, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        out = torch.empty(want.shape, dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn=fn, out=out):
            if fn(w.data_ptr(), seeds.data_ptr(), want.shape[0],
                  want.shape[1], out.data_ptr(), dev.index or 0, stream):
                raise RuntimeError("launch failed")
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"variant {name!r} != plain version")
        calls[name] = call
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    ms = {name: [] for name in VARIANTS}
    for _ in range(args.turns):
        for name in order:
            ms[name].append(chip_smoke.cuda_ms(calls[name], args.iters))
    for name in VARIANTS:
        print(json.dumps({"variant": name, "ops_per_trial": ops[name],
                          "ms": ms[name]}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
