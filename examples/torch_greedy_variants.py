#!/usr/bin/env python3
"""Time the fused greedy (``csrc/greedy.cu``) against the parent's
``flat`` loop and against variants of its design on one card, in turns.

    python3 examples/torch_greedy_variants.py [--iters 20] [--turns 2]

The pools are the exact cell's final pools: the default-options solves
``IMMSolver(g, engine="queue", batch=512, seed=0).solve(IMProblem(50,
eps))`` at ε = 0.5 and 0.25 on the stand-in (``barabasi_albert(75879, 4,
seed=0)``, WC weights).  On each pool, k = 50:

* ``parent loop``: the parent commit's ``_select_flat`` (its loop,
  verbatim below: about 25 torch operations a step, ``popcount_words`` on
  the card) and ``_frac``;
* ``selection``: this checkout's ``store.select(50, method="flat")``, the
  wrapper's index build and one ``greedy_flat`` launch, and ``_frac``;
* ``kernel``: ``greedy_flat``'s launch alone, on a prebuilt index, at a
  block an SM (the default), two, and as many as stay resident;
* ``one launch a step``: ``greedy_steps`` of ``examples/greedy_variants.cu``
  (the stream order in place of the grid barriers, the argmax by the last
  block to take a ticket), k launches from one C call;
* ``cluster 8`` and ``cluster 16``: ``greedy_cluster``, one thread-block
  cluster with Occur and Covered in the CTAs' distributed shared memory;
* ``barriers alone``: the kernel's grid running its 2k barriers and
  nothing else.

Every variant must give the plain version's seeds and gains
(``ref.greedy_flat_ref`` on the card).  It prints the variants' ptxas
report, each variant's CUDA-event milliseconds a call of every turn (the
order: the variants, then back), and the card's name and power limit.
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


def parent_select_flat(store, k):
    """The parent commit's ``core/coverage.py::_select_flat`` and its
    helpers, as they were (now ``kernels/ref.py::greedy_flat_ref``, whose
    popcount is the plain one)."""
    import torch
    from repro_torch.core.coverage import _frac
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (_newly_rows, _pack_covered,
                                         _unpack_covered)
    n, t = store.n_nodes, store.n_elems
    num_rows = store.row_capacity()
    flat = store.flat[:t].to(torch.int64)
    ids = store.ids[:t].to(torch.int64)
    valid = store.valid[:t]
    dev = flat.device
    occur = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, valid.to(torch.int32))[:n]
    cov = torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        newly = _newly_rows(flat, ids, valid, _unpack_covered(cov), u)
        new_words = _pack_covered(newly)
        gains.append(kops.popcount_words(new_words.view(1, -1)).sum())
        elem_newly = (newly[ids] & valid).to(torch.int32)
        occur = occur - torch.zeros(n + 1, dtype=torch.int32,
                                    device=dev).index_add_(
            0, flat, elem_newly)[:n]
        cov = cov | new_words
        seeds.append(u)
    gains = torch.stack(gains).to(torch.int32)
    return torch.stack(seeds).to(torch.int32), gains, _frac(gains,
                                                            store.n_rr)


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
    """(name -> call, name -> the call's (2, k) seeds and gains where it
    writes them, the pool, greedy_flat's keywords, the index) on one
    pool."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import greedy as tgreedy
    t, n, k = store.n_elems, store.n_nodes, K
    num_rows = store.row_capacity()
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    idx = tgreedy.flat_index(*pool, n=n, num_rows=num_rows)
    dev = store.flat.device
    ptrs = [x.data_ptr() for x in idx]
    stream = torch.cuda.current_stream().cuda_stream
    steps, cluster = ctypes.CDLL(str(lib)).greedy_steps, \
        ctypes.CDLL(str(lib)).greedy_cluster
    steps.argtypes = tgreedy._GREEDY.argtypes
    cluster.argtypes = tgreedy._GREEDY.argtypes[:7] + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    steps.restype = cluster.restype = ctypes.c_int
    calls, outs = {}, {}

    def held(name, fn):
        out = torch.empty(2, k, dtype=torch.int32, device=dev)
        calls[name] = lambda: fn(out)
        outs[name] = out

    def raise_on(err):
        _build.raise_on(err, "variant")

    for per_sm in (1, 2, 0):
        scratch = torch.empty(8 * k + 4 * n + num_rows, dtype=torch.uint8,
                              device=dev)
        held(f"kernel {per_sm or 'resident'}/SM",
             lambda out, s=scratch, p=per_sm: raise_on(
                 tgreedy._GREEDY(*ptrs, n, num_rows, k, s.data_ptr(),
                                 out.data_ptr(), p, dev.index, stream)))
    ticketed = torch.zeros(8 * k + 4 * n + num_rows + 8, dtype=torch.uint8,
                           device=dev)
    held("one launch a step", lambda out: raise_on(steps(
        *ptrs, n, num_rows, k, ticketed.data_ptr(), out.data_ptr(), 1,
        dev.index, stream)))
    for ctas in (8, 16):
        held(f"cluster {ctas}", lambda out, c=ctas: raise_on(cluster(
            *ptrs, n, num_rows, k, out.data_ptr(), c, dev.index, stream)))
    calls["selection"] = lambda: store.select(k, method="flat")
    calls["parent loop"] = lambda: parent_select_flat(store, k)
    calls["barriers alone"] = lambda: tgreedy.grid_barriers(2 * k, dev)
    # the index lives as long as the calls that read it
    return calls, outs, pool, dict(n=n, num_rows=num_rows, k=k), idx


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
    from repro_torch.kernels import ref
    lib, ptxas = build()
    print(ptxas, flush=True)
    dev = torch.device("cuda")
    src, dst = generators.barabasi_albert(75879, 4, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 75879, device=dev))
    calls, held = {}, []
    for eps in EPS:
        solver = IMMSolver(g, engine="queue", batch=512, seed=0, device=dev)
        solver.solve(IMProblem(k=K, eps=eps))
        store = solver.store
        these, outs, pool, kw, idx = calls_on(store, lib)
        held.append(idx)
        want = ref.greedy_flat_ref(*pool, **kw)
        for name, call in these.items():
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as err:          # a launch the card refused
                print(json.dumps({"variant": name, "eps": eps,
                                  "error": str(err)}), flush=True)
                continue
            if name in outs:
                got = outs[name]
            if name != "barriers alone" and not (
                    torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                bad = torch.nonzero((got[0] != want[0])
                                    | (got[1] != want[1]))[:, 0].tolist()
                raise AssertionError(
                    f"{name} at eps {eps} != plain version from step "
                    f"{bad[0]}: {got[0][bad[0]:bad[0] + 3].tolist()} "
                    f"{got[1][bad[0]:bad[0] + 3].tolist()} against "
                    f"{want[0][bad[0]:bad[0] + 3].tolist()} "
                    f"{want[1][bad[0]:bad[0] + 3].tolist()}")
            calls[f"{name} @eps{eps}"] = call
        print(json.dumps({"eps": eps, "n_rr": store.n_rr,
                          "pool_elements": store.n_elems,
                          "gains_sum": int(want[1].sum())}), flush=True)
    order = list(calls) + list(calls)[::-1]
    ms = {key: [] for key in calls}
    for _ in range(args.turns):
        for key in order:
            iters = 3 if key.startswith("parent") else args.iters
            ms[key].append(chip_smoke.cuda_ms(calls[key], iters))
    for key in calls:
        print(json.dumps({"variant": key, "ms": ms[key],
                          "min": min(ms[key]), "max": max(ms[key])}),
              flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
