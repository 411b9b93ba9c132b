#!/usr/bin/env python3
"""On-card smoke run of the torch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles ``csrc/occur.cu`` with nvcc for sm_90a and prints the
   ``-Xptxas -v`` report;
3. kernels: both Occur kernels against their plain versions on random
   int32 words of shape (131072, 2372) (bit 31 set in half the words, a
   ~50% row mask), exact equality, then timed with CUDA events;
4. solve: the main path, ``IMMSolver(g, engine="queue", batch=512,
   selection="bitset", seed=0).solve(IMProblem(k=50, eps=0.5))`` on the
   epinions-like stand-in (``barabasi_albert(75879, 4, seed=0)`` with WC
   weights), with wall time per stage, peak memory and the kernels' launch
   counts, which must be > 0; then the solve's first sampling round again,
   bare and under torch.profiler, for the device's idle share;
5. parity: ``flat`` selection on the final pool equals the ``bitset``
   result (seeds, gains, frac), and both kernels equal their plain
   versions on the final bit matrix;
6. forward MC: the RIS spread estimate is within 10% of a 256-simulation
   forward Monte-Carlo spread of the seeds.

The last lines are the ``{"kernels": [...]}`` record (times at the main
path's final bit matrix), the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import forward  # noqa: E402
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.imm import IMMSolver  # noqa: E402
from repro_torch.core.packing import to_int32_bits  # noqa: E402
from repro_torch.core.problem import IMProblem  # noqa: E402
from repro_torch.core.rrset import round_seed  # noqa: E402
from repro_torch.graph import csr, generators, weights  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

# H100 SXM peaks: HBM bytes/s, and the 67 TFLOP/s non-tensor float32 rate,
# the nearest published peak for 32-bit integer ops
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12
SYNTH_SHAPE = (131072, 2372)
N_NODES, BA_R, K, EPS, BATCH = 75879, 4, 50, 0.5, 512
MC_SIMS, MC_TOL = 256, 0.10
LIBRARY_NOTE = "no single PyTorch call computes a bit-column histogram"
KERNELS = {
    "occur_from_bitset": "src/repro/kernels/bitset.py:167",
    "occur_from_bitset_masked": "src/repro/kernels/bitset.py:133",
}


def say(tag: str, obj) -> None:
    print(f"{tag}: {json.dumps(obj)}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(rows_read: int, rows: int, cols: int, masked: bool):
    """Least time for the histogram: read the selected rows once (plus the
    mask), write W*32 int32; one add per bit read.  Returns (ms, by)."""
    nbytes = rows_read * cols * 4 + cols * 32 * 4 + (rows * 4 if masked else 0)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = rows_read * cols * 32 / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_records(words, mask, launches=None, iters=20, plain_iters=3):
    """Check both kernels against the plain versions on (words, mask)
    exactly, then time kernel and plain version."""
    rows, cols = words.shape
    got = ops.occur_from_bitset(words)
    want = ref.occur_from_bitset_ref(words)
    gotm = ops.occur_from_bitset_masked(words, mask)
    wantm = ref.occur_from_bitset_masked_ref(words, mask)
    torch.cuda.synchronize()
    errs = [float((got - want).abs().max()), float((gotm - wantm).abs().max())]
    if errs != [0.0, 0.0] or not (torch.equal(got, want)
                                  and torch.equal(gotm, wantm)):
        raise AssertionError(f"kernel != plain version at {tuple(words.shape)}:"
                             f" max abs err {errs}")
    n_sel = int(mask.count_nonzero())
    calls = {
        "occur_from_bitset": (lambda: ops.occur_from_bitset(words),
                              lambda: ref.occur_from_bitset_ref(words), rows,
                              False),
        "occur_from_bitset_masked": (
            lambda: ops.occur_from_bitset_masked(words, mask),
            lambda: ref.occur_from_bitset_masked_ref(words, mask), n_sel,
            True),
    }
    out = []
    for (name, (kern, plain, rows_read, masked)), err in zip(calls.items(),
                                                             errs):
        b_ms, b_by = bound_ms(rows_read, rows, cols, masked)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/occur.cu",
            "replaces": KERNELS[name],
            "launches": None if launches is None else launches[name],
            "max_abs_err": err, "ms": cuda_ms(kern, iters),
            "plain_ms": cuda_ms(plain, plain_iters),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [rows, cols], "mask_rows": n_sel if masked else None,
        })
    return out


def profile_round(engine, seed32: int) -> dict:
    """One sampling round timed bare, then the same round (same seed, same
    work) under torch.profiler: the device's busy time over the bare
    round's wall time gives the device's idle share while sampling."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = engine.sample(seed32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.sample(seed32)
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ops) / 1e6
    return {"steps": batch.steps, "wall_s": wall, "ms_per_step":
            wall / batch.steps * 1e3, "device_ops": len(dev_ops),
            "device_ops_per_step": len(dev_ops) / batch.steps,
            "device_busy_s": busy if dev_ops else "not measured",
            "device_idle_share": 1 - busy / wall if dev_ops
            else "not measured"}


class StageClock:
    """Host wall time of a method, between two torch.cuda.synchronize()."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def wrap(self, obj, method: str, label: str) -> None:
        fn = getattr(obj, method)
        self.seconds[label] = 0.0
        self.calls[label] = 0

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1
            return out

        setattr(obj, method, timed)


def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    say("torch", {"torch": torch.__version__, "cuda": torch.version.cuda,
                  "device": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("occur")
    say("build", {"library": str(lib.relative_to(ROOT)),
                  "seconds": time.perf_counter() - t0})
    print(_build.PTXAS_REPORT.get("occur", "(cached build: no ptxas report)"),
          flush=True)

    # 3. kernels against their plain versions at (131072, 2372)
    gen = torch.Generator(device=dev).manual_seed(0)
    words = to_int32_bits(torch.randint(0, 1 << 32, SYNTH_SHAPE,
                                        dtype=torch.int64, device=dev,
                                        generator=gen))
    if not bool((words < 0).any()):
        raise AssertionError("synthetic words lack bit 31")
    mask = (torch.rand(SYNTH_SHAPE[0], device=dev, generator=gen)
            < 0.5).to(torch.int32)
    say("kernels", kernel_records(words, mask))
    del words, mask
    torch.cuda.empty_cache()

    # 4. the main path: one plain IC solve with the bitset selection
    t0 = time.perf_counter()
    src, dst = generators.barabasi_albert(N_NODES, BA_R, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, N_NODES, device=dev))
    solver = IMMSolver(g, engine="queue", batch=BATCH, selection="bitset",
                       seed=0, device=dev)
    setup_s = time.perf_counter() - t0
    clock = StageClock()
    clock.wrap(solver.engine, "sample", "sampling")
    clock.wrap(solver.store, "append_batch", "append")
    clock.wrap(solver.store, "bitset_matrix", "bitset_build")
    clock.wrap(solver.store, "select", "select_total")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = res.stats
    store = solver.store
    sec = dict(clock.seconds)
    sec["selection"] = sec.pop("select_total") - sec["bitset_build"]
    calls = dict(clock.calls)
    m = store.bitset_matrix()
    say("solve", {
        "n": g.n_nodes, "m": g.n_edges, "k": K, "eps": EPS, "batch": BATCH,
        "theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
        "rounds": st.rounds, "n_rr": store.n_rr,
        "pool_elements": store.n_elems, "pool_capacity": store.capacity,
        "mean_rr_size": store.n_elems / store.n_rr,
        "max_in_degree": int(csr.degrees(g)[1].max()),
        "sampling_steps": st.sampling_steps,
        "overflow_fraction": st.overflow_fraction,
        "bit_matrix_shape": list(m.shape),
        "bit_matrix_bytes": m.numel() * m.element_size(),
        "setup_s": setup_s, "solve_s": solve_s, "stage_s": sec,
        "stage_calls": calls,
        "sampler_share": sec["sampling"] / solve_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "spread": res.spread, "frac": res.frac,
        "history": st.history,
    })
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    say("sampler_round", profile_round(
        make_engine("queue", csr.reverse(g), batch=BATCH), round_seed(0, 0)))
    seeds = res.seeds
    if len(set(seeds.tolist())) != K or not math.isfinite(res.spread):
        raise AssertionError(f"bad result: seeds {seeds}, spread {res.spread}")

    # 5. parity: flat selection == bitset selection on the final pool, and
    # both kernels == plain versions on the final bit matrix
    bit = store.select(K, method="bitset")
    flat = store.select(K, method="flat")
    same = (torch.equal(bit.seeds, flat.seeds)
            and torch.equal(bit.gains, flat.gains)
            and bit.frac.cpu().numpy().tobytes()
            == flat.frac.cpu().numpy().tobytes()
            and bit.seeds.cpu().numpy().tolist() == seeds.tolist())
    say("parity", {"flat_equals_bitset": same,
                   "seeds": seeds.tolist()[:10], "frac": float(flat.frac)})
    if not same:
        raise AssertionError("flat and bitset selections differ")
    u0 = int(bit.seeds[0])
    first_newly = ((m[:, u0 >> 5] >> (u0 & 31)) & 1).to(torch.int32)
    records = kernel_records(m, first_newly, launches=launches)

    # 6. forward Monte-Carlo check of the RIS estimate
    t0 = time.perf_counter()
    mc = forward.ic_spread(g, seeds, n_sims=MC_SIMS, seed=0)
    rel = abs(res.spread - mc) / mc
    say("forward_mc", {"ris_spread": res.spread, "mc_spread": mc,
                       "rel_err": rel, "tol": MC_TOL, "sims": MC_SIMS,
                       "seconds": time.perf_counter() - t0})
    if not rel < MC_TOL:
        raise AssertionError(f"RIS {res.spread} vs MC {mc}: {rel:.3f} >= "
                             f"{MC_TOL}")

    say("library_ms", {"null_because": LIBRARY_NOTE})
    say("total", {"seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": records}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
