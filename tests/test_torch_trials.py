"""The edge trial's integer threshold against the float compare it replaces.

``csrc/bernoulli.cu`` keeps trial ``h`` of edge ``e`` iff ``h <
t(w[e])``, with ``t`` from ``kernels/ref.py::trial_threshold_ref``'s
formula; the plain version and the reference keep it iff ``float32(h) *
2^-32 < w[e]``.  Both are checked here exactly, on the CPU, at ``t - 1``,
``t`` and ``t + 1`` and at every rounding boundary of the conversion, on
weights made to sit on those boundaries: ``u(h)`` for boundary and seeded
random ``h``, one ulp above and below, and the edges of the range (0,
-0.0, 1.0, 1 + ulp, 2, +-inf, NaN, the smallest denormal, negatives).
The same weights go through the JAX reference's Pallas ``bernoulli_edges``
in interpret mode and the port's plain version, which must agree bit for
bit.  A static check keeps the plain versions off the port's solver
modules (``core/``, ``graph/``), which reach the kernels through
``kernels/ops.py``.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops, ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TWO32 = 1 << 32


def _u(h) -> np.ndarray:
    """float32(h) * 2^-32 for integer h in [0, 2^32), as float32 (the
    reference's conversion: round to nearest even)."""
    return (np.asarray(h, np.uint64).astype(np.float32)
            * np.float32(2.0 ** -32)).astype(np.float32)


def _boundary_h() -> np.ndarray:
    """h at and around every place where float32(h) changes: each power
    of two from 2^0 to 2^32 (clipped to [0, 2^32)), the tie midpoints half
    a gap below and above it, and one either side of each."""
    hs = set()
    for k in range(33):
        p = 1 << k
        gap_above = max(1, p >> 23)
        for c in (p, p - gap_above // 2, p + gap_above // 2,
                  p - max(1, gap_above // 4), p + gap_above):
            for d in (-1, 0, 1):
                hs.add(c + d)
    return np.array(sorted(h for h in hs if 0 <= h < TWO32), np.uint64)


def _random_h(n=4000, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 33, n)
    return (rng.integers(0, 1 << 62, n, dtype=np.uint64)
            % (np.uint64(1) << bits.astype(np.uint64))).astype(np.uint64)


def _near(base: np.ndarray) -> np.ndarray:
    """``base`` and one ulp above and below each."""
    return np.concatenate([base, np.nextafter(base, np.float32(2)),
                           np.nextafter(base, np.float32(-1))])


def _weights() -> dict:
    """u(h) for boundary and for random h, one ulp above and below each,
    and the edges of the range."""
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    one = np.float32(1.0)
    edges = np.array([0.0, -0.0, 1.0, np.nextafter(one, np.float32(2)), 2.0,
                      np.inf, -np.inf, np.nan, tiny, -tiny, -1.0, -0.5,
                      np.nextafter(one, np.float32(0)), 0.5, 2.0 ** -32,
                      2.0 ** -33, 2.0 ** -8], np.float32)
    return {"boundary": _near(_u(_boundary_h())),
            "random": _near(_u(_random_h())), "edges": edges}


def _all_weights() -> np.ndarray:
    return np.concatenate(list(_weights().values())).astype(np.float32)


def _keep_float(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    return _u(h) < w


def test_threshold_edges_of_the_range():
    tiny = np.finfo(np.float32).smallest_subnormal
    one_up = np.nextafter(np.float32(1), np.float32(2))
    w = torch.tensor([0.0, -0.0, float("nan"), -1.0, -tiny, tiny, 1.0,
                      float(one_up), 2.0, float("inf"), float("-inf")],
                     dtype=torch.float32)
    assert tref.trial_threshold_ref(w).tolist() == [
        0, 0, 0, 0, 0, 1, TWO32 - 128, TWO32, TWO32, TWO32, 0]


@pytest.mark.parametrize("part", ["boundary", "random", "edges"])
def test_threshold_decides_as_the_float_compare(part):
    """h < t  <=>  float32(h) * 2^-32 < w, at t - 1, t and t + 1 (those in
    [0, 2^32)) and at every boundary h, for every weight."""
    w = _weights()[part]
    t = tref.trial_threshold_ref(torch.tensor(w)).numpy()
    assert ((t >= 0) & (t <= TWO32)).all()
    for off in (-1, 0, 1):
        h = t + off
        ok = (h >= 0) & (h < TWO32)
        hh = h[ok].astype(np.uint64)
        np.testing.assert_array_equal(hh < t[ok].astype(np.uint64),
                                      _keep_float(hh, w[ok]))
    # every boundary h against a sample of the weights
    hb = _boundary_h()
    ws = w[:: max(1, len(w) // 300)]
    tt = tref.trial_threshold_ref(torch.tensor(ws)).numpy()
    got = hb[None, :].astype(np.int64) < tt[:, None]
    np.testing.assert_array_equal(got, _u(hb)[None, :] < ws[:, None])


def test_threshold_is_least():
    """t is the least h that the float compare drops: u(t - 1) < w <= u(t)
    wherever 0 < t < 2^32."""
    w = _all_weights()
    t = tref.trial_threshold_ref(torch.tensor(w)).numpy()
    mid = (t > 0) & (t < TWO32)
    assert mid.sum() > 10000
    tm = t[mid].astype(np.uint64)
    assert (_u(tm - np.uint64(1)) < w[mid]).all()
    assert (_u(tm) >= w[mid]).all()


def test_threshold_on_every_float_of_a_binade():
    """Every float32 weight in [2^-8, 2^-7) and in [0.5, 1]: 2^23 + 1 + 2^23
    thresholds, each checked at t - 1 and t."""
    lo = np.arange(np.float32(2 ** -8).view(np.int32),
                   np.float32(2 ** -7).view(np.int32), dtype=np.int32)
    hi = np.arange(np.float32(0.5).view(np.int32),
                   np.float32(1.0).view(np.int32) + 1, dtype=np.int32)
    for ints in (lo, hi):
        w = ints.view(np.float32)
        t = tref.trial_threshold_ref(torch.from_numpy(w)).numpy()
        assert ((t > 0) & (t < TWO32)).all()
        tu = t.astype(np.uint64)
        assert (_u(tu - np.uint64(1)) < w).all()
        assert (_u(tu) >= w).all()


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_plain_trials_equal_reference_on_boundary_weights(seed):
    """The port's plain version and the reference's Pallas kernel
    (interpret mode) keep the same edges on the adversarial weights."""
    w = _all_weights()
    want = np.asarray(jops.bernoulli_edges(jnp.asarray(w), jnp.uint32(seed)))
    got = tops.bernoulli_edges(torch.tensor(w), seed)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the threshold decides each of these trials as the compare does
    h = tref.counter_uniform_u32_ref(seed, torch.arange(len(w)))
    t = tref.trial_threshold_ref(torch.tensor(w))
    np.testing.assert_array_equal((h < t).numpy(), want)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("pkg", ["core", "graph"])
def test_solver_modules_do_not_import_the_plain_kernels(pkg):
    """The greedy loops and samplers reach every kernel through
    ``kernels.ops``, which sends a card tensor to the card's kernel; the
    plain versions serve the tests and the CPU route only."""
    files = sorted((ROOT / "src" / "repro_torch" / pkg).glob("*.py"))
    assert files
    for f in files:
        bad = {n for n in _imports(f) if n == "repro_torch.kernels.ref"
               or n.startswith("repro_torch.kernels.ref.")}
        assert not bad, f"{f.name} imports {bad}"
