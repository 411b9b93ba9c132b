"""Graph layer of the torch port against the JAX reference: CSR arrays,
digests, weight schemes and generators must be equal (exact: both sides do
the same host numpy work), and the port imports neither jax nor repro."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graph import csr as jcsr, generators as jgen, weights as jw
from repro_torch import convert
from repro_torch.graph import csr as tcsr, generators as tgen, weights as tw

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _assert_graph_equal(tg, jg):
    for t, j in zip(tg, jg):
        a, b = t.numpy(), np.asarray(j)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tcsr.graph_digest(tg) == jcsr.graph_digest(jg)


def _edges(kind):
    if kind == "ba":
        return jgen.barabasi_albert(300, 3, seed=4), 300
    if kind == "er":
        return jgen.erdos_renyi(200, 900, seed=5), 200
    rng = np.random.default_rng(6)               # parallel edges, unsorted
    src = rng.integers(0, 50, 600)
    dst = rng.integers(0, 50, 600)
    return (src, dst), 50


@pytest.mark.parametrize("kind", ["ba", "er", "multi"])
def test_csr_build_reverse_coalesce_equal(kind):
    (src, dst), n = _edges(kind)
    w = np.random.default_rng(1).uniform(size=len(src)).astype(np.float32)
    jg = jcsr.from_edges(src, dst, n, weights=w)
    tg = tcsr.from_edges(src, dst, n, weights=w, device=CPU)
    _assert_graph_equal(tg, jg)
    _assert_graph_equal(tcsr.reverse(tg), jcsr.reverse(jg))
    _assert_graph_equal(tcsr.coalesce_ic(tcsr.reverse(tg)),
                        jcsr.coalesce_ic(jcsr.reverse(jg)))
    _assert_graph_equal(tcsr.coalesce_ic(tg), jcsr.coalesce_ic(jg))
    assert tcsr.rows_dst_sorted(tg) == jcsr.rows_dst_sorted(jg)
    assert tcsr.rows_dst_sorted(tcsr.reverse(tg))
    for a, b in zip(tcsr.degrees(tg), jcsr.degrees(jg)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcsr.to_edges(tg), jcsr.to_edges(jg)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_from_edges_rejects_ungrouped_and_out_of_range():
    with pytest.raises(ValueError, match="source-grouped"):
        tcsr.from_edges([2, 0, 1], [0, 1, 2], 3, sort=False, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        tcsr.from_edges([0, 3], [1, 0], 3, device=CPU)


def test_digest_tracks_content():
    (src, dst), n = _edges("er")
    g = tcsr.from_edges(src, dst, n, device=CPU)
    w = g.weights.clone()
    w[0] += 0.5
    assert tcsr.graph_digest(g) != tcsr.graph_digest(
        tcsr.CSRGraph(g.offsets, g.indices, w))


@pytest.mark.parametrize("scheme", ["wc", "uniform", "uniform_p",
                                    "trivalency"])
def test_weight_schemes_equal(scheme):
    (src, dst), n = _edges("ba")
    jg = jcsr.from_edges(src, dst, n)
    tg = tcsr.from_edges(src, dst, n, device=CPU)
    fn = {"wc": (jw.wc_weights, tw.wc_weights, {}),
          "uniform": (jw.uniform_weights, tw.uniform_weights, {"seed": 3}),
          "uniform_p": (jw.uniform_weights, tw.uniform_weights, {"p": 0.1}),
          "trivalency": (jw.trivalency_weights, tw.trivalency_weights,
                         {"seed": 9})}[scheme]
    _assert_graph_equal(fn[1](tg, **fn[2]), fn[0](jg, **fn[2]))


@pytest.mark.parametrize("args", [(2000, 4, 0), (150, 1, 3), (70000, 2, 1)])
def test_barabasi_albert_same_edges(args):
    # 70000 nodes crosses the generator's 65536-node pool block
    n, r, seed = args
    for a, b in zip(tgen.barabasi_albert(n, r, seed=seed),
                    jgen.barabasi_albert(n, r, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("directed", [True, False])
def test_erdos_renyi_same_edges(directed):
    for a, b in zip(tgen.erdos_renyi(500, 3000, seed=2, directed=directed),
                    jgen.erdos_renyi(500, 3000, seed=2, directed=directed)):
        np.testing.assert_array_equal(a, b)


def test_graph_from_arrays_carries_reference_graph():
    (src, dst), n = _edges("ba")
    jg = jw.wc_weights(jcsr.from_edges(src, dst, n))
    tg = convert.graph_from_arrays(*(np.asarray(a) for a in jg), device=CPU)
    _assert_graph_equal(tg, jg)
    with pytest.raises(ValueError):
        convert.graph_from_arrays(np.asarray(jg.offsets)[:-1],
                                  np.asarray(jg.indices),
                                  np.asarray(jg.weights), device=CPU)


def test_default_device_is_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        g = tcsr.from_edges([0], [1], 2)
        assert g.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcsr.from_edges([0], [1], 2)


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s]|$)",
                     re.M)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    assert offenders == []
    # and at run time: importing the whole port loads no jax and no repro
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
