"""Build, load and bind the CUDA kernels of the port (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``; nothing includes PyTorch's headers, so
a build takes seconds.  Libraries go to ``build/kernels/`` at the root of
the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, and are built at first use (never at
import).  Concurrent builders write to a temporary name and rename, so the
last one wins with an identical file.

:class:`Kernel` binds one C entry point: it builds and loads its library
at the first call, sets the argument types once and keeps the bound
function, so a later call costs one ctypes call.  :func:`raw_stream` gives
PyTorch's current stream of a card as the raw handle that the entry points
take.  The wrappers of ``bitset.py`` launch through both, and pass the
card's index to entry points that make it current themselves
(``csrc/device_guard.cuh``).

The wrapper modules share the launch-error check below; ``bitset.py``,
``sketch.py`` and ``membership.py`` also share the input check of a 2-D
int32 matrix.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTXAS_REPORT: dict[str, str] = {}     # source name -> nvcc's -Xptxas -v output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; return the library's path."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{tag}.so"
    report = BUILD_DIR / f"lib{name}_{tag}.ptxas.txt"
    if lib.exists():
        if name not in PTXAS_REPORT and report.exists():
            PTXAS_REPORT[name] = report.read_text()
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        PTXAS_REPORT[name] = proc.stdout + proc.stderr
        report.write_text(PTXAS_REPORT[name])
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once."""
    return ctypes.CDLL(str(build(name)))


class Kernel:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, returning a
    cudaError_t as int; built, loaded and bound at its first call."""

    __slots__ = ("source", "symbol", "argtypes", "_fn")

    def __init__(self, source: str, symbol: str, argtypes) -> None:
        self.source, self.symbol = source, symbol
        self.argtypes = list(argtypes)
        self._fn = None

    def _bind(self):
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, *args) -> int:
        fn = self._fn
        if fn is None:
            fn = self._bind()
        return fn(*args)


def raw_stream(index: int) -> int:
    """PyTorch's current stream of card ``index`` as a raw handle: the value
    of ``torch.cuda.current_stream(index).cuda_stream``, without building a
    Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_words(words, name: str = "words") -> None:
    """Raise unless ``words`` (packed bits, or the padded RR rows) is a
    contiguous 2-D int32 tensor on a card."""
    if words.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {words.device}")
    if words.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {words.dtype}")
    if words.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
