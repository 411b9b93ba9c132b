"""The one dispatch point between the plain versions and the CUDA kernels.

A tensor on the CPU goes to ``kernels/ref.py``; a tensor on a CUDA card goes
to the hand-written kernel, which builds on first use and raises if it
cannot build or launch.  There is no switch that sends a CUDA tensor to the
plain version: code that wants the plain version on the card calls
``ref.py`` directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitset as _bitset
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch as _sketch

_COUNTERS = (_bitset.LAUNCHES, _sketch.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")


def occur_from_bitset(words: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _bitset.occur_from_bitset(words)
    return _ref.occur_from_bitset_ref(words)


def occur_from_bitset_masked(words: torch.Tensor,
                             rowmask: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _bitset.occur_from_bitset_masked(words, rowmask)
    return _ref.occur_from_bitset_masked_ref(words, rowmask)


def sketch_scatter_or(words: torch.Tensor, v: torch.Tensor,
                      bucket: torch.Tensor) -> torch.Tensor:
    """Scatter-OR of (row, bucket) pairs into ``words``, in place."""
    if _route(words) == "cuda":
        return _sketch.sketch_scatter_or(words, v, bucket)
    return _ref.sketch_scatter_or_ref(words, v, bucket)


def sketch_union_popcount(words: torch.Tensor,
                          cov: torch.Tensor) -> torch.Tensor:
    if _route(words) == "cuda":
        return _sketch.sketch_union_popcount(words, cov)
    return _ref.sketch_union_popcount_ref(words, cov)
