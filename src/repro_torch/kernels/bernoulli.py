"""Counter-based uniform stream: the murmur3 fmix32 hash of
``repro.kernels.bernoulli`` (``hash_mix``, ``counter_uniform_u32``), and
the CUDA wrapper of its edge-trial kernel (``csrc/bernoulli.cu``).

Bit-exact wherever it runs, so the plain sampler in torch and a CUDA
sampler give the same random numbers.  torch on the CPU lacks uint32
shifts and arithmetic, and ``>>`` on int32 sign-extends, so every value
here is an int64 tensor holding an unsigned 32-bit quantity, masked with
``& 0xFFFFFFFF`` after each step.  The 32x32-bit multiply is split into
16-bit halves so that no int64 product overflows.

:func:`bernoulli_edges` replaces the Pallas kernel of the same name (vmapped
over seeds, as the reference's dense sampler calls it).  It takes CUDA
tensors only; ``kernels/ops.py`` routes CPU tensors to
``ref.bernoulli_edges_ref``.  It launches through a :class:`_build.Kernel`
(built and loaded at the first launch, so importing the hash loads
nothing) with the card's index and the raw handle of PyTorch's current
stream (:func:`_build.raw_stream`), as ``kernels/bitset.py`` does, and
converts the seeds only when they are not a contiguous int64 vector on
the weights' card already.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"bernoulli_edges": 0}

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = mul_u32(x, _M1)
    x = x ^ (x >> 13)
    x = mul_u32(x, _M2)
    x = x ^ (x >> 16)
    return x


def counter_uniform_u32(seed, counter) -> torch.Tensor:
    """uint32 uniform at (seed, counter), double-mixed; int64 result.

    ``seed`` and ``counter`` are ints or integer tensors (broadcast, on the
    device of the tensor among them); both are taken mod 2^32, as the
    reference's ``astype(uint32)`` does.  Beside a tensor, an int stays a
    Python scalar in the arithmetic, so it is never copied to a card (a
    copy that would make the host wait).
    """
    dev = next((a.device for a in (counter, seed)
                if isinstance(a, torch.Tensor)), None)

    def u32(a):
        if dev is not None and isinstance(a, (int, np.integer)):
            return int(a) & MASK32
        return torch.as_tensor(a, device=dev).to(torch.int64) & MASK32

    x = (mul_u32(u32(counter), GOLDEN) + u32(seed)) & MASK32
    return hash_mix(hash_mix(x) ^ GOLDEN)


_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
_TRIALS = _build.Kernel("bernoulli", "bernoulli_edges",
                        (_vp, _vp, _i64, _i64, _vp, ctypes.c_int, _vp))


def bernoulli_edges(weights: torch.Tensor, seeds) -> torch.Tensor:
    """One trial per (seed, edge) on the card:
    ``keep[b, e] = float32(counter_uniform_u32(seeds[b], e)) * 2^-32 <
    weights[e]``.

    ``weights`` is a contiguous (E,) float32 tensor on the card; ``seeds``
    an int or a 0-D tensor (-> (E,) bool) or a (B,) integer tensor (->
    (B, E) bool), taken mod 2^32.  One launch covers every seed.
    """
    if weights.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {weights.device}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if weights.dim() != 1 or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous 1-D tensor, got "
                         f"{tuple(weights.shape)}")
    e = weights.shape[0]
    if e > MASK32:
        raise ValueError("the counter hash needs at most 2^32 edges")
    one = not isinstance(seeds, torch.Tensor) or seeds.dim() == 0
    dev = weights.get_device()
    s = seeds
    if not (isinstance(s, torch.Tensor) and s.dtype == torch.int64
            and s.dim() == 1 and s.is_contiguous() and s.is_cuda
            and s.get_device() == dev):
        s = torch.as_tensor(s, device=weights.device)
        if s.is_floating_point() or s.dtype == torch.bool or s.dim() > 1:
            raise TypeError(f"seeds must be an int or a 1-D integer tensor, "
                            f"got {s.dtype} of shape {tuple(s.shape)}")
        s = s.reshape(-1).to(torch.int64).contiguous()
    keep = weights.new_empty((s.shape[0], e), dtype=torch.bool)
    err = _TRIALS(weights.data_ptr(), s.data_ptr(), s.shape[0], e,
                  keep.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, "bernoulli_edges")
    LAUNCHES["bernoulli_edges"] += 1
    return keep[0] if one else keep
