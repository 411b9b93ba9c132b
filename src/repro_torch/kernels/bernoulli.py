"""Counter-based uniform stream: the murmur3 fmix32 hash of
``repro.kernels.bernoulli`` (``hash_mix``, ``counter_uniform_u32``).

Bit-exact wherever it runs, so the plain sampler in torch and a CUDA
sampler give the same random numbers.  torch on the CPU lacks uint32
shifts and arithmetic, and ``>>`` on int32 sign-extends, so every value
here is an int64 tensor holding an unsigned 32-bit quantity, masked with
``& 0xFFFFFFFF`` after each step.  The 32x32-bit multiply is split into
16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import torch

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
    reference's ``astype(uint32)`` does.
    """
    dev = next((a.device for a in (counter, seed)
                if isinstance(a, torch.Tensor)), None)
    counter = torch.as_tensor(counter, device=dev).to(torch.int64) & MASK32
    seed = torch.as_tensor(seed, device=dev).to(torch.int64) & MASK32
    x = (mul_u32(counter, GOLDEN) + seed) & MASK32
    return hash_mix(hash_mix(x) ^ GOLDEN)
