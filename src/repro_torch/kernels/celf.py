"""CUDA wrappers of the CELF lazy greedy's exact evaluations
(``csrc/celf.cu``): :func:`celf_eval` scores a batch of candidates
against a packed Covered bitset, :func:`celf_apply` commits a seed into
it.  Neither replaces a Pallas kernel: the reference computes both in XLA
(``eval_batch`` and ``apply_seed`` of ``repro.core.coverage``).

Each computes what its plain version in ``kernels/ref.py`` computes
(``celf_eval_ref``, ``celf_apply_ref``), byte for byte.  The wrappers take
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to the plain
versions.  Each checks its inputs, allocates its output (and
:func:`celf_eval` the candidates' scratch bitmaps beside it, which the
entry point zeroes), launches through a :class:`_build.Kernel` on
PyTorch's current stream of the tensors' card (:func:`_build.raw_stream`),
raises on a launch error and adds one to its entry in :data:`LAUNCHES`.
Nothing is read back, so a call makes no host sync.

:func:`celf_eval` launches once for every :data:`MAX_CANDS` candidates
(once at any ``eval_batch`` up to 2,048).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"celf_eval": 0, "celf_apply": 0}

# csrc/celf.cu: kMaxCands, the candidates of one celf_eval launch
MAX_CANDS = 2048

_vp, _i32, _i64, _int = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_int)
_EVAL = _build.Kernel("celf", "celf_eval",
                      (_vp, _vp, _vp, _i64, _vp, _i64, _vp, _int, _vp, _int,
                       _vp))
_APPLY = _build.Kernel("celf", "celf_apply",
                       (_vp, _vp, _vp, _i64, _vp, _i64, _i32, _vp, _int, _vp))


def _check_pool(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                cov_words: torch.Tensor) -> None:
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    for t, name, dtype in ((flat, "flat", torch.int32),
                           (ids, "ids", torch.int32),
                           (valid, "valid", torch.bool)):
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape != flat.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and 1-D of flat's "
                             f"length {flat.shape[0]}, got {tuple(t.shape)}")
    if cov_words.device != dev or cov_words.dtype != torch.int32 or \
            cov_words.dim() != 1 or cov_words.shape[0] < 1 or \
            not cov_words.is_contiguous():
        raise ValueError(f"cov_words must be a contiguous non-empty 1-D int32 "
                         f"tensor on {dev}, got {tuple(cov_words.shape)} "
                         f"{cov_words.dtype} on {cov_words.device}")


def celf_eval(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
              cov_words: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Rows not in Covered that hold each candidate, on the card: (t,)
    int32 ``flat`` and ``ids`` and bool ``valid``, (num_rows/32,) int32
    ``cov_words``, (c,) int32/int64 ``cands`` -> (c,) int32."""
    _check_pool(flat, ids, valid, cov_words)
    if cands.device != flat.device or cands.dim() != 1 or \
            cands.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"cands must be a 1-D integer tensor on "
                         f"{flat.device}, got {tuple(cands.shape)} "
                         f"{cands.dtype} on {cands.device}")
    cands = cands.to(torch.int32).contiguous()
    c, nw = cands.shape[0], cov_words.shape[0]
    dev = flat.get_device()
    stream = _build.raw_stream(dev)
    outs = []
    for i0 in range(0, c, MAX_CANDS):
        part = cands[i0:i0 + MAX_CANDS]
        cc = part.shape[0]
        buf = torch.empty(cc * (1 + nw), dtype=torch.int32,
                          device=flat.device)
        err = _EVAL(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                    flat.shape[0], cov_words.data_ptr(), nw, part.data_ptr(),
                    cc, buf.data_ptr(), dev, stream)
        _build.raise_on(err, "celf_eval")
        LAUNCHES["celf_eval"] += 1
        outs.append(buf[:cc])
    if len(outs) == 1:
        return outs[0]
    return torch.cat(outs) if outs else cands.new_zeros(0)


def celf_apply(flat: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
               cov_words: torch.Tensor, u: int) -> torch.Tensor:
    """OR the rows that hold node ``u`` (a host int) into ``cov_words`` in
    place on the card -> the rows that were new, a 0-d int32 tensor."""
    _check_pool(flat, ids, valid, cov_words)
    u = int(u)
    if not -(1 << 31) <= u < 1 << 31:
        raise ValueError(f"u must fit int32, got {u}")
    gain = torch.empty(1, dtype=torch.int32, device=flat.device)
    dev = flat.get_device()
    err = _APPLY(flat.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                 flat.shape[0], cov_words.data_ptr(), cov_words.shape[0], u,
                 gain.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, "celf_apply")
    LAUNCHES["celf_apply"] += 1
    return gain[0]
