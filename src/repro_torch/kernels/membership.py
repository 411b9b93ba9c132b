"""CUDA wrappers of the RR-set membership scan and the padded store's
greedy (``csrc/membership.cu``).

``membership_rows`` replaces the Pallas kernel of the same name in
``repro.kernels.membership``; ``padded_greedy`` replaces it on its one
path, the reference's ``select_seeds_padded``, with all k steps of that
greedy in one cooperative launch (``ref.padded_greedy_ref`` is the plain
loop).  The wrappers take CUDA tensors only; ``kernels/ops.py`` routes CPU
tensors to ``ref.py``.  Each checks its inputs, calls its C entry point
through a :class:`_build.Kernel` with the card's index and the raw handle
of PyTorch's current stream of that card (:func:`_build.raw_stream`),
raises on a launch error and adds one to its entry in :data:`LAUNCHES`.

``u`` of ``membership_rows`` may be a Python int, which goes to the kernel
by value (no copy to the card), or a 0-d / 1-element integer tensor on the
rows' card, which the kernel reads from device memory, so a ``u`` that an
argmax left on the card costs no host sync.  ``padded_greedy`` reads
nothing back: a selection makes no host sync.  Its grid, a block of 512
threads on each SM, is ``greedy_flat``'s, so ``greedy.grid_barriers``
gives the floor of its time.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.greedy import device_index

# launches per kernel since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"membership_rows": 0, "padded_greedy": 0}

_vp, _i32, _i64, _int = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_int)
_MEMBERSHIP = _build.Kernel("membership", "membership_rows",
                            (_vp, _vp, _vp, _i32, _i64, _i64, _vp, _int,
                             _vp))
_GREEDY = _build.Kernel("membership", "padded_greedy",
                        (_vp, _vp, _i64, _i64, _i32, _i32, _vp, _vp, _int,
                         _vp))
_GREEDY_GRID = _build.Kernel("membership", "padded_greedy_grid",
                             (_int, ctypes.POINTER(_int)))


def _device_u(u, rows: torch.Tensor) -> torch.Tensor:
    """``u`` as a 1-element int32 tensor on the rows' card."""
    if u.device != rows.device:
        raise ValueError(f"u must lie on the rows' device {rows.device}, "
                         f"got {u.device}")
    if u.numel() != 1:
        raise ValueError(f"u must hold one value, got {tuple(u.shape)}")
    if u.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"u must be an integer tensor, got {u.dtype}")
    return u.reshape(1).to(torch.int32).contiguous()


def _check_rows(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Check the padded store's arrays; return the lengths as contiguous
    int32 (clamped to [0, L] first when they are int64)."""
    _build.check_words(rows, "rows")
    r, l = rows.shape
    if lengths.device != rows.device or lengths.shape != (r,):
        raise ValueError(f"lengths must be ({r},) on the rows' device, got "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lengths must be an integer tensor, got "
                        f"{lengths.dtype}")
    if lengths.dtype != torch.int32:
        lengths = lengths.clamp(0, l).to(torch.int32)
    return lengths.contiguous()


def membership_rows(rows: torch.Tensor, lengths: torch.Tensor,
                    u) -> torch.Tensor:
    """``hit[r] = any(rows[r, :lengths[r]] == u)`` on the card: (R, L)
    contiguous int32 rows, (R,) int32/int64 lengths -> (R,) bool."""
    lengths = _check_rows(rows, lengths)
    if isinstance(u, torch.Tensor):
        u_dev, u_value = _device_u(u, rows), 0
    else:
        u_dev, u_value = None, int(u)
        if not -(1 << 31) <= u_value < 1 << 31:
            raise ValueError(f"u must fit int32, got {u_value}")
    r, l = rows.shape
    hit = torch.empty(r, dtype=torch.bool, device=rows.device)
    dev = rows.get_device()
    err = _MEMBERSHIP(rows.data_ptr(), lengths.data_ptr(),
                      None if u_dev is None else u_dev.data_ptr(), u_value,
                      r, l, hit.data_ptr(), dev, _build.raw_stream(dev))
    _build.raise_on(err, "membership_rows")
    LAUNCHES["membership_rows"] += 1
    return hit


def greedy_grid(device) -> int:
    """The blocks of :func:`padded_greedy`'s grid on card ``device`` (a
    block of 512 threads on each SM); read from the card once."""
    return _greedy_grid(device_index(device))


@functools.cache
def _greedy_grid(index: int) -> int:
    blocks = _int(0)
    _build.raise_on(_GREEDY_GRID(index, ctypes.byref(blocks)),
                    "padded_greedy_grid")
    return blocks.value


def greedy_scratch_bytes(n: int, num_rows: int, blocks: int) -> int:
    """Scratch of one :func:`padded_greedy` launch: the blocks' records (8
    bytes a block), Occur (4 bytes a node) and the rows' covered flags (a
    byte each)."""
    return 8 * blocks + 4 * n + num_rows


def grid_barriers(k: int) -> int:
    """Grid barriers of one :func:`padded_greedy` launch of ``k`` steps:
    two in the prologue, one after each step's argmax and one after each
    step's scan but the last."""
    return 2 * k + 1


def padded_greedy(rows: torch.Tensor, lengths: torch.Tensor, *, n: int,
                  k: int):
    """``k`` steps of the padded store's greedy on the card: (R, L)
    contiguous int32 ``rows``, (R,) integer ``lengths`` -> ``(seeds (k,),
    gains (k,))`` int32, as ``ref.padded_greedy_ref``."""
    n, k = int(n), int(k)
    lengths = _check_rows(rows, lengths)
    if not 1 <= n < (1 << 31) - 1 or k < 1:
        raise ValueError(f"need 1 <= n < 2^31 - 1 and k >= 1, got n {n}, "
                         f"k {k}")
    r, l = rows.shape
    index = rows.get_device()
    blocks = _greedy_grid(index)
    scratch = torch.empty(greedy_scratch_bytes(n, r, blocks),
                          dtype=torch.uint8, device=rows.device)
    out = torch.empty(2 * k, dtype=torch.int32, device=rows.device)
    err = _GREEDY(rows.data_ptr(), lengths.data_ptr(), r, l, n, k,
                  scratch.data_ptr(), out.data_ptr(), index,
                  _build.raw_stream(index))
    _build.raise_on(err, "padded_greedy")
    LAUNCHES["padded_greedy"] += 1
    return out[:k], out[k:]
