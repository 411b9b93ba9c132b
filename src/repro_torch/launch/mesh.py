"""The sampling mesh: the ranks of a ``torch.distributed`` process group
that share one RR pool (the reference's ``repro.launch.mesh``).

A :class:`SampleMesh` is what the sharded store, the sharded selections
and the ``queue_sharded`` engine need of the group: this rank's ``rank``
and device, the group's ``size`` and the axis name, and two collectives,
:meth:`SampleMesh.all_reduce` (sum) and :meth:`SampleMesh.broadcast`.
Nothing else crosses ranks: a gather is a zero-filled buffer that each
rank writes its block into and that is summed.  So the same code runs on
NCCL between cards, on gloo between CPU processes, and on gloo over CUDA
tensors, which lets two ranks share one card.

The group is the caller's: :func:`make_sample_mesh` wraps the default
group, which ``torch.distributed.init_process_group`` (or ``torchrun``)
has set up.  A mesh of size 1 is the same program as any other: the
solver takes the sharded protocol whenever it is given a mesh.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class SampleMesh:
    """This rank's view of the sampling group (see the module docstring).

    ``collectives`` counts the collectives issued through the mesh (the
    records of a selection read it before and after)."""

    def __init__(self, group, rank: int, size: int, axis: str, device):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.axis = axis
        self.device = resolve_device(device)
        self.collectives = 0

    @property
    def shape(self) -> tuple:
        return (self.size,)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self.collectives += 1
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        dist.broadcast(t, src=src, group=self.group)
        self.collectives += 1
        return t

    def gather_rows(self, block: torch.Tensor, rows: int) -> torch.Tensor:
        """The ranks' equal blocks of ``rows`` rows stacked in rank order:
        each rank writes its block into a zero-filled (size · rows, ...)
        buffer, which is summed."""
        out = torch.zeros((self.size * rows,) + tuple(block.shape[1:]),
                          dtype=block.dtype, device=block.device)
        out[self.rank * rows:(self.rank + 1) * rows] = block
        return self.all_reduce(out)


def local_card() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK`` (mod the cards) under a
    launcher that sets it, else the current card."""
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    count = torch.cuda.device_count()
    index = int(local) % count if local is not None else \
        torch.cuda.current_device()
    return torch.device("cuda", index)


def make_sample_mesh(spec=None, *, axis: str = "samples",
                     device="cuda") -> SampleMesh:
    """The mesh of the default process group from a ``--mesh`` style spec.

    ``spec``: ``None``/``""``/``0`` -> the whole group; an int (or int
    string) N, or ``"name:N"`` (N ranks on the axis ``name``): N must be
    the group's size.  ``device`` is this rank's device: ``"cuda"`` without
    an index takes ``cuda:LOCAL_RANK`` under a launcher that sets it, else
    the current card; ``"cpu"`` for gloo ranks on the CPU.  Raises when no
    process group is initialised."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_sample_mesh needs an initialised torch.distributed "
            "process group (torchrun, or init_process_group with its "
            "address, world size and rank)")
    size = dist.get_world_size()
    if spec not in (None, "", 0, "0"):
        s = str(spec)
        if ":" in s:
            axis, s = s.split(":", 1)
        want = int(s)
        if want != size:
            raise ValueError(f"mesh spec {spec!r} wants {want} ranks; the "
                             f"process group has {size}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = local_card()
    return SampleMesh(None, dist.get_rank(), size, axis, dev)
