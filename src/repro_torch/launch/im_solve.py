"""Distributed IM solve: the paper's pipeline over the ranks of a sampling
mesh (the reference's ``repro.launch.im_solve``).

Each rank samples its own block of every round (gIM's grid dimension ->
the mesh, DESIGN.md §4) with the ``queue_sharded`` engine, keeps those
rows as its shard of the pool, and takes part in the sharded selection of
DESIGN.md §5; every rank returns the same result.  Start it under
``torchrun`` (or any launcher that sets ``RANK``/``WORLD_SIZE`` and the
rendezvous address), one rank a card with NCCL::

    torchrun --nproc-per-node 4 -m repro_torch.launch.im_solve --mesh 4

or as gloo ranks, on the CPU (``--device cpu``) or sharing one card
(``--backend gloo``).  Without a launcher it runs one rank.  Under
``torchrun`` the graph's flags are ``--nodes`` and ``--edges-per-node``
(torchrun reads ``--n`` and ``--r`` as abbreviations of its own options).
"""
from __future__ import annotations

import argparse
import os
import socket
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import rrset
from repro_torch.core.engine import (RRBatch, ShardedBatch,
                                     _resolve_root_table, register_engine)
from repro_torch.core.imm import IMMSolver
from repro_torch.core.problem import IMProblem
from repro_torch.graph import csr, generators, weights
from repro_torch.kernels import ops
from repro_torch.launch.mesh import local_card, make_sample_mesh


@register_engine("queue_sharded")
class ShardedQueueEngine:
    """The queue engine over a sampling mesh: ``batch`` lanes a rank, so a
    round is ``mesh.size · batch`` rows, and rank d samples rows ``[d·b,
    (d+1)·b)`` of it (``queue_bfs`` with ``row0 = d·b``, one launch on a
    card).  Row r of round seed s is the row the plain ``queue`` engine
    samples as its lane r, so the round is the ``queue`` engine's round at
    batch ``mesh.size · batch``, exactly (the reference folds the device
    index into its key instead, so its rounds differ from its queue
    engine's).

    :meth:`sample` gathers the blocks into that round on every rank;
    :meth:`sample_sharded` leaves each rank its own block (a
    :class:`~repro_torch.core.engine.ShardedBatch`) and reduces only the
    lanes' overflow flags and the steps.  Either makes one host read a
    round: the ranks' widths and steps, summed into a (D, 2) tensor."""

    sharded = True

    @dataclass(frozen=True)
    class Config:
        batch: int = 128             # lanes a rank a round
        qcap: Optional[int] = None   # default: n_nodes
        ec: int = rrset.EC_DEFAULT

    def __init__(self, g_rev, config: Optional[Config] = None, mesh=None,
                 root_weights=None):
        self.g_rev = csr.coalesce_ic(g_rev)
        self.config = config if config is not None else self.Config()
        self.mesh = (mesh if mesh is not None
                     else make_sample_mesh(device=self.g_rev.device))
        if self.mesh.device != self.g_rev.device:
            raise ValueError(f"graph on {self.g_rev.device}, mesh rank on "
                             f"{self.mesh.device}")
        self.qcap = (self.config.qcap if self.config.qcap is not None
                     else self.g_rev.n_nodes)
        self.root_weights, self.table = _resolve_root_table(
            root_weights, self.g_rev.device)

    @property
    def item_space(self) -> int:
        return self.g_rev.n_nodes

    def _block(self, seed32: int):
        """This rank's block of the round, its width cut to the widest
        block's, the round's overflow flags and its steps."""
        g, cfg, mesh = self.g_rev, self.config, self.mesh
        b = cfg.batch
        queue, lengths, overflowed, steps, roots = ops.queue_bfs(
            g.offsets, g.indices, g.weights, seed32, b, qcap=self.qcap,
            ec=cfg.ec, table=self.table, dedup="none", row0=mesh.rank * b)
        st = torch.zeros(mesh.size, 2, dtype=torch.int64, device=g.device)
        if b:
            st[mesh.rank, 0] = lengths.max()
            st[mesh.rank, 1] = steps.max()
        width, n_steps = (int(x) for x in
                          mesh.all_reduce(st).max(dim=0).values.cpu())
        ovf = mesh.gather_rows(overflowed.to(torch.int32), b) != 0
        return queue[:, :max(width, 1)], lengths, roots, ovf, n_steps

    def sample(self, seed32: int) -> RRBatch:
        nodes, lengths, roots, ovf, steps = self._block(seed32)
        b, mesh = self.config.batch, self.mesh
        return RRBatch(mesh.gather_rows(nodes, b),
                       mesh.gather_rows(lengths, b), ovf, steps,
                       roots=mesh.gather_rows(roots, b))

    def sample_sharded(self, seed32: int) -> ShardedBatch:
        nodes, lengths, roots, ovf, steps = self._block(seed32)
        return ShardedBatch(nodes, lengths, ovf, steps, roots, self.mesh)


def solve(g, k: int | None = None, eps: float | None = None, *,
          batch_per_dev: int = 128, seed: int = 0, selection: str = "auto",
          eval_batch: int | None = None, mesh=None,
          problem: IMProblem | None = None):
    """Distributed IM solve of ``problem`` (or the plain ``(k, eps)``):
    the ``queue_sharded`` engine and the solver's pool on one mesh
    (``mesh=None``: the default process group's, on the graph's device),
    so each rank's rows stay where they were sampled.  Every rank returns
    ``(seeds, spread, stats)``, the same on every rank."""
    mesh = mesh if mesh is not None else make_sample_mesh(device=g.device)
    if problem is None:
        if k is None or eps is None:
            raise TypeError("solve() needs either problem= or the (k, eps) "
                            "pair")
        problem = IMProblem(k=k, eps=eps)
    if problem.t_rounds is not None:
        raise ValueError("the sharded queue engine samples the plain node "
                         "space; solve MRIM via IMMSolver(g).solve(problem)")
    engine = ShardedQueueEngine(
        csr.reverse(g), ShardedQueueEngine.Config(batch=batch_per_dev),
        mesh=mesh, root_weights=problem.node_weights)
    solver = IMMSolver(g, engine=engine, seed=seed, selection=selection,
                       eval_batch=eval_batch, mesh=mesh)
    res = solver.solve_problem(problem)
    stats = res.stats
    return res.seeds, res.spread, dict(
        theta=stats.theta, sampled=stats.n_rr_sampled,
        selection=stats.selection, variant=stats.variant,
        n_seeds=len(res.seeds), cost=res.cost, devices=mesh.size,
        mesh_shape=stats.mesh_shape, pool_sharding=stats.pool_sharding,
        per_device_pool_bytes=stats.per_device_pool_bytes)


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(backend: str, device: torch.device) -> None:
    """Join the launcher's group (``RANK``/``WORLD_SIZE`` in the
    environment), or start a group of one rank on a free local port."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # torchrun's parser takes --n and --r for abbreviations of its own
    # options: under it, spell them --nodes and --edges-per-node
    ap.add_argument("--n", "--nodes", type=int, default=2000)
    ap.add_argument("--r", "--edges-per-node", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eps", type=float, default=0.4)
    ap.add_argument("--batch", type=int, default=128,
                    help="queue lanes a rank a round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--selection", default="auto",
                    choices=("auto", "fused", "flat", "bitset",
                             "celf-sketch", "celf"),
                    help="seed-selection backend (DESIGN.md §3)")
    ap.add_argument("--eval-batch", type=int, default=None,
                    help="CELF exact-verification batch width")
    ap.add_argument("--mesh", default=None,
                    help="the group's size, or 'axis:N' (default: the "
                         "whole group)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="this rank's device (cuda: cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on cuda, gloo on cpu; gloo lets "
                         "ranks share a card")
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    dev = local_card() if args.device == "cuda" else torch.device("cpu")
    _init_group(backend, dev)
    try:
        mesh = make_sample_mesh(args.mesh, device=dev)
        src, dst = generators.barabasi_albert(args.n, args.r, seed=0)
        g = weights.wc_weights(csr.from_edges(src, dst, args.n, device=dev))
        t0 = time.time()
        seeds, est, stats = solve(
            g, args.k, args.eps, batch_per_dev=args.batch, seed=args.seed,
            selection=args.selection, eval_batch=args.eval_batch, mesh=mesh)
        if mesh.rank == 0:
            print(f"devices={stats['devices']} mesh={stats['pool_sharding']} "
                  f"pool_bytes/dev={stats['per_device_pool_bytes']} "
                  f"theta={stats['theta']} sampled={stats['sampled']} "
                  f"selection={stats['selection']} "
                  f"time={time.time() - t0:.2f}s", flush=True)
            print(f"seeds={sorted(seeds.tolist())} estimate={est:.1f}",
                  flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
