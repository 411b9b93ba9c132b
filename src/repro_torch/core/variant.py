"""The step of the problem variants' greedy (candidates, a budget, group
quotas): which node a step picks and what the pick spends.  The port's
own copy of the step of the reference's ``fused_variant`` scan
(``repro.core.coverage``), and the row-weighted store's weighted Occur and
row weights (its ``occur_weighted`` and ``row_weights``)."""
from __future__ import annotations

import torch


class VariantScan:
    """The variant greedy's state besides Occur and the cover, and its
    step: the one copy of the reference's ``fused_variant`` pick that the
    plain scan (``kernels/ref.py::greedy_flat_variant_ref``) and the
    store's bitset variant (``core/coverage.py::_select_bitset_variant``)
    both run, on the device of ``cand``, with no host read.  ``costs``
    None: no budget."""

    def __init__(self, n: int, cand: torch.Tensor,
                 costs: torch.Tensor | None, budget: float, n_group: int,
                 n_groups: int, group_quota: int):
        dev = cand.device
        self.n, self.n_group, self.n_groups = n, n_group, n_groups
        self.cand = cand.to(torch.bool)
        self.costs = costs
        self.budget = torch.tensor(budget, dtype=torch.float32, device=dev)
        self.spent = torch.zeros((), dtype=torch.float32, device=dev)
        # slot n_groups, and node slot n, take the no-pick steps' writes
        self.gbud = torch.full((n_groups + 1,), group_quota,
                               dtype=torch.int32, device=dev)
        self.picked = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        self.group_of = torch.arange(n, device=dev) // n_group

    def pick(self, occur: torch.Tensor):
        """The step's node ``u`` (n with no feasible node) and ``ok``, both
        0-d tensors: the first maximum of Occur (Occur 0 included) over the
        feasible nodes, or with costs of ``float32(Occur) / cost`` over the
        affordable ones of positive Occur."""
        n = self.n
        feas = (self.gbud[self.group_of] > 0) & self.cand & ~self.picked[:n]
        if self.costs is not None:
            feas = feas & (self.costs <= self.budget - self.spent) \
                & (occur > 0)
            score = torch.where(feas, occur.to(torch.float32) / self.costs,
                                float("-inf"))
            best = torch.argmax(score)
            ok = score[best] > float("-inf")
        else:
            masked = torch.where(feas, occur, -1)
            best = torch.argmax(masked)
            ok = masked[best] >= 0
        return torch.where(ok, best, n), ok

    def commit(self, u: torch.Tensor, ok: torch.Tensor) -> None:
        """Spend u's cost (float32, in step order) and one of its group's
        quota, and mark it picked; a step without a pick changes
        nothing."""
        if self.costs is not None:
            self.spent = self.spent + torch.where(
                ok, self.costs[u.clamp(max=self.n - 1)], 0.0)
        self.gbud[torch.where(ok, u // self.n_group, self.n_groups)] -= 1
        self.picked[u] = True


def row_weights(ids: torch.Tensor, valid: torch.Tensor, ew: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """(num_rows,) float32 row weights from the element weights: each
    row's largest valid element weight, floored at 0 (the reference's
    ``segment_max``; a row with no element gets 0)."""
    ew_l = torch.where(valid, ew, 0.0)
    return torch.zeros(num_rows, dtype=torch.float32,
                       device=ew.device).scatter_reduce_(
        0, ids.to(torch.int64).clamp(0, num_rows - 1), ew_l, "amax")


def weighted_occur(flat: torch.Tensor, valid: torch.Tensor,
                   ew: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32 weighted Occur: the float32 scatter-add of the valid
    elements' weights onto their nodes (the reference's
    ``occur_weighted``)."""
    return torch.zeros(n + 1, dtype=torch.float32, device=ew.device
                       ).index_add_(0, flat.to(torch.int64),
                                    torch.where(valid, ew, 0.0))[:n]
