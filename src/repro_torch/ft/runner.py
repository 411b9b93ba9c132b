"""Resilient IM solve: restart-from-checkpoint around ``IMMSolver``
(the reference's ``repro.ft.runner``, on the port).

This is the process-level recovery layer above ``FaultPolicy`` (which
retries *within* a solver).  When a solve dies anyway — retries exhausted,
or a non-transient error the policy refuses to absorb would in production
be a process crash — each attempt plays the restarted process: build a
fresh solver, ``restore_pool`` from the latest durable checkpoint, and re-enter
``solve``, which resumes from the saved round watermark (and, for
eps-driven problems, the saved LB-loop position) instead of resampling.
The conformance contract is that the final result is bit-identical to an
uninterrupted solve; tests/test_torch_faults.py drives this with
injected faults, and tests/test_torch_ckpt.py restores in a new process.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.ft.failures import is_transient


@dataclass
class SolveReport:
    """What resilient_solve did: restarts taken, the checkpoint step
    each restart resumed from (None = cold start), and the in-solver retry
    total summed over every attempt's fault policy."""
    restarts: int = 0
    resumed_steps: list = field(default_factory=list)
    policy_retries: int = 0
    completed: bool = False


def resilient_solve(make_solver: Callable, problem, ckpt_dir: str, *,
                    max_restarts: int = 3,
                    deadline_s: Optional[float] = None):
    """Run ``solve(problem)`` to completion across simulated process
    restarts.

    ``make_solver`` is a zero-arg factory returning a *fresh*, identically
    configured ``IMMSolver`` (same options/seed, ``checkpoint_dir`` +
    ``checkpoint_every`` pointed at ``ckpt_dir`` so progress is durable) —
    called once per attempt, exactly like a restarted process would
    construct it.  Transient failures (``is_transient``) consume a restart
    and resume from the latest checkpoint under ``ckpt_dir``; anything
    else propagates immediately.  Returns ``(IMResult, SolveReport)``.
    """
    report = SolveReport()
    attempt = 0
    while True:
        solver = make_solver()
        step = ckpt_mod.latest_step(ckpt_dir)
        if step is not None:
            solver.restore_pool(ckpt_dir, step=step)
        report.resumed_steps.append(step)
        try:
            result = solver.solve_problem(problem, deadline_s=deadline_s)
        except BaseException as e:
            if solver.fault_policy is not None:
                report.policy_retries += solver.fault_policy.retries
            if not is_transient(e) or attempt >= max_restarts:
                raise
            attempt += 1
            report.restarts += 1
            continue
        if solver.fault_policy is not None:
            report.policy_retries += solver.fault_policy.retries
        report.completed = True
        return result, report
