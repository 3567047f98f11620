"""Solver failures as exceptions.

Counterpart of `tfdiffeq_tpu/utils/debug.py`. The solvers report a failed
solve through `SolveResult.stats.status` rather than raising (the
reference's compiled loops cannot raise, and the port keeps its contract).
`raise_on_failure` turns a failed status into `SolverFailure`, with the
reference's message for each status. The reference's `checkify_solve`
moves the check into a jitted program with `jax.experimental.checkify`;
eager PyTorch has the status on the host once the solve returns, so here
it is a plain wrapper that raises.
"""

from __future__ import annotations

import functools

from ..solvers.base import SolveResult, Status


class SolverFailure(RuntimeError):
    def __init__(self, status: int, stats):
        self.status = Status(int(status))
        self.stats = stats
        super().__init__(
            f"ODE solve failed with status {self.status.name} "
            f"(nfe={int(stats.nfe)}, accepted={int(stats.n_accepted)}, "
            f"rejected={int(stats.n_rejected)}). "
            + {
                Status.MAX_STEPS_REACHED:
                    "Increase max_num_steps/max_steps or loosen tolerances.",
                Status.DT_UNDERFLOW:
                    "Step size collapsed — the dynamics likely produced "
                    "non-finite values or the problem is too stiff for an "
                    "explicit method at this tolerance.",
            }.get(self.status, ""))


def raise_on_failure(result: SolveResult) -> SolveResult:
    """Raise `SolverFailure` if the solve did not finish cleanly; else
    return the result."""
    status = int(result.stats.status)
    if status != int(Status.OK):
        raise SolverFailure(status, result.stats)
    return result


def checkify_solve(solve_fn):
    """Wrap a function returning a SolveResult so that a failed status
    raises `SolverFailure` (the reference's checkify wrapper)."""

    @functools.wraps(solve_fn)
    def checked(*args, **kwargs):
        return raise_on_failure(solve_fn(*args, **kwargs))

    return checked
