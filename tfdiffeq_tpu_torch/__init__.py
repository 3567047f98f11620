"""tfdiffeq_tpu_torch — the PyTorch and CUDA port of tfdiffeq_tpu.

The JAX package `tfdiffeq_tpu` beside it is the reference: each module here
keeps the name of its counterpart there, and the tests hold the two to the
same numbers. This package imports `torch` and never `jax`.

Public surface: `odeint` and `solve` over the adaptive RK methods in
`SOLVERS`, with `SolveResult`, `SolverStats` and `Status`. The fused tier
(`tfdiffeq_tpu_torch.fast`) runs a whole MLP neural-ODE solve as one
hand-written CUDA kernel on an NVIDIA Hopper card.
"""

from .odeint import SOLVERS, odeint, register_solver, solve
from .solvers.base import SolveResult, SolverStats, Status

__version__ = "0.1.0"

__all__ = [
    "odeint",
    "register_solver",
    "solve",
    "SOLVERS",
    "SolveResult",
    "SolverStats",
    "Status",
]
