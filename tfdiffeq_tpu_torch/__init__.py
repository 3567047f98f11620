"""tfdiffeq_tpu_torch — the PyTorch and CUDA port of tfdiffeq_tpu.

The JAX package `tfdiffeq_tpu` beside it is the reference: each module here
keeps the name of its counterpart there, and the tests hold the two to the
same numbers. This package imports `torch` and never `jax`.

Public surface: `odeint` and `solve` over the adaptive RK, fixed-grid,
Adams and hypersolver methods in `SOLVERS`, with `SolveResult`, `SolverStats` and `Status`; `odeint_adjoint`
for O(1)-memory gradients, with `NFEMeter` counting forward and backward
evaluations; the float64 tier `solve_df`, `odeint_df` and
`odeint_adjoint_df` (`ops/doublefloat.py`); the helpers `move_to_device`,
`cast_double`, `func_cast_double` (`utils/device.py`),
`plot_vector_field` and `plot_phase_portrait` (`utils/viz.py`). The fused tier (`tfdiffeq_tpu_torch.fast`) runs a whole MLP
neural-ODE solve, a whole adjoint backward sweep, a whole solve of the
ODE-Net's conv dynamics, and a continuous normalizing flow's density and
training (`fast.cnf_*`, with `models.cnf`), each as one hand-written CUDA
kernel on an NVIDIA Hopper card. `solve_fused` (and `odeint(...,
options={'fuse': True})`) captures arbitrary plain-PyTorch dynamics into a
plan and runs its generated CUDA right-hand side inside those kernels.
"""

from .adjoint import odeint_adjoint
from .odeint import SOLVERS, odeint, register_solver, solve
from .solvers.base import SolveResult, SolverStats, Status

# Register the Adams family and the hypersolvers into SOLVERS (import side
# effect, as in the reference).
from .solvers import fixed_adams as _fixed_adams  # noqa: F401,E402
from .solvers import adams as _adams  # noqa: F401,E402
from .solvers import hyper as _hyper  # noqa: F401,E402
from .ops.doublefloat import odeint_adjoint_df, odeint_df, solve_df
from .utils.device import cast_double, func_cast_double, move_to_device
from .utils.nfe import NFEMeter
from .utils.viz import plot_phase_portrait, plot_vector_field
from .fast import solve_fused  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "odeint",
    "odeint_adjoint",
    "odeint_adjoint_df",
    "odeint_df",
    "solve",
    "solve_df",
    "solve_fused",
    "register_solver",
    "SOLVERS",
    "SolveResult",
    "SolverStats",
    "Status",
    "NFEMeter",
    "move_to_device",
    "cast_double",
    "func_cast_double",
    "plot_phase_portrait",
    "plot_vector_field",
]
