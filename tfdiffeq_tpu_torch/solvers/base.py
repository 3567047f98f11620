"""Problem canonicalization and solve results.

Counterpart of `tfdiffeq_tpu/solvers/base.py`. Reverse time is handled the
same way: the solver integrates in tau = sign * t, always increasing, with
g(tau, y) = sign * f(sign * tau, y). PyTorch runs eagerly, so `t` is always
concrete: it is validated here and a non-monotonic `t` raises. The
INVALID_TIMES status remains for the fused kernel, which checks the times
it is handed itself.

Times live on the host (the generic engine's controller runs there); the
state lives on the device of `y0`, and `func` receives its time as a 0-d
tensor on that device.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.pytree import flat_ode_func, flatten_state

Tensor = torch.Tensor


class Status(enum.IntEnum):
    OK = 0
    MAX_STEPS_REACHED = 1
    DT_UNDERFLOW = 2          # step size collapsed (usually non-finite f)
    INVALID_TIMES = 3         # non-increasing times reached the fused kernel


class SolverStats(NamedTuple):
    """Solver counters as host integers."""
    nfe: int              # number of func evaluations
    n_accepted: int       # accepted steps
    n_rejected: int       # rejected steps
    status: int           # Status code


class SolveResult(NamedTuple):
    ys: Any               # tensor [T, ...] or a nest of them
    stats: SolverStats


class CanonicalProblem(NamedTuple):
    func: Callable[[Tensor, Tensor], Tensor]   # g(tau, y_canon) -> dy_canon
    y0: Tensor            # canonical state: y0 itself for one tensor of
    #                       ndim >= 1, else the flat [N] vector of the nest
    tau: Tensor           # [T] increasing times, host, time dtype
    sign: Tensor          # 0-d host tensor, +1 or -1 (tau = sign * t)
    unravel: Callable[[Tensor], Any]
    dtype: torch.dtype    # state dtype
    time_dtype: torch.dtype
    native: bool = False  # y0 kept in its own shape


def _identity(x: Tensor) -> Tensor:
    return x


def canonicalize(func: Callable, y0: Any, t) -> CanonicalProblem:
    """Normalize (func, y0, t) into a forward-time problem over one
    canonical state tensor."""
    native = isinstance(y0, torch.Tensor) and y0.ndim >= 1
    if native:
        y_flat, unravel = y0, _identity
    else:
        y_flat, unravel = flatten_state(y0)
    if not (y_flat.is_floating_point() or y_flat.is_complex()):
        raise TypeError(f"y0 must have a floating or complex dtype, got "
                        f"{y_flat.dtype}")
    dtype = y_flat.dtype
    device = y_flat.device

    t = torch.as_tensor(t).detach().cpu()
    if t.ndim == 0:
        t = t[None]
    if t.ndim != 1:
        raise ValueError(f"t must be a 1-D tensor of times, got shape "
                         f"{tuple(t.shape)}")
    time_dtype = (t.dtype if t.is_floating_point()
                  else torch.empty((), dtype=dtype).real.dtype)
    t = t.to(time_dtype)
    if t.shape[0] > 1:
        d = np.diff(t.numpy())
        if not (np.all(d > 0) or np.all(d < 0)):
            raise ValueError("t must be strictly monotonic (increasing or "
                             f"decreasing); got {t.numpy()}")

    sign = torch.tensor(1.0 if t[-1] >= t[0] else -1.0, dtype=time_dtype)
    tau = sign * t

    if native:
        shape = y_flat.shape

        def f_flat(tt: Tensor, y: Tensor) -> Tensor:
            dy = func(tt, y)
            if dy.shape != shape:
                raise ValueError(
                    f"func(t, y) returned shape {tuple(dy.shape)}, expected "
                    f"the state shape {tuple(shape)}")
            return dy.to(dtype)
    else:
        f_flat = flat_ode_func(func, unravel, dtype)

    sign_y = sign.to(dtype)

    def g(s: Tensor, y: Tensor) -> Tensor:
        return sign_y * f_flat((sign * s).to(device), y)

    return CanonicalProblem(g, y_flat, tau, sign, unravel, dtype, time_dtype,
                            native)


#: Options accepted by the adaptive embedded-RK solvers (the reference's
#: list; odeint.py says which of them this package honours, ignores or
#: refuses).
ADAPTIVE_OPTIONS = frozenset({
    "first_step", "safety", "ifactor", "dfactor", "max_num_steps", "norm",
    "max_steps", "chunk_size", "loop", "pcoeff", "icoeff", "dt_min",
    "telemetry", "unroll", "dense_output", "fuse", "per_sample",
})


def check_options(options: Optional[dict], allowed: frozenset) -> dict:
    """Validate an options dict: unknown keys raise (the reference merely
    warns about unused ones)."""
    options = dict(options or {})
    unknown = set(options) - set(allowed)
    if unknown:
        raise TypeError(f"Unknown solver options: {sorted(unknown)}; "
                        f"allowed: {sorted(allowed)}")
    return options
