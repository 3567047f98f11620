"""Hypersolvers: fixed-grid solvers with a learned local-error correction,
`hyper_euler`, `hyper_midpoint` and `hyper_heun`.

Counterpart of `tfdiffeq_tpu/solvers/hyper.py` (Poli et al. 2020,
"Hypersolvers: Toward Fast Continuous-Depth Models"), with the same
arithmetic in the same order. Each step takes a base explicit step of
order p and adds a learned residual,

    y_{n+1} = y_n + dt * base(t_n, y_n) + (sign * dt)^(p+1) * g(t_n, y_n, f_n)

where the hypernet ``g(t, y, f) -> like y``, passed as
``options={'hypernet': g}``, approximates the base method's local
truncation error over dt^(p+1): euler (p = 1, one evaluation a step),
midpoint or heun (p = 2, two). The hypernet sees user time and the user's
derivative (t = sign * tau, f = sign * f_tau), so a net trained on
forward-time residuals serves either direction; the sign of the step
factor matters in reverse time, where (sign * dt)^(p+1) flips for odd
p + 1.

The walk is `solvers/fixed_grid.solve_fixed_grid` through its `step_fn`
hook: on the default grid the step ends are the outputs, on a finer one
(`num_steps`, `step_size`, `grid_constructor`) the outputs are
cubic-Hermite interpolated from the node states and derivatives, with one
more evaluation at the grid's end. NFE counts the dynamics' evaluations,
not the hypernet's. Training the hypernet is autograd through this walk;
the fused whole-solve kernel (`fast.solve_hyper`, K12) serves inference.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.pytree import flatten_state
from .base import CanonicalProblem, SolveResult
from .fixed_grid import build_grid_from_options, solve_fixed_grid

Tensor = torch.Tensor

#: kind -> (power p + 1 of the step factor, evaluations a step).
HYPER_KINDS = {"euler": (2, 1), "midpoint": (3, 2), "heun": (3, 2)}


def _wrap_hypernet(prob: CanonicalProblem, hypernet: Callable) -> Callable:
    """Lift a user-space hypernet g(t, y, f) -> like y to the flat tau-space
    state: inputs unravelled, the output flattened, time and derivative
    mapped back to user space."""
    unravel, sign, dtype = prob.unravel, prob.sign, prob.dtype
    device = prob.y0.device
    sign_y = sign.to(dtype)

    def g_flat(tau: Tensor, y_flat: Tensor, f_flat: Tensor) -> Tensor:
        t_user = (sign * tau).to(prob.time_dtype).to(device)
        out = hypernet(t_user, unravel(y_flat), unravel(sign_y * f_flat))
        if prob.native:
            out = torch.as_tensor(out)
            if out.shape != y_flat.shape:
                raise ValueError(
                    f"hypernet returned shape {tuple(out.shape)}, expected "
                    f"the state shape {tuple(y_flat.shape)}")
            return out.to(dtype)
        return flatten_state(out)[0].to(dtype)

    return g_flat


def _hyper_step(prob: CanonicalProblem, hypernet: Callable, kind: str):
    g = _wrap_hypernet(prob, hypernet)
    dtype = prob.dtype
    sign_y = prob.sign.to(dtype)
    power, n_evals = HYPER_KINDS[kind]

    def step(func, t0, dt, y):
        f0 = func(t0, y)
        dt_y = dt.to(dtype)
        if kind == "euler":
            base = f0
        elif kind == "midpoint":
            base = func(t0 + 0.5 * dt, y + 0.5 * dt_y * f0)
        else:                                        # heun
            k2 = func(t0 + dt, y + dt_y * f0)
            base = 0.5 * (f0 + k2)
        # The user-time step factor (sign dt)^(p+1) as repeated products.
        sdt = sign_y * dt_y
        sdt_p = sdt * sdt
        for _ in range(power - 2):
            sdt_p = sdt_p * sdt
        y1 = y + dt_y * base + sdt_p * g(t0, y, f0)
        return y1, f0, n_evals

    return step


def _make(kind: str):
    def impl(prob: CanonicalProblem, options: dict, rtol, atol
             ) -> SolveResult:
        hypernet = options.get("hypernet")
        if hypernet is None:
            raise ValueError(
                f"method 'hyper_{kind}' requires options={{'hypernet': g}} "
                "with g(t, y, f) -> a tensor (or nest) like y")
        grid = build_grid_from_options(prob.tau * prob.sign, options, prob)
        return solve_fixed_grid(prob, None, grid=grid,
                                step_fn=_hyper_step(prob, hypernet, kind))

    return impl


from ..odeint import register_solver  # noqa: E402

HYPER_OPTIONS = {"hypernet", "step_size", "num_steps", "grid_constructor",
                 "fuse"}
for _kind in HYPER_KINDS:
    register_solver(f"hyper_{_kind}", "custom", _make(_kind),
                    allowed=HYPER_OPTIONS)
