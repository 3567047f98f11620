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
    telemetry: Any = None  # StepTelemetry (options={'telemetry': True})
    dense: Any = None      # DenseOutput (options={'dense_output': True},
    #                        fast.solve_fused(dense_output=True))
    # Per-sample SolverStats whose fields are [B] int tensors, from a
    # per-sample solve (`options={'per_sample': True}`, or
    # `fast.solve_mlp_spec(per_sample=True)`): every sample ran its own
    # step controller.
    lane_stats: Any = None


class DenseOutput(NamedTuple):
    """Per-accepted-step dense-output interpolants: evaluate the solution
    anywhere in [t[0], t[-1]] after the solve, and drive the interpolated
    adjoint (Daulbaev et al. 2020). The rows live in CANONICAL tau space
    (tau = sign * t, increasing; see canonicalize): row s is the step
    [t0s[s], t1s[s]] of size dts[s] with the polynomial
    (((c0 x + c1) x + c2) x + c3) x + c4 in x = (tau - t0s[s]) / dts[s].
    The generic engine keeps one row per accepted step (host times, the
    coefficients on the state's device); K2 keeps its buffer's S rows on
    the card, the unused ones with t1s = +inf."""
    t0s: Tensor      # [S] step start times (tau)
    t1s: Tensor      # [S] step end times (tau, non-decreasing)
    dts: Tensor      # [S] step sizes (> 0)
    coeffs: Tensor   # [S, 5, N] quartic/Hermite coefficients (flat state)
    sign: Tensor     # 0-d: tau = sign * t

    def eval_flat(self, t) -> Tensor:
        """The FLAT solution [N] at a 0-d time t, or [Q, N] at [Q] times
        (user time space): the first row whose t1 is not below tau
        (searchsorted, side='left'), clamped to the rows."""
        t = torch.as_tensor(t)
        tau = (self.sign * t).reshape(-1).to(self.t1s.device)
        rdt = torch.promote_types(tau.dtype, self.t1s.dtype)
        tau, t1s = tau.to(rdt), self.t1s.to(rdt)
        idx = torch.clamp(torch.searchsorted(t1s, tau, side="left"), 0,
                          t1s.shape[0] - 1)
        x = ((tau - self.t0s[idx]) / self.dts[idx])[:, None]
        dev = self.coeffs.device
        x = x.to(dev, self.coeffs.dtype)
        c = self.coeffs[idx.to(dev)]
        out = ((((c[:, 0] * x + c[:, 1]) * x + c[:, 2]) * x + c[:, 3]) * x
               + c[:, 4])
        return out if t.ndim else out[0]


class StepTelemetry(NamedTuple):
    """Per-attempt solver telemetry (options={'telemetry': True}): one
    entry per attempt taken, on the host."""
    t0: Tensor         # [A] attempt start times (tau space)
    dt: Tensor         # [A] attempted (clamped) step sizes
    accepted: Tensor   # [A] bool
    active: Tensor     # [A] bool: the attempt ran (all True here; the
    #                    reference's static budget leaves an inactive tail)


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
    user_func: Any = None  # the caller's func(t, y) (for grid_constructor)
    user_y0: Any = None    # the caller's y0


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
                            native, user_func=func, user_y0=y0)


#: Options accepted by the fixed-grid solvers (euler, midpoint, rk4,
#: rk4_38); 'fuse' is refused in odeint.py.
FIXED_GRID_OPTIONS = frozenset({"grid_constructor", "step_size",
                                "num_steps", "fuse"})

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


def hermite_interp_at(grid: Tensor, ys_grid: Tensor, fs_grid: Tensor,
                      ts: Tensor) -> Tensor:
    """Cubic-Hermite interpolation of a grid trajectory onto requested times
    (the reference's upgrade over linear output interpolation: O(h^4) from
    the node derivatives the steps already computed).

    grid: [G] increasing host times; ys_grid, fs_grid: [G, *state]; ts: [T]
    host times. Returns [T, *state] on the states' device.
    """
    idx = torch.clamp(torch.searchsorted(grid, ts, side="left"), 1,
                      grid.shape[0] - 1)
    t_lo = grid[idx - 1]
    h = grid[idx] - t_lo
    pos = h > 0
    x = torch.where(pos, (ts - t_lo) / torch.where(pos, h, torch.ones_like(h)),
                    torch.zeros_like(h))
    bshape = (ts.shape[0],) + (1,) * (ys_grid.ndim - 1)
    dev = ys_grid.device
    x = x.to(ys_grid.dtype).reshape(bshape).to(dev)
    h = h.to(ys_grid.dtype).reshape(bshape).to(dev)
    idx = idx.to(dev)
    y_lo, y_hi = ys_grid[idx - 1], ys_grid[idx]
    f_lo, f_hi = fs_grid[idx - 1], fs_grid[idx]
    x2 = x * x
    x3 = x2 * x
    h00 = 2 * x3 - 3 * x2 + 1
    h10 = x3 - 2 * x2 + x
    h01 = -2 * x3 + 3 * x2
    h11 = x3 - x2
    return h00 * y_lo + h10 * h * f_lo + h01 * y_hi + h11 * h * f_hi
