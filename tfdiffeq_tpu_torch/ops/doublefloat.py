"""The float64 tier: `solve_df`, `odeint_df` and `odeint_adjoint_df`.

Counterpart of `tfdiffeq_tpu/ops/doublefloat.py`. The reference carries the
state and the time as double-floats (two float32 words, ~49 mantissa bits)
because its chip has no float64. An H100 computes float64 on its CUDA
cores, so here each of the three names is a native float64 solve, with the
reference's signatures and defaults (rtol 1e-8, atol 1e-10). The
double-float arithmetic itself (`two_sum`, `two_prod`, `df_*`) exists only
for a chip without float64 and has no counterpart.

Route: the plan route of the fused tier. The dynamics are captured once at
the caller's dtype (`ops/plan_bridge.build_plan`; a function that closes
over float32 weights cannot be traced on a float64 state, since
`torch.matmul` does not promote), their constants are packed in float64,
and the whole solve is one K2 launch in float64 with the plan's generated
right-hand side K14 (`fast.solve_fused` with its private `_dtype`). The
adjoint's forward is that launch and its backward one K3 sweep in float64
with the plan's reverse walk K15 (`fast.odeint_adjoint_fused`).
On a CPU tensor the kernels' plain versions run.

Dynamics outside the plan's subset warn, add 1 to `fast.fuse_fallbacks`
and run the port's generic engine in float64 (`solve`, `odeint_adjoint`),
which hands func float64 states and times. A func whose own tensors are
float32 then fails loudly in torch's dtype checks: cast them once with
`utils.device.cast_double`, or wrap a function of its parameters in
`utils.device.func_cast_double`. Nothing switches routes on a dtype error.

Everything runs in float64: the state, the times, the stages, the error
norm and the controller (dt underflow is status 2 below 4 eps span with
float64's eps). Results come back in y0's own floating dtype, and each
gradient in its tensor's dtype. Stats count the real evaluations of f
(the reference counts a primal and a JVP a stage).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import torch

from . import tableaus
from .plan_bridge import FusionError
from .pytree import tree_leaves, tree_unflatten
from ..solvers.base import SolveResult, SolverStats, Status
from ..utils.device import cast_double

Tensor = torch.Tensor

_F64 = torch.float64


def _check_method(method: str) -> None:
    if method not in tableaus.TABLEAUS_BY_NAME:
        raise ValueError(
            f"solve_df supports adaptive tableau methods "
            f"{sorted(tableaus.TABLEAUS_BY_NAME)}, got {method!r}")


def _times(t) -> Tensor:
    """The caller's times as a 1-D float64 host tensor (float32 times
    convert exactly)."""
    t = torch.as_tensor(t).detach().to("cpu", _F64)
    return t[None] if t.ndim == 0 else t


def _monotonic(t: Tensor) -> bool:
    d = t[1:] - t[:-1]
    return bool((d > 0).all()) or bool((d < 0).all())


def _like(ys, y0):
    """The trajectory nest ys with each leaf in the dtype of y0's leaf."""
    return tree_unflatten(y0, [y.to(l.dtype) for y, l in
                               zip(tree_leaves(ys), tree_leaves(y0))])


def _fallback(name: str, e: FusionError) -> None:
    from .. import fast
    fast.fuse_fallbacks += 1
    warnings.warn(f"{name}: dynamics outside the plan's subset ({e}); "
                  "running the generic engine in float64", stacklevel=3)


def solve_df(func: Callable, y0: Any, t, *, rtol=1e-8, atol=1e-10,
             method: str = "dopri5", max_num_steps: Optional[int] = None,
             first_step=None, safety: float = 0.9, ifactor: float = 10.0,
             dfactor: float = 0.2) -> SolveResult:
    """Integrate dy/dt = func(t, y) in float64 (reference
    `doublefloat.py:153`).

    The contract of `solve`, restricted to the adaptive tableau methods:
    y0 a tensor ([B, D], [D] or any shape) or a tuple/dict nest of them,
    t strictly monotonic in either direction. No attempt budget unless
    max_num_steps is given. One time returns y0 with zero stats; times that
    are not strictly monotonic return status 3 (INVALID_TIMES) with zeros
    beyond row 0. The trajectory comes back in y0's dtype; stats are host
    integers. See the module docstring for the route."""
    from .. import fast
    from ..odeint import solve

    _check_method(method)
    t64 = _times(t)
    leaves = tree_leaves(y0)
    if t64.shape[0] == 1:
        return SolveResult(tree_unflatten(y0, [l[None].clone()
                                               for l in leaves]),
                           SolverStats(0, 0, 0, 0))
    if not _monotonic(t64):
        zeros = []
        for l in leaves:
            z = l.new_zeros((t64.shape[0],) + tuple(l.shape))
            z[0] = l
            zeros.append(z)
        return SolveResult(tree_unflatten(y0, zeros),
                           SolverStats(0, 0, 0, int(Status.INVALID_TIMES)))
    try:
        adapted = fast.tree_state_adapter(func, y0)
        f, y_bd, rebuild = adapted if adapted is not None else (func, y0,
                                                                None)
        res = fast.solve_fused(
            f, y_bd, t64, rtol=rtol, atol=atol, method=method,
            max_num_steps=max_num_steps, first_step=first_step,
            safety=safety, ifactor=ifactor, dfactor=dfactor, _dtype=_F64)
        ys = res.ys if rebuild is None else rebuild(res.ys)
    except FusionError as e:
        _fallback("solve_df", e)
        opts = {"safety": safety, "ifactor": ifactor, "dfactor": dfactor}
        if max_num_steps is not None:
            opts["max_num_steps"] = max_num_steps
        if first_step is not None:
            opts["first_step"] = first_step
        res = solve(func, cast_double(y0), t64, rtol=rtol, atol=atol,
                    method=method, options=opts)
        ys = res.ys
    return SolveResult(_like(ys, y0), res.stats)


def odeint_df(func: Callable, y0: Any, t, *, rtol=1e-8, atol=1e-10,
              method: str = "dopri5", options: Optional[dict] = None) -> Any:
    """`odeint`-style front end of `solve_df` (reference
    `doublefloat.py:453`): the trajectory, with `options` taking
    max_num_steps and first_step only (anything else raises TypeError); a
    failed solve raises RuntimeError naming its status."""
    options = dict(options or {})
    max_num_steps = options.pop("max_num_steps", None)
    first_step = options.pop("first_step", None)
    if options:
        raise TypeError(f"Unknown solve_df options: {sorted(options)}")
    res = solve_df(func, y0, t, rtol=rtol, atol=atol, method=method,
                   max_num_steps=max_num_steps, first_step=first_step)
    if res.stats.status != Status.OK:
        raise RuntimeError(f"odeint_df failed with status "
                           f"{Status(res.stats.status).name}")
    return res.ys


def odeint_adjoint_df(func: Callable, y0: Any, t, *, params: Any = None,
                      rtol=1e-8, atol=1e-10, adjoint_rtol=None,
                      adjoint_atol=None, method: str = "dopri5",
                      adjoint_method: Optional[str] = None,
                      max_num_steps: Optional[int] = None,
                      first_step=None, return_stats: bool = False) -> Any:
    """O(1)-memory continuous-adjoint gradients in float64 (reference
    `doublefloat.py:338`).

    func(t, y, params) -> dy, or func(t, y) when params is None (an
    nn.Module's parameters, or the tensors func closes over, are then its
    constants). Differentiable with respect to y0, t and params; each
    gradient comes back in its tensor's dtype. The forward is one K2 launch
    and the backward one K3 sweep, both in float64 with the plan's
    right-hand side and reverse walk (`fast.odeint_adjoint_fused`); both
    sweeps take max_num_steps. A failed forward (or backward) makes every
    gradient NaN. Returns the trajectory in y0's dtype, with the forward
    SolverStats when return_stats. Dynamics outside the fused adjoint's
    subset warn, count in `fast.fuse_fallbacks` and take the generic
    `odeint_adjoint` in float64, with params cast by `cast_double`."""
    from .. import fast
    from ..adjoint import odeint_adjoint

    adjoint_method = method if adjoint_method is None else adjoint_method
    _check_method(method)
    _check_method(adjoint_method)
    t_in = t if isinstance(t, Tensor) else torch.as_tensor(t)
    if t_in.ndim == 0:
        t_in = t_in[None]
    if t_in.shape[0] < 2:
        ys = tree_unflatten(y0, [l[None] for l in tree_leaves(y0)])
        return (ys, SolverStats(0, 0, 0, 0)) if return_stats else ys
    if params is None:
        def user(tt, yy, pp):
            return func(tt, yy)
    else:
        user = func
    try:
        f3, y0f, rebuild = user, y0, None
        parts = fast.tree_state_parts(y0)
        if parts is not None:
            y0f, to_bd, from_bd, rebuild = parts

            def f3(tt, yy, pp):
                return to_bd(user(tt, from_bd(yy), pp))

        ys, stats = fast.odeint_adjoint_fused(
            f3, y0f, t_in, params=params if params is not None else (),
            rtol=rtol, atol=atol, adjoint_rtol=adjoint_rtol,
            adjoint_atol=adjoint_atol, method=method,
            adjoint_method=adjoint_method, max_num_steps=max_num_steps,
            first_step=first_step, return_stats=True, _dtype=_F64,
            _nan_on_failed_forward=True)
        if rebuild is not None:
            ys = rebuild(ys)
    except FusionError as e:
        _fallback("odeint_adjoint_df", e)
        fwd = {k: v for k, v in (("max_num_steps", max_num_steps),
                                 ("first_step", first_step))
               if v is not None}
        bwd = ({"max_num_steps": max_num_steps}
               if max_num_steps is not None else {})
        ys, stats = odeint_adjoint(
            func, cast_double(y0), t_in.to(_F64),
            params=None if params is None else cast_double(params),
            rtol=rtol, atol=atol, method=method, options=fwd,
            adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
            adjoint_method=adjoint_method, adjoint_options=bwd,
            return_stats=True, _nan_on_failed_forward=True)
    ys = _like(ys, y0)
    return (ys, stats) if return_stats else ys
