"""O(1)-memory gradients via the continuous adjoint ODE.

Counterpart of `tfdiffeq_tpu/adjoint.py` (`odeint_adjoint`) for adaptive
and fixed-grid forward and adjoint methods in the 'resets' mode: a
`torch.autograd.Function` whose forward solves without a tape and whose
backward integrates the augmented system (y, a_y, a_params, a_t) backward
over each observation interval with the generic engine, resetting y to the
stored forward state
and injecting the output cotangent at every observation time. The
augmented right-hand side takes the dynamics' VJP with
`torch.autograd.grad` under `torch.enable_grad()`. Time gradients follow
the reference: each observation time gets <f(t_i, y_i), g_i>, t_0 the
integrated a_t.

Parameters: `func(t, y, params)` with an explicit `params` nest of tensors
(the reference's signature), or an `nn.Module` `func(t, y)` whose
parameters that require grad are the adjoint parameters (torchdiffeq's
idiom), or a plain `func(t, y)` without parameters.

Fixed-grid methods follow the reference's contracts. A fixed forward
method's `step_size` becomes the equivalent `num_steps` over [t0, t_end].
A fixed adjoint method solves each observation interval with the backward
options filtered to `num_steps` (steps per interval; the default grid, one
step, when absent), or, given `adjoint_options={'step_size': h}`, walks
ceil(span_i / h) steps over each interval in one chained sweep
(`_bwd_fixed_grid_walk`). Adaptive adjoint methods ignore `step_size`.

`options={'fuse': True}` follows the reference's tiers
(`tfdiffeq_tpu/adjoint.py:300-410`). Tier 1, when the options map onto the
kernels: `fast.odeint_adjoint_fused`, the forward one launch with the
plan's right-hand side (K14) and the backward one sweep with its reverse
walk (K15); a tuple or dict state rides it through
`fast.tree_state_parts`, and `per_sample` gives every sample its own
controller in both sweeps. Dynamics outside the fused adjoint's subset (a
FusionError) warn, add 1 to `fast.fuse_fallbacks` and fall to tier 2: the
fused forward (`odeint(options={'fuse': True})`, itself counted when it
falls back) with the generic backward; with `per_sample`, the generic
adjoint a sample at a time instead (the reference's vmap). Without `fuse`,
`per_sample` reaches the forward solve only.

`adjoint_mode='interpolated'` (Daulbaev et al. 2020; reference
`adjoint.py:185-264`, `:404-663`): the forward keeps every accepted step's
interpolant (`solve(options={'dense_output': True})`, or with `fuse` K2's
emission through `fast.solve_fused(dense_output=True)`, tier 1 skipped as
in the reference), and the backward integrates (a_y, a_params, a_t) alone
with y(s) = dense.eval_flat(s), detached, instead of re-solving y; the
seminorm then covers a_y only. It needs an adaptive forward method (a
fixed-grid adjoint method takes `num_steps`, not `step_size`), and a
`forward_solver` that returns (ys, stats, DenseOutput) and says so with
`emits_dense = True`. With `per_sample` it raises ValueError: the
reference silently runs the resets backward there (generic) or drops
per_sample from the fused forward (ROADMAP.md queue 3, known faults in the
reference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .odeint import _CUSTOM_ALLOWED, SOLVERS, solve
from .ops.norms import rms_norm
from .ops.pytree import (flat_ode_func, flatten_state, tree_leaves,
                         tree_unflatten)
from .ops.rk import kahan_add, runge_kutta_step
from .solvers.base import ADAPTIVE_OPTIONS, SolverStats, Status
from .solvers.fixed_grid import steps_for_size
from .utils.nfe import emit_bwd, emit_fwd

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _BackwardWalk:
    """Per-interval backward grid of a fixed-grid adjoint with step_size.

    Steps walk time backward (t0s[j] > t1s[j]); `reset[j]` marks the first
    step of an observation interval, where y is reset to the stored forward
    value ys[obs[j]] and the cotangent g[obs[j]] joins the adjoint.
    """
    t0s: tuple
    t1s: tuple
    reset: tuple
    obs: tuple


def _build_backward_walk(t_np: np.ndarray, step_size: float) -> _BackwardWalk:
    t0s, t1s, reset, obs = [], [], [], []
    for i in range(t_np.shape[0] - 1, 0, -1):
        n = steps_for_size(abs(float(t_np[i] - t_np[i - 1])), step_size)
        seg = np.linspace(t_np[i], t_np[i - 1], n + 1)
        for j in range(n):
            t0s.append(float(seg[j]))
            t1s.append(float(seg[j + 1]))
            reset.append(j == 0)
            obs.append(i)
    return _BackwardWalk(tuple(t0s), tuple(t1s), tuple(reset), tuple(obs))


def _kind(method) -> str:
    return SOLVERS.get(method, ("",))[0]


#: Options tier 1 of `fuse` carries to the fused kernels (reference
#: adjoint.py:306-307).
_FULL_FUSE_OPTS = frozenset({"first_step", "max_num_steps", "loop",
                             "per_sample"})
_FULL_FUSE_FIXED_OPTS = frozenset({"num_steps", "step_size"})


class _Adjoint(torch.autograd.Function):
    """ys = odeint(func, y0, t) with adjoint gradients wrt y0, t and the
    parameter leaves. `cfg` carries the callables and options, and
    receives the forward stats."""

    @staticmethod
    def forward(ctx, cfg, y0, t, *leaves):
        dense = None
        if cfg["forward_solver"] is not None:
            ys, stats, *rest = cfg["forward_solver"](
                y0, t, cfg["params_of"](leaves))
            stats = SolverStats(*[int(s) for s in stats])
            dense = rest[0] if rest else None
        else:
            res = _forward_solve(cfg, y0, t, leaves)
            ys, stats, dense = res.ys, res.stats, res.dense
        emit_fwd(cfg["nfe_meter"], stats.nfe, stats.n_accepted)
        if stats.status != 0 and not cfg["nan_on_failed_forward"]:
            raise RuntimeError(
                f"odeint_adjoint forward solve failed with status "
                f"{Status(stats.status).name}; raise "
                "options['max_num_steps'] or loosen tolerances")
        cfg["stats"] = stats
        ctx.cfg = cfg
        ctx.dense = dense if cfg["interpolated"] else None
        ctx.save_for_backward(ys, t, *leaves)
        return ys

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        ys, t, *leaves = ctx.saved_tensors
        if cfg["stats"].status != 0:
            # nan_on_failed_forward: no backward solve from a trajectory
            # that stops short.
            return (None, *[torch.full_like(x, float("nan"))
                            for x in (ys[0], t, *leaves)])
        T = t.shape[0]
        if T < 2:
            return (None, g[0], torch.zeros_like(t),
                    *[torch.zeros_like(p) for p in leaves])
        shape = ys.shape[1:]
        ys_flat = ys.reshape(T, -1)
        g_flat = g.reshape(T, -1)
        ydtype, dev = ys_flat.dtype, ys_flat.device
        call, grad_targets = cfg["call"], cfg["grad_targets"]

        def f_flat(tt, y_flat, ls):
            return call(tt, y_flat.reshape(shape), ls).reshape(-1).to(ydtype)

        def aug_dynamics(s, aug):
            y, a_y, _, _ = aug
            with torch.enable_grad():
                y_ = y.detach().requires_grad_(True)
                s_ = s.detach().requires_grad_(True)
                ls = grad_targets(leaves)
                dy = f_flat(s_, y_, ls)
                vjp = torch.autograd.grad(dy, [y_, s_, *ls], grad_outputs=a_y,
                                          allow_unused=True)
            v_y, v_t, *v_p = [v if v is not None else torch.zeros_like(x)
                              for v, x in zip(vjp, [y_, s_, *ls])]
            return (dy.detach(), -v_y, tuple(-v for v in v_p), -v_t)

        dense = ctx.dense

        def aug_interp(s, aug):
            # y(s) from the forward's interpolants, not re-solved.
            a_y, _, _ = aug
            y = dense.eval_flat(s).detach().to(dev, ydtype)
            _, *v = aug_dynamics(s, (y, a_y, None, None))
            return tuple(v)

        if cfg["walk"] is not None:
            a_y, ts_bar, a_p, b_nfe, b_acc = _bwd_fixed_grid_walk(
                cfg["walk"], SOLVERS[cfg["adjoint_method"]][1], aug_dynamics,
                f_flat, leaves, ys_flat, g_flat, t.detach())
            emit_bwd(cfg["nfe_meter"], b_nfe, b_acc)
            return (None, a_y.reshape(shape), ts_bar.to(t.device), *a_p)

        a_y = g_flat[-1]
        a_p = tuple(torch.zeros_like(p) for p in leaves)
        a_t0 = torch.zeros((), dtype=t.dtype, device=dev)
        t_d = t.detach()
        rev_t_bars = []
        b_nfe = b_acc = 0
        failed = False
        for i in range(T - 1, 0, -1):
            # d loss / d t_i = <f(t_i, y_i), g_i>.
            f_i = f_flat(t_d[i].to(dev), ys_flat[i], leaves)
            t_bar = torch.dot(f_i, g_flat[i]).to(t.dtype)
            a_t0 = a_t0 - t_bar
            if dense is not None:
                fn, aug0 = aug_interp, (a_y, a_p, a_t0)
            else:
                fn, aug0 = aug_dynamics, (ys_flat[i], a_y, a_p, a_t0)
            res = solve(fn, aug0, torch.stack([t_d[i], t_d[i - 1]]),
                        rtol=cfg["adjoint_rtol"], atol=cfg["adjoint_atol"],
                        method=cfg["adjoint_method"],
                        options=cfg["bwd_options"])
            *_, a_y, a_p, a_t0 = (x[-1] if isinstance(x, Tensor)
                                  else tuple(l[-1] for l in x)
                                  for x in res.ys)
            a_y = a_y + g_flat[i - 1]
            b_nfe += res.stats.nfe + 1               # +1: the t_bar eval
            b_acc += res.stats.n_accepted
            failed = failed or res.stats.status != 0
            rev_t_bars.append(t_bar)
        emit_bwd(cfg["nfe_meter"], b_nfe, b_acc)
        ts_bar = torch.stack([a_t0] + rev_t_bars[::-1]).to(t.device)
        grads = [a_y.reshape(shape), ts_bar, *a_p]
        if failed:
            # A backward solve that did not reach its end would return a
            # partial adjoint: poison every gradient (the reference poisons
            # them on a failed solve, adjoint.py:483-493).
            grads = [torch.full_like(x, float("nan")) for x in grads]
        return (None, *grads)


def _bwd_fixed_grid_walk(walk: _BackwardWalk, tableau, aug_dynamics, f_flat,
                         leaves, ys_flat, g_flat, t):
    """The backward walk of a fixed-grid adjoint with step_size: one chained
    sweep over the concatenated per-interval grids (reference
    `adjoint.py:_bwd_fixed_grid_walk`). The first step of each interval
    resets y to ys[i], injects g[i] into a_y and -<f(t_i, y_i), g_i> into
    a_t, and re-evaluates the stage-0 derivative; every other step takes
    the chained end derivative of the one before. Kahan accumulation, as in
    the forward grid walk.

    Returns (dL/dy0 [N], ts_bar [T], parameter cotangents, backward NFE =
    steps * stages + resets + T, steps).
    """
    T = t.shape[0]
    dev, N = ys_flat.device, ys_flat.shape[1]
    # d loss / d t_i = <f(t_i, y_i), g_i> for every i (i = 0's comes from
    # the integrated a_t quadrature instead).
    t_bars = torch.stack([torch.dot(f_flat(t[i].to(dev), ys_flat[i], leaves),
                                    g_flat[i]) for i in range(T)]).to(t.dtype)
    aug0 = (torch.zeros_like(ys_flat[0]), torch.zeros_like(g_flat[0]),
            tuple(torch.zeros_like(p) for p in leaves),
            torch.zeros((), dtype=t.dtype, device=dev))
    aug, unravel_aug = flatten_state(aug0)
    M = aug.shape[0]
    flat = flat_ode_func(aug_dynamics, unravel_aug, aug.dtype)

    def aug_f(s, a):
        return flat(s.to(dev), a)

    comp = f_prev = None
    for t0, t1, reset, oi in zip(
            torch.tensor(walk.t0s, dtype=t.dtype),
            torch.tensor(walk.t1s, dtype=t.dtype), walk.reset, walk.obs):
        if reset:
            aug = aug.clone()
            aug[0:N] = ys_flat[oi].to(aug.dtype)
            aug[N:2 * N] += g_flat[oi].to(aug.dtype)
            aug[M - 1] += (-t_bars[oi]).to(aug.dtype)
            # The reset replaces state: the compensation term is void, and
            # the stage-0 derivative is evaluated afresh.
            comp = torch.zeros_like(aug)
            f_prev = aug_f(t0, aug)
        res = runge_kutta_step(aug_f, aug, f_prev, t0, t1 - t0, tableau)
        aug, comp = kahan_add(aug, comp, res.delta)
        f_prev = res.f1
    _, a_y, a_p, a_t = unravel_aug(aug)
    ts_bar = torch.cat([a_t.reshape(1).to(t.dtype), t_bars[1:]])
    S = len(walk.t0s)
    b_nfe = S * tableau.stages + int(sum(walk.reset)) + T
    return a_y + g_flat[0], ts_bar, a_p, b_nfe, S


def odeint_adjoint(func: Callable, y0: Any, t, *, params: Any = None,
                   rtol=1e-7, atol=1e-9, method: Optional[str] = None,
                   options: Optional[dict] = None, adjoint_rtol=None,
                   adjoint_atol=None, adjoint_method: Optional[str] = None,
                   adjoint_options: Optional[dict] = None,
                   adjoint_seminorm: bool = False,
                   adjoint_mode: str = "resets",
                   return_stats: bool = False, nfe_meter=None,
                   forward_solver: Optional[Callable] = None,
                   _nan_on_failed_forward: bool = False) -> Any:
    """Like `odeint`, but gradients use the augmented adjoint ODE.

    func: `func(t, y, params)` when `params` (a nest of tensors) is given;
    else `func(t, y)`, and when func is an `nn.Module` its parameters that
    require grad get gradients. y0 is a tensor or a tuple/dict nest.
    Returns the trajectory (leaves [T, ...]); with `return_stats=True`,
    `(trajectory, SolverStats)` of the FORWARD solve.

    adjoint_rtol/atol/method default to the forward ones; adjoint_options
    to the forward options, filtered to the adjoint method's allowlist
    (`num_steps` alone for a fixed-grid method; see the module docstring
    for `step_size`).
    adjoint_seminorm: control the backward step size on (y, a_y) only
    (Kidger et al. 2020). nfe_meter: an `NFEMeter` that records the
    forward and backward solves. forward_solver(y0, t, params) -> (ys,
    stats) replaces the internal forward solve (it must integrate the same
    dynamics). A failed forward solve raises RuntimeError; a failed
    backward solve returns NaN gradients.
    """
    method = method or "dopri5"
    adjoint_rtol = rtol if adjoint_rtol is None else adjoint_rtol
    adjoint_atol = atol if adjoint_atol is None else adjoint_atol
    adjoint_method = method if adjoint_method is None else adjoint_method

    fwd_options = dict(options or {})
    bwd_options = dict(adjoint_options if adjoint_options is not None
                       else fwd_options)
    use_fuse = bool(fwd_options.get("fuse", False))
    per_sample = bool(fwd_options.get("per_sample", False))
    bwd_options.pop("per_sample", None)
    if (fwd_options.get("dot_precision", "highest") != "highest"
            or bwd_options.get("dot_precision", "highest") != "highest"):
        # Reduced-precision tiers are serving-only: training would
        # differentiate a different model than the weights being trained.
        raise ValueError(
            "odeint_adjoint does not support reduced dot_precision "
            "('mixed'/'bf16' are serving tiers); train at the default "
            "'highest' and apply the precision tier at inference")
    for o in (fwd_options, bwd_options):
        o.pop("dot_precision", None)
        o.pop("fuse", None)
    if adjoint_mode not in ("resets", "interpolated"):
        raise ValueError(f"adjoint_mode must be 'resets' or 'interpolated',"
                         f" got {adjoint_mode!r}")
    interpolated = adjoint_mode == "interpolated"
    if use_fuse and not interpolated:
        # Tier 2's forward is the fused solve (`odeint`'s own fallback);
        # the interpolated one's is `_forward_solve`'s.
        fwd_options["fuse"] = True
    if (forward_solver is not None and interpolated
            and not getattr(forward_solver, "emits_dense", False)):
        raise ValueError(
            "forward_solver cannot be combined with "
            "adjoint_mode='interpolated' unless it returns per-step "
            "interpolants — (ys, stats, DenseOutput) with an "
            "`emits_dense = True` attribute (fast.solve_fused with "
            "dense_output=True provides this via options={'fuse': True})")
    if forward_solver is not None and options:
        raise ValueError(
            "options are ignored when forward_solver replaces the internal "
            "forward solve — configure the forward through the solver "
            "callable itself (adjoint_options still control the backward)")
    if interpolated and _kind(method) != "adaptive":
        raise ValueError("adjoint_mode='interpolated' needs the forward "
                         "dense-output interpolants, which only adaptive "
                         "methods emit; use an adaptive forward method or "
                         "adjoint_mode='resets'")
    if interpolated and per_sample:
        raise ValueError(
            "adjoint_mode='interpolated' with per_sample is unsupported: "
            "per-sample steps have no shared interpolant sequence (the "
            "reference runs the resets backward instead, or drops "
            "per_sample from its fused forward)")
    # The forward's telemetry is not returned (the reference drops it on
    # its while loop); the interpolated backward needs the dense output.
    fwd_options.pop("telemetry", None)
    if interpolated:
        fwd_options.pop("loop", None)
        fwd_options["dense_output"] = True
    t_np = torch.as_tensor(t).detach().cpu().to(torch.float64).reshape(-1) \
        .numpy()
    if (_kind(method) == "fixed" and fwd_options.get("step_size") is not None
            and "num_steps" not in fwd_options and t_np.shape[0] > 1):
        # The reference resolves a fixed forward's step_size to the
        # num_steps of the same uniform grid over [t0, t_end].
        fwd_options["num_steps"] = steps_for_size(
            abs(float(t_np[-1] - t_np[0])), fwd_options.pop("step_size"))
    # The backward solves each observation interval on its own: a grid
    # constructor cannot apply, and step_size becomes the per-interval walk
    # of a fixed adjoint method; other adjoint methods ignore it.
    bwd_options.pop("grid_constructor", None)
    step_size = bwd_options.pop("step_size", None)
    adj_kind = _kind(adjoint_method)
    if (interpolated and adj_kind == "fixed" and step_size is not None
            and "num_steps" not in bwd_options):
        raise ValueError(
            "adjoint_mode='interpolated' with a fixed-grid adjoint method "
            "derives its backward grid from num_steps; pass "
            "adjoint_options={'num_steps': n} (the per-interval walk that "
            "step_size builds integrates y as part of the augmented state, "
            "which 'interpolated' replaces)")
    walk = None
    if step_size is not None and "num_steps" not in bwd_options \
            and adj_kind == "fixed" and t_np.shape[0] > 1:
        walk = _build_backward_walk(t_np, float(step_size))
    if adj_kind == "fixed":
        allowed = {"num_steps"}
    else:
        allowed = _CUSTOM_ALLOWED.get(adjoint_method,
                                      ADAPTIVE_OPTIONS - {"telemetry",
                                                          "dense_output"})
    bwd_options = {k: v for k, v in bwd_options.items() if k in allowed}

    if use_fuse and forward_solver is None and not interpolated:
        out = _fused_tiers(func, params, y0, t, rtol, atol, method,
                           adjoint_rtol, adjoint_atol, adjoint_method,
                           adjoint_seminorm, fwd_options, bwd_options, walk,
                           per_sample, return_stats, nfe_meter)
        if out is not None:
            return out

    # Parameters: an explicit nest, a module's own, or none.
    if params is not None:
        leaves = tree_leaves(params)

        def params_of(ls):
            return tree_unflatten(params, ls)

        def call(tt, yy, ls):
            return func(tt, yy, params_of(ls))

        def grad_targets(ls):
            return [p.detach().requires_grad_(True) for p in ls]
    else:
        leaves = ([p for p in func.parameters() if p.requires_grad]
                  if isinstance(func, torch.nn.Module) else [])

        def params_of(ls):
            return None

        def call(tt, yy, ls):
            return func(tt, yy)

        def grad_targets(ls):
            return list(ls)     # the module's own parameters

    # Nests ride as one flat state (the reference's flatten_state).
    nest = not isinstance(y0, Tensor)
    if nest:
        y0_in, unravel = flatten_state(y0)
        nest_call = call

        def call(tt, yy, ls):
            dy = nest_call(tt, unravel(yy), ls)
            return torch.cat([l.reshape(-1).to(yy.dtype)
                              for l in tree_leaves(dy)])
    else:
        y0_in = y0
    N = y0_in.numel()

    if adjoint_seminorm and adj_kind == "adaptive":
        # Augmented flat layout: [y (N), a_y (N), a_params..., a_t], or
        # interpolated [a_y (N), a_params..., a_t].
        n_ctl = N if interpolated else 2 * N

        def _seminorm(x_flat):
            return rms_norm(x_flat[:n_ctl])

        bwd_options.setdefault("norm", _seminorm)

    cfg = {"call": call, "grad_targets": grad_targets,
           "params_of": params_of, "forward_solver": forward_solver,
           "rtol": rtol, "atol": atol, "method": method,
           "fwd_options": fwd_options, "adjoint_rtol": adjoint_rtol,
           "adjoint_atol": adjoint_atol, "adjoint_method": adjoint_method,
           "bwd_options": bwd_options, "walk": walk,
           "nfe_meter": nfe_meter, "interpolated": interpolated,
           "fused_dense": use_fuse and interpolated
           and forward_solver is None,
           # _nan_on_failed_forward (ops/doublefloat only): a failed
           # forward gives NaN gradients instead of raising.
           "nan_on_failed_forward": bool(_nan_on_failed_forward)}
    t_in = t if isinstance(t, Tensor) else torch.as_tensor(t)
    if t_in.ndim == 0:
        t_in = t_in[None]
    ys = _Adjoint.apply(cfg, y0_in, t_in, *leaves)
    if nest:
        ys = unravel(ys)
    if return_stats:
        return ys, cfg["stats"]
    return ys


#: Forward options `fast.solve_fused(dense_output=True)` honours (the
#: reference's `_build_fused_forward`); any other one beside the dense
#: output runs the generic forward, as tier 2 does.
_DENSE_FUSE_OPTS = frozenset({"first_step", "max_num_steps", "safety",
                              "ifactor", "dfactor", "dense_output"})


def _forward_solve(cfg, y0: Tensor, t: Tensor, leaves):
    """The internal forward of `_Adjoint`: the generic solve with the
    forward options (dense output included for 'interpolated'), or with
    `fuse` and 'interpolated' the fused solve that keeps K2's interpolants
    (tier 2's forward, reference `adjoint.py:610-663`). Dynamics, states or
    options outside the fused subset warn, add 1 to `fast.fuse_fallbacks`
    and run the generic solve."""
    import warnings

    from . import fast
    from .ops.plan_bridge import FusionError

    def f(tt, yy):
        return cfg["call"](tt, yy, leaves)

    opts = cfg["fwd_options"]
    if cfg["fused_dense"]:
        try:
            unsupported = set(opts) - _DENSE_FUSE_OPTS
            if unsupported:
                raise FusionError(f"options {sorted(unsupported)} are not "
                                  "supported by the fused kernel")
            if not (isinstance(y0, Tensor) and y0.ndim == 2):
                raise FusionError("fused forward needs a single [B, D] "
                                  "tensor state")
            if not all(isinstance(x, (int, float)) or (
                    isinstance(x, Tensor) and x.ndim == 0)
                    for x in (cfg["rtol"], cfg["atol"])):
                raise FusionError("per-leaf tolerance pytrees are not "
                                  "supported by the fused kernel")
            return fast.solve_fused(
                f, y0, t, rtol=cfg["rtol"], atol=cfg["atol"],
                method=cfg["method"], first_step=opts.get("first_step"),
                max_num_steps=opts.get("max_num_steps"),
                safety=float(opts.get("safety", 0.9)),
                ifactor=float(opts.get("ifactor", 10.0)),
                dfactor=float(opts.get("dfactor", 0.2)), dense_output=True)
        except FusionError as e:
            fast.fuse_fallbacks += 1
            warnings.warn("odeint_adjoint(options={'fuse': True}): forward "
                          f"runs the generic engine — {e}", stacklevel=4)
    return solve(f, y0, t, rtol=cfg["rtol"], atol=cfg["atol"],
                 method=cfg["method"], options=opts)


def _fused_tiers(func, params, y0, t, rtol, atol, method,
                 adjoint_rtol, adjoint_atol, adjoint_method,
                 adjoint_seminorm, fwd_options, bwd_options, walk,
                 per_sample, return_stats, nfe_meter):
    """`options={'fuse': True}`'s tier 1 (`fast.odeint_adjoint_fused`), or
    with per_sample and unfusable dynamics the generic adjoint a sample at
    a time; None sends the caller on to tier 2 (the fused forward with the
    generic backward)."""
    import warnings

    from . import fast
    from .ops.plan_bridge import FusionError

    fwd = {k: v for k, v in fwd_options.items() if k != "fuse"}
    kinds_ok = (_kind(method) in ("adaptive", "fixed")
                and _kind(adjoint_method) in ("adaptive", "fixed"))
    fwd_allowed = (_FULL_FUSE_OPTS if _kind(method) == "adaptive"
                   else _FULL_FUSE_FIXED_OPTS)
    bwd_allowed = (_FULL_FUSE_OPTS if _kind(adjoint_method) == "adaptive"
                   else _FULL_FUSE_FIXED_OPTS)
    # Options tier 1 would otherwise change: a fixed adjoint's step_size
    # walk, or a backward max_num_steps other than the forward's (the fused
    # front end carries one budget for both sweeps).
    faithful = (walk is None and bwd_options.get(
        "max_num_steps", fwd.get("max_num_steps"))
        == fwd.get("max_num_steps"))
    scalar_tols = all(isinstance(x, (int, float)) or (
        isinstance(x, Tensor) and x.ndim == 0)
        for x in (rtol, atol, adjoint_rtol, adjoint_atol))
    if not (kinds_ok and faithful and scalar_tols
            and not set(fwd) - fwd_allowed
            and not set(bwd_options) - bwd_allowed):
        return None
    if params is not None:
        def user(tt, yy, pp):
            return func(tt, yy, pp)
    else:
        def user(tt, yy, pp):
            return func(tt, yy)
    try:
        f3, y0f, rebuild = user, y0, None
        parts = fast.tree_state_parts(y0)
        if parts is not None:
            y0f, to_bd, from_bd, rebuild = parts

            def f3(tt, yy, pp):
                return to_bd(user(tt, from_bd(yy), pp))
        out = fast.odeint_adjoint_fused(
            f3, y0f, t, params=params if params is not None else (),
            rtol=rtol, atol=atol, adjoint_rtol=adjoint_rtol,
            adjoint_atol=adjoint_atol, method=method,
            adjoint_method=adjoint_method,
            adjoint_seminorm=adjoint_seminorm,
            max_num_steps=fwd.get("max_num_steps"),
            first_step=fwd.get("first_step"),
            adjoint_first_step=bwd_options.get("first_step"),
            num_steps=fwd.get("num_steps"), step_size=fwd.get("step_size"),
            adjoint_num_steps=bwd_options.get("num_steps"),
            nfe_meter=nfe_meter, return_stats=return_stats,
            per_sample=per_sample)
        if rebuild is not None:
            out = ((rebuild(out[0]),) + tuple(out[1:]) if return_stats
                   else rebuild(out))
        return out
    except FusionError as e:
        fast.fuse_fallbacks += 1
        if not per_sample:
            warnings.warn(
                "odeint_adjoint(options={'fuse': True}): full two-kernel "
                f"fusion unavailable — {e}; using a fused forward with the "
                "generic backward", stacklevel=3)
            return None
        warnings.warn(
            "odeint_adjoint(options={'fuse': True, 'per_sample': True}): "
            f"per-sample fusion unavailable — {e}; running the generic "
            "adjoint a sample at a time", stacklevel=3)
    # Per-sample semantics survive the fallback: every sample its own
    # generic solve in both sweeps (the reference's vmap, adjoint.py:365).
    if not (isinstance(y0, Tensor) and y0.ndim == 2):
        raise ValueError("options={'per_sample': True} needs a [B, D] "
                         "tensor state")
    opts = {k: v for k, v in fwd.items() if k not in ("per_sample",)}
    bopts = {k: v for k, v in bwd_options.items() if k != "per_sample"}
    outs = [odeint_adjoint(func, y0[b:b + 1], t, params=params, rtol=rtol,
                           atol=atol, method=method, options=opts or None,
                           adjoint_rtol=adjoint_rtol,
                           adjoint_atol=adjoint_atol,
                           adjoint_method=adjoint_method,
                           adjoint_options=bopts,
                           adjoint_seminorm=adjoint_seminorm,
                           return_stats=True, nfe_meter=nfe_meter)
            for b in range(y0.shape[0])]
    ys = torch.cat([o[0] for o in outs], dim=1)
    if return_stats:
        st = [o[1] for o in outs]
        return ys, SolverStats(sum(x.nfe for x in st),
                               sum(x.n_accepted for x in st),
                               sum(x.n_rejected for x in st),
                               max(x.status for x in st))
    return ys
