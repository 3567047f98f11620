"""`odeint` front-end: validate inputs, dispatch to a solver, integrate.

Counterpart of `tfdiffeq_tpu/odeint.py` for the five adaptive RK methods
(dopri5, bosh3, adaptive_heun, tsit5, dopri8), the four fixed-grid ones
(euler, midpoint, rk4, rk4_38), the Adams family (explicit_adams,
fixed_adams, adams) and the hypersolvers (hyper_euler, hyper_midpoint,
hyper_heun): same signature, defaults (rtol=1e-7,
atol=1e-9, method='dopri5') and `SOLVERS` names, tensor or tuple/dict
state, reverse time, per-leaf tolerances.

Options of the fixed-grid methods: ``grid_constructor``, ``step_size`` and
``num_steps`` (`solvers/fixed_grid.py`); tolerances do not apply to them.

Options of the adaptive methods, against the reference's allowlist:

- honoured: ``first_step``, ``safety``, ``ifactor``, ``dfactor``,
  ``pcoeff``, ``icoeff``, ``dt_min``, ``max_num_steps``, ``norm`` ('rms',
  'max' or a callable);
- accepted and ignored (documented no-ops): ``loop``, ``unroll`` and
  ``chunk_size`` shape the reference's XLA loop. The eager loop here exits
  when the integration is done and autograd differentiates it as it
  stands, so no loop mode, unrolling or checkpoint chunking is needed.
  ``loop`` must still name a mode of the reference ('while' or 'bounded');
- refused with ValueError: ``max_steps``, the reference's static step
  budget for its bounded XLA loop. There is no such budget here (the
  default is unlimited); ``max_num_steps`` caps the attempts;
- ``per_sample``: one generic adaptive solve a sample of a [B, D] state,
  each with its own step controller (the reference's `_per_sample_vmap`
  route, a loop over the batch here); stats sum the samples' counts and
  take the largest status, and `lane_stats` holds each sample's. The
  fused per-sample kernel is `fast.solve_mlp_spec(per_sample=True)`;
- ``fuse``: the reference's `_try_fused` route: the dynamics are captured
  into a plan and solved by one whole-solve kernel launch (K14 inside K2,
  K5 with ``per_sample``, K8 for the fixed-grid methods, K10 and K11 for
  the Adams family; `fast.solve_fused`), with the reference's option
  allowlists (``first_step``, ``max_num_steps``, ``safety``, ``ifactor``,
  ``dfactor``, ``loop``, ``per_sample`` and ``dot_precision`` for the
  adaptive methods; ``step_size``, ``num_steps`` and ``dot_precision`` for
  the fixed-grid ones) and tuple or dict states through
  `fast.tree_state_adapter`. Dynamics or options outside the fused subset
  (a FusionError, raised while the plan is captured, before any launch)
  warn, add 1 to `fast.fuse_fallbacks` and run the generic engine (the
  per-sample loop below with ``per_sample``); a reduced ``dot_precision``
  that does not fuse raises ValueError. A failed build or launch raises;
- ``dense_output``: `SolveResult.dense` holds a `DenseOutput` with every
  accepted step's interpolant (`eval_flat(t)` evaluates the flat state
  anywhere in [t[0], t[-1]]; the interpolated adjoint runs on it), in tau
  space with the caller's sign stamped on;
- ``telemetry``: `SolveResult.telemetry` holds a `StepTelemetry` with
  every attempt's start, clamped step and acceptance.
  Both need the reference's bounded loop: with ``loop='while'`` they raise
  its ValueError. Beside ``fuse`` they run the generic engine, as any
  option outside the fused allowlist does (the fused dense output is
  `fast.solve_fused(dense_output=True)`).

Options of the Adams family, registered by `solvers/fixed_adams.py` and
`solvers/adams.py` with the reference's allowlists: ``max_order`` and
``max_iters`` (the corrector iterations of ``fixed_adams``) beside the
fixed-grid options for ``explicit_adams`` / ``fixed_adams``; ``max_order``,
``first_step``, ``safety``, ``ifactor``, ``dfactor``, ``max_num_steps``
and ``norm`` (a callable) for the VCABM ``adams``. With ``fuse`` they run
K10 (``step_size``, ``num_steps``, ``max_order``, ``max_iters``) or K11
(``max_order``, ``first_step``, ``safety``, ``ifactor``, ``dfactor``,
``max_num_steps``); a reduced ``dot_precision`` raises ValueError there.

The hypersolvers (``hyper_euler``, ``hyper_midpoint``, ``hyper_heun``,
`solvers/hyper.py`) take ``hypernet`` with the fixed-grid options; with
``fuse`` the dynamics and the hypernet both run as plans in one K12 launch
(`fast.solve_hyper`: ``hypernet``, ``step_size``, ``num_steps``; a
[B, D] or [D] tensor state). No method falls back to another path.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .ops import tableaus
from .ops.controller import StepController
from .ops.norms import max_norm
from .ops.pytree import flatten_state, tree_leaves
from .solvers.adaptive import AdaptiveConfig, solve_adaptive
from .solvers.base import (ADAPTIVE_OPTIONS, FIXED_GRID_OPTIONS,
                           SolveResult, SolverStats, Status, canonicalize,
                           check_options)
from .solvers.fixed_grid import build_grid_from_options, solve_fixed_grid

#: Public solver registry: name -> (kind, implementation).
SOLVERS = {**{name: ("fixed", tab)
              for name, tab in tableaus.FIXED_TABLEAUS_BY_NAME.items()},
           **{name: ("adaptive", tab)
              for name, tab in tableaus.TABLEAUS_BY_NAME.items()}}

#: Option allowlists of solvers added with `register_solver`.
_CUSTOM_ALLOWED = {}

#: Options the fused whole-solve kernels honour (reference odeint.py:103-121);
#: any other option beside 'fuse' runs the generic engine.
_FUSABLE_OPTIONS = frozenset({"first_step", "max_num_steps", "safety",
                              "ifactor", "dfactor", "loop", "per_sample",
                              "dot_precision"})
_FUSABLE_FIXED_OPTIONS = frozenset({"step_size", "num_steps",
                                    "dot_precision"})
_ADAMS = frozenset({"adams", "explicit_adams", "fixed_adams"})
_FUSABLE_ADAMS_OPTIONS = frozenset({"step_size", "num_steps", "max_order",
                                    "max_iters"})
_FUSABLE_VCABM_OPTIONS = frozenset({"max_order", "first_step", "safety",
                                    "ifactor", "dfactor", "max_num_steps"})
_HYPER = frozenset({"hyper_euler", "hyper_midpoint", "hyper_heun"})
_FUSABLE_HYPER_OPTIONS = frozenset({"hypernet", "step_size", "num_steps"})

#: Reference loop options with no counterpart in an eager loop.
_NO_OP_OPTIONS = frozenset({"loop", "unroll", "chunk_size"})


def register_solver(name: str, kind: str, impl, allowed=None) -> None:
    """Register a custom solver `impl(prob, options, rtol, atol)`; `allowed`
    is its option allowlist (default: the adaptive one)."""
    SOLVERS[name] = (kind, impl)
    if allowed is not None:
        _CUSTOM_ALLOWED[name] = frozenset(allowed)


def _resolve_tolerance(tol, y0):
    """A scalar passes through; a nest matching y0 is broadcast leaf-wise
    and aligned with the canonical state."""
    if isinstance(tol, (int, float)) or (isinstance(tol, torch.Tensor)
                                         and tol.ndim == 0):
        return tol
    if isinstance(y0, torch.Tensor):
        return torch.broadcast_to(
            torch.as_tensor(tol, dtype=y0.dtype, device=y0.device), y0.shape)
    leaves = tree_leaves(y0)
    tol_leaves = tree_leaves(tol)
    if len(tol_leaves) != len(leaves):
        raise ValueError("tolerance nest does not match the state")
    flat, _ = flatten_state([torch.broadcast_to(
        torch.as_tensor(tl, dtype=yl.dtype, device=yl.device), yl.shape)
        for tl, yl in zip(tol_leaves, leaves)])
    return flat


def _allowed_options(method: str) -> frozenset:
    kind = SOLVERS[method][0]
    if kind == "fixed":
        return FIXED_GRID_OPTIONS
    return _CUSTOM_ALLOWED.get(method, ADAPTIVE_OPTIONS)


def _check_method_options(method: str, options: dict) -> None:
    if method not in SOLVERS:
        raise ValueError(f"Unknown method {method!r}; available: "
                         f"{sorted(SOLVERS)}")
    allowed = _allowed_options(method)
    if "max_steps" in options and "max_steps" in allowed:
        raise ValueError(
            "options['max_steps'] is the reference's static step budget for "
            "its bounded XLA loop and has no meaning in the eager loop; use "
            "options['max_num_steps'] to cap the attempts")
    if "loop" in allowed and options.get("loop", "while") not in (
            "while", "bounded"):
        raise ValueError(f"unknown loop mode {options['loop']!r} "
                         "(expected 'while' or 'bounded')")


def _check_bounded(options: dict, loop: str) -> None:
    """The reference's refusals (odeint.py:360-363, :374-378): telemetry
    and dense output need its bounded loop."""
    if loop == "bounded":
        return
    if options.get("telemetry"):
        raise ValueError("options={'telemetry': True} requires the bounded "
                         "loop (per-attempt history needs a static step "
                         "budget)")
    if options.get("dense_output"):
        raise ValueError("options={'dense_output': True} requires the "
                         "bounded loop (per-step interpolants need a static "
                         "step budget)")


def _per_sample(func: Callable, y0, t, rtol, atol, method: str,
                options: dict) -> SolveResult:
    """One generic adaptive solve a sample, each of the [1, D] state
    y0[b:b + 1] under its own step controller (the reference's
    `_per_sample_vmap`). Scalar stats sum the samples' counts and take the
    largest status; lane_stats holds each sample's as [B] int32 tensors."""
    if SOLVERS[method][0] != "adaptive":
        raise ValueError("options={'per_sample': True} applies to adaptive "
                         "methods only")
    if not (isinstance(y0, torch.Tensor) and y0.ndim == 2):
        raise ValueError("per_sample needs a [B, D] tensor state")
    res = [solve(func, y0[b:b + 1], t, rtol=rtol, atol=atol, method=method,
                 options=options) for b in range(y0.shape[0])]
    lanes = torch.tensor([list(r.stats) for r in res],
                         dtype=torch.int32).t()
    stats = SolverStats(*(int(x) for x in lanes[:3].sum(dim=1)),
                        int(lanes[3].max()))
    return SolveResult(torch.cat([r.ys for r in res], dim=1), stats,
                       lane_stats=SolverStats(*lanes))


def _try_fused(func, y0, t, rtol, atol, method: str, options: dict,
               kind: str) -> Optional[SolveResult]:
    """The fused solve of `fast.solve_fused` (reference odeint.py:130);
    None when the dynamics or options fall outside the fused subset (a
    warning names the reason, `fast.fuse_fallbacks` counts it), and the
    per-sample generic route when `per_sample` asked for it."""
    import warnings

    from . import fast
    from .ops.plan_bridge import FusionError

    prec = options.get("dot_precision", "highest")
    try:
        if prec != "highest" and method in _ADAMS:
            raise ValueError(
                f"dot_precision={prec!r} is not supported on the Adams "
                "kernels (their corrector/order machinery assumes "
                "f32-accurate dots); use an RK method")
        if kind == "adaptive":
            allowed = _FUSABLE_OPTIONS
        elif method == "adams":
            allowed = _FUSABLE_VCABM_OPTIONS
        elif method in _ADAMS:
            allowed = _FUSABLE_ADAMS_OPTIONS
        elif method in _HYPER:
            allowed = _FUSABLE_HYPER_OPTIONS
        else:
            allowed = _FUSABLE_FIXED_OPTIONS
        unsupported = set(options) - allowed
        if unsupported:
            raise FusionError(f"options {sorted(unsupported)} are not "
                              "supported by the fused kernel")
        for tol in (rtol, atol):
            if not (isinstance(tol, (int, float)) or (
                    isinstance(tol, torch.Tensor) and tol.ndim == 0)):
                raise FusionError("per-leaf tolerance pytrees are not "
                                  "supported by the fused kernel")
        if method in _HYPER:
            # The hypernet's [y; f] input is defined on the flat feature
            # axis, so the hypersolvers take tensor states only.
            if not (isinstance(y0, torch.Tensor) and y0.ndim in (1, 2)):
                raise FusionError("fused hypersolvers need a [B, D] (or "
                                  "[D]) tensor state")
            hypernet = options.get("hypernet")
            if hypernet is None:
                raise ValueError(
                    f"method {method!r} requires options={{'hypernet': g}}")
            return fast.solve_hyper(func, hypernet, y0, t, method=method,
                                    num_steps=options.get("num_steps"),
                                    step_size=options.get("step_size"))
        rebuild = None
        adapted = fast.tree_state_adapter(func, y0)
        if adapted is not None:
            func, y0, rebuild = adapted
        if method == "adams":
            res = fast.solve_fused(
                func, y0, t, rtol=rtol, atol=atol, method=method,
                max_num_steps=options.get("max_num_steps"),
                first_step=options.get("first_step"),
                safety=float(options.get("safety", 0.9)),
                ifactor=float(options.get("ifactor", 10.0)),
                dfactor=float(options.get("dfactor", 0.2)),
                max_order=int(options.get("max_order", 12)))
        elif method in _ADAMS:
            res = fast.solve_fused(
                func, y0, t, rtol=rtol, atol=atol, method=method,
                num_steps=options.get("num_steps"),
                step_size=options.get("step_size"),
                max_order=int(options.get("max_order", 4)),
                max_iters=int(options.get("max_iters", 4)))
        elif kind == "fixed":
            res = fast.solve_fused(
                func, y0, t, method=method,
                num_steps=options.get("num_steps"),
                step_size=options.get("step_size"), dot_precision=prec)
        else:
            res = fast.solve_fused(
                func, y0, t, rtol=rtol, atol=atol, method=method,
                max_num_steps=options.get("max_num_steps"),
                first_step=options.get("first_step"),
                safety=float(options.get("safety", 0.9)),
                ifactor=float(options.get("ifactor", 10.0)),
                dfactor=float(options.get("dfactor", 0.2)),
                per_sample=bool(options.get("per_sample", False)),
                dot_precision=prec)
        if rebuild is not None:
            res = SolveResult(rebuild(res.ys), res.stats,
                              lane_stats=res.lane_stats)
        return res
    except FusionError as e:
        if prec != "highest":
            raise ValueError(
                f"options={{'dot_precision': {prec!r}}} requires the fused "
                f"kernel, but fusion failed: {e}") from e
        fast.fuse_fallbacks += 1
        if (kind == "adaptive" and options.get("per_sample")
                and isinstance(y0, torch.Tensor) and y0.ndim == 2):
            warnings.warn(
                "odeint(options={'fuse': True, 'per_sample': True}): "
                f"falling back to a generic solve a sample — {e}",
                stacklevel=3)
            opts = {k: v for k, v in options.items()
                    if k not in ("per_sample", "loop")}
            return _per_sample(func, y0, t, rtol, atol, method, opts)
        warnings.warn(f"odeint(options={{'fuse': True}}): falling back to "
                      f"the generic engine — {e}", stacklevel=3)
        return None


def solve(func: Callable, y0: Any, t, *, rtol=1e-7, atol=1e-9,
          method: Optional[str] = None,
          options: Optional[dict] = None) -> SolveResult:
    """Integrate dy/dt = func(t, y); return the trajectory and solver stats.

    y0 is a tensor (any shape, on any device) or a tuple/dict nest of them;
    t is a 1-D sequence of strictly monotonic times. ys has a new leading
    time axis and lives on y0's device; stats are host integers.
    """
    method = method or "dopri5"
    options = dict(options or {})
    _check_method_options(method, options)
    kind, impl = SOLVERS[method]
    if options.get("fuse") and kind not in ("adaptive", "fixed") \
            and method not in _ADAMS and method not in _HYPER:
        raise ValueError("options={'fuse': True} is not supported for "
                         f"method {method!r} (custom registered solvers run "
                         "the generic engine)")
    prec = options.pop("dot_precision", "highest")
    if prec != "highest" and not options.get("fuse"):
        raise ValueError(
            "options={'dot_precision': ...} requires the fused kernel: pass "
            "options={'fuse': True, 'dot_precision': ...}")
    options = check_options(options, _allowed_options(method))
    if options.pop("fuse", False):
        res = _try_fused(func, y0, t, rtol, atol, method,
                         dict(options, dot_precision=prec)
                         if prec != "highest" else options, kind)
        if res is not None:
            return res
    loop = options.get("loop")
    for key in _NO_OP_OPTIONS:
        options.pop(key, None)
    if options.pop("per_sample", False):
        # The reference's vmap runs each sample on its while loop unless
        # told otherwise, and keeps no sample's telemetry or dense output.
        _check_bounded(options, loop or "while")
        return _per_sample(func, y0, t, rtol, atol, method, options)

    prob = canonicalize(func, y0, t)
    rtol = _resolve_tolerance(rtol, y0)
    atol = _resolve_tolerance(atol, y0)

    if kind == "fixed":
        grid = build_grid_from_options(t, options, prob)
        result = solve_fixed_grid(prob, impl, grid=grid)
    elif kind == "adaptive":
        ctrl = StepController(
            safety=float(options.get("safety", 0.9)),
            ifactor=float(options.get("ifactor", 10.0)),
            dfactor=float(options.get("dfactor", 0.2)),
            icoeff=float(options.get("icoeff", 1.0)),
            pcoeff=float(options.get("pcoeff", 0.0)))
        _check_bounded(options, loop or "bounded")
        norm = options.get("norm")
        if norm == "max":
            norm = max_norm
        elif norm == "rms":
            norm = None            # the default
        elif isinstance(norm, str):
            raise ValueError(f"unknown norm {norm!r}: expected 'rms', "
                             "'max', or a callable")
        cfg = AdaptiveConfig(
            tableau=impl, controller=ctrl, norm=norm,
            telemetry=bool(options.get("telemetry", False)),
            emit_dense=bool(options.get("dense_output", False)))
        result = solve_adaptive(prob, cfg, rtol, atol,
                                first_step=options.get("first_step"),
                                dt_min=options.get("dt_min"),
                                max_num_steps=options.get("max_num_steps"))
    else:  # custom registered solver
        result = impl(prob, options, rtol, atol)

    ys = result.ys if prob.native else prob.unravel(result.ys)
    dense = result.dense
    if dense is not None:
        # Rows are in tau space with the solver's sign (+1): stamp the
        # caller's, so that eval_flat maps user times.
        dense = dense._replace(sign=prob.sign)
    return SolveResult(ys, result.stats, result.telemetry, dense)


def odeint(func: Callable, y0: Any, t, *, rtol=1e-7, atol=1e-9,
           method: Optional[str] = None,
           options: Optional[dict] = None) -> Any:
    """Reference-compatible front-end: returns the trajectory, whose leaves
    have a new leading time axis (ys[0] == y0). A failed solve raises
    RuntimeError; use `solve` for partial results and stats."""
    res = solve(func, y0, t, rtol=rtol, atol=atol, method=method,
                options=options)
    if res.stats.status != Status.OK:
        raise RuntimeError(
            f"odeint solver failed with status "
            f"{Status(res.stats.status).name}; raise "
            "options['max_num_steps'] or loosen tolerances. Use solve() to "
            "get partial results and stats instead of raising.")
    return res.ys
