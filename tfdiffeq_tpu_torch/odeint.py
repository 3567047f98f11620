"""`odeint` front-end: validate inputs, dispatch to a solver, integrate.

Counterpart of `tfdiffeq_tpu/odeint.py` for the five adaptive RK methods
(dopri5, bosh3, adaptive_heun, tsit5, dopri8): same signature, defaults
(rtol=1e-7, atol=1e-9, method='dopri5') and `SOLVERS` names, tensor or
tuple/dict state, reverse time, per-leaf tolerances.

Options, against the reference's adaptive allowlist:

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
- not ported yet, raising NotImplementedError with the ROADMAP item that
  brings them: ``fuse`` (queue 1 item 16), ``per_sample`` (item 9),
  ``dense_output`` and ``telemetry`` (item 3, remaining engine options).

Methods that are not ported yet (fixed grid, Adams and VCABM,
hypersolvers) raise NotImplementedError naming their ROADMAP item. No
method falls back to another path.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .ops import tableaus
from .ops.controller import StepController
from .ops.norms import max_norm
from .ops.pytree import flatten_state, tree_leaves
from .solvers.adaptive import AdaptiveConfig, solve_adaptive
from .solvers.base import (ADAPTIVE_OPTIONS, SolveResult, Status,
                           canonicalize, check_options)

#: Public solver registry: name -> (kind, implementation).
SOLVERS = {name: ("adaptive", tab)
           for name, tab in tableaus.TABLEAUS_BY_NAME.items()}

#: Option allowlists of solvers added with `register_solver`.
_CUSTOM_ALLOWED = {}

#: Methods of the reference not ported yet -> the ROADMAP item that brings
#: them (ROADMAP.md, queue 1).
_NOT_PORTED_METHODS = {
    **{m: "queue 1 item 4 (solvers/fixed_grid.py)"
       for m in ("euler", "midpoint", "rk4", "rk4_38")},
    **{m: "queue 1 item 12 (Adams family)"
       for m in ("adams", "explicit_adams", "fixed_adams")},
    **{m: "queue 1 item 13 (hypersolvers)"
       for m in ("hyper_euler", "hyper_midpoint", "hyper_heun")},
}

_NOT_PORTED_OPTIONS = {
    "fuse": "queue 1 item 16 (fusion of arbitrary dynamics)",
    "per_sample": "queue 1 item 9 (per-sample tier)",
    "dense_output": "queue 1 item 3 (remaining engine options)",
    "telemetry": "queue 1 item 3 (remaining engine options)",
}

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


def _check_not_ported(method: str, options: dict) -> None:
    if method in _NOT_PORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported to PyTorch yet: ROADMAP.md "
            f"{_NOT_PORTED_METHODS[method]}")
    for key, item in _NOT_PORTED_OPTIONS.items():
        if options.get(key):
            raise NotImplementedError(
                f"options={{{key!r}: ...}} is not ported to PyTorch yet: "
                f"ROADMAP.md {item}")
    if "max_steps" in options:
        raise ValueError(
            "options['max_steps'] is the reference's static step budget for "
            "its bounded XLA loop and has no meaning in the eager loop; use "
            "options['max_num_steps'] to cap the attempts")
    if options.get("loop", "while") not in ("while", "bounded"):
        raise ValueError(f"unknown loop mode {options['loop']!r} "
                         "(expected 'while' or 'bounded')")


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
    _check_not_ported(method, options)
    if method not in SOLVERS:
        raise ValueError(f"Unknown method {method!r}; available: "
                         f"{sorted(SOLVERS)}")
    kind, impl = SOLVERS[method]
    options = check_options(options, _CUSTOM_ALLOWED.get(method,
                                                         ADAPTIVE_OPTIONS))
    for key in _NO_OP_OPTIONS:
        options.pop(key, None)

    prob = canonicalize(func, y0, t)
    rtol = _resolve_tolerance(rtol, y0)
    atol = _resolve_tolerance(atol, y0)

    if kind == "adaptive":
        ctrl = StepController(
            safety=float(options.get("safety", 0.9)),
            ifactor=float(options.get("ifactor", 10.0)),
            dfactor=float(options.get("dfactor", 0.2)),
            icoeff=float(options.get("icoeff", 1.0)),
            pcoeff=float(options.get("pcoeff", 0.0)))
        norm = options.get("norm")
        if norm == "max":
            norm = max_norm
        elif norm == "rms":
            norm = None            # the default
        elif isinstance(norm, str):
            raise ValueError(f"unknown norm {norm!r}: expected 'rms', "
                             "'max', or a callable")
        cfg = AdaptiveConfig(tableau=impl, controller=ctrl, norm=norm)
        result = solve_adaptive(prob, cfg, rtol, atol,
                                first_step=options.get("first_step"),
                                dt_min=options.get("dt_min"),
                                max_num_steps=options.get("max_num_steps"))
    else:  # custom registered solver
        result = impl(prob, options, rtol, atol)

    ys = result.ys if prob.native else prob.unravel(result.ys)
    return SolveResult(ys, result.stats)


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
