"""Adaptive-step embedded RK engine (dopri5, bosh3, adaptive_heun, tsit5,
dopri8).

Counterpart of `tfdiffeq_tpu/solvers/adaptive.py` in its while-loop mode.
The accept/reject loop is an eager host loop: each attempt evaluates the
stages on the state's device, brings the error ratio and a finiteness flag
to the host (one synchronisation per attempt), and runs the controller on
0-d host tensors. Attempt semantics are those of the reference's
`_make_attempt`: the last step is clamped to the end time, the controller
rescales the clamped step, state accumulation is Kahan-compensated, and
the dense output (quartic through the 4th-order midpoint, else cubic
Hermite) is evaluated at every requested time the accepted step covers,
exactly at its end. Status rules are the reference's (adaptive.py:175-184).

`telemetry` records every attempt (`StepTelemetry`: start, clamped step,
accepted; all active, since the eager loop has no static budget), and
`emit_dense` keeps every accepted step's interpolant (`DenseOutput`, one
row a step) for post-hoc evaluation and the interpolated adjoint. The
reference's bounded loop keeps a row per attempt of its budget, rejected
and inactive ones repeating the last accepted step, so its `eval_flat`
gives the same values.

The loop is differentiable with autograd as it stands; the reference's
XLA loop knobs (`loop`, `unroll`, `chunk_size`, `max_steps`) therefore
have no counterpart in `AdaptiveConfig` (see odeint.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ops.controller import StepController, next_step_size
from ..ops.norms import error_ratio, rms_norm, select_initial_step
from ..ops.rk import (interp_evaluate, interp_fit, interp_fit_quartic,
                      kahan_add, runge_kutta_step)
from ..ops.tableaus import ButcherTableau
from .base import (CanonicalProblem, DenseOutput, SolveResult, SolverStats,
                   Status, StepTelemetry)

Tensor = torch.Tensor

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Static solver configuration."""
    tableau: ButcherTableau
    controller: StepController = StepController()
    norm: Optional[Callable[[Tensor], Tensor]] = None
    # Fused one-step kernel for known dynamics (fast.solve_mlp_stepwise):
    # step_override(t, y, f, dt) -> (y1, f1, err_ratio, y_mid, n_evals)
    # replaces runge_kutta_step, the error norm and the midpoint; err_ratio
    # is a 0-d tensor, +inf when the step is non-finite.
    step_override: Optional[Callable] = None
    # Per-attempt telemetry (SolveResult.telemetry, a StepTelemetry).
    telemetry: bool = False
    # Every accepted step's interpolant (SolveResult.dense, a DenseOutput).
    emit_dense: bool = False


def default_dt_min(tau: Tensor) -> Tensor:
    """Span-scaled minimum step: 4 eps * max(|tau0|, |tau_end|, 1)."""
    span = max(abs(float(tau[0])), abs(float(tau[-1])), 1.0)
    return (4.0 * torch.finfo(tau.dtype).eps
            * torch.tensor(span, dtype=tau.dtype))


def _ratio_and_finite(ratio: Tensor, finite: Tensor):
    """Bring the error ratio and the finiteness flag to the host in one
    transfer (the attempt's only synchronisation)."""
    both = torch.stack([ratio.to(torch.float64), finite.to(torch.float64)])
    r, fin = both.cpu().tolist()
    return torch.tensor(r, dtype=ratio.dtype), bool(fin)


def solve_adaptive(prob: CanonicalProblem, cfg: AdaptiveConfig, rtol, atol,
                   first_step=None, dt_min=None,
                   max_num_steps=None) -> SolveResult:
    """Integrate the canonical problem; returns ys [T, *state] on the state's
    device and host-integer stats."""
    tab = cfg.tableau
    tau = prob.tau
    y0 = prob.y0
    dev = y0.device
    rdt = torch.empty((), dtype=prob.dtype).real.dtype
    rtol = torch.as_tensor(rtol, dtype=rdt).to(dev)
    atol = torch.as_tensor(atol, dtype=rdt).to(dev)
    tau_end = tau[-1]
    if dt_min is None:
        dt_min = default_dt_min(tau)
    dt_min = torch.as_tensor(dt_min, dtype=prob.time_dtype)
    max_num_steps = (_INT32_MAX if max_num_steps is None
                     else int(max_num_steps))
    T = tau.shape[0]
    tel, rows = [], []

    def result(out, stats):
        return SolveResult(out, stats, _telemetry(tel, prob.time_dtype)
                           if cfg.telemetry else None,
                           _dense(rows, tau[0], y0, prob.time_dtype)
                           if cfg.emit_dense else None)

    if T == 1:
        return result(y0[None].clone(), SolverStats(0, 0, 0, 0))

    # Initial state (reference `_init_core`).
    t = tau[0]
    f = prob.func(t, y0)
    nfe = 1
    if first_step is None:
        # The step size is controller state: gradients take the realized
        # steps as fixed (the reference's stop_gradient on dt0).
        dt = select_initial_step(prob.func, t, y0, f, tab.order - 1, rtol,
                                 atol, cfg.norm).detach().cpu().to(
                                     prob.time_dtype)
        nfe += 1
    else:
        # Clamp to dt_min: dt = 0 would be accepted forever without
        # progress.
        dt = torch.maximum(
            torch.abs(torch.as_tensor(first_step, dtype=prob.time_dtype)),
            dt_min)
    y = y0
    comp = torch.zeros_like(y0)
    prev_ratio = torch.tensor(1.0, dtype=prob.time_dtype)
    n_acc = n_rej = 0
    status = Status.OK
    norm = cfg.norm or rms_norm
    big = torch.tensor(2.0 ** 20, dtype=rdt)

    out = torch.zeros((T,) + tuple(y0.shape), dtype=prob.dtype, device=dev)
    out[0] = y0

    while bool(t < tau_end) and status == Status.OK:
        rem = tau_end - t
        is_last = bool(dt >= rem)
        t1 = tau_end if is_last else t + torch.minimum(dt, rem)
        dt_step = t1 - t
        dt_y = dt_step.to(prob.dtype)

        if cfg.step_override is not None:
            y1, f1, ratio_d, y_mid, n_evals = cfg.step_override(
                t, y, f, dt_step)
            delta = None
            ratio, finite = _ratio_and_finite(ratio_d,
                                              torch.isfinite(ratio_d))
            coeffs = None
        else:
            res = runge_kutta_step(prob.func, y, f, t, dt_step, tab)
            y1, f1, delta, n_evals = res.y1, res.f1, res.delta, res.n_evals
            ratio_d = error_ratio(res.y_err, rtol, atol, y, y1, norm)
            ratio, finite = _ratio_and_finite(
                ratio_d, torch.all(torch.isfinite(y1))
                & torch.isfinite(ratio_d))
        accept = bool(ratio <= 1.0) and finite

        if cfg.telemetry:
            tel.append((t, dt_step, accept))
        ratio_ctrl = ratio if finite else big.to(ratio.dtype)
        dt_next, prev_ratio = next_step_size(dt_step, ratio_ctrl, prev_ratio,
                                             accept, tab.order,
                                             cfg.controller)

        n_att = n_acc + n_rej + 1
        if (status == Status.OK and not accept and bool(dt_next < dt_min)
                and bool(t + dt_next < tau_end)):
            status = Status.DT_UNDERFLOW
        if (status == Status.OK and n_att >= max_num_steps
                and not (bool(t >= tau_end) or (accept and is_last))):
            status = Status.MAX_STEPS_REACHED

        if accept:
            if cfg.step_override is not None:
                coeffs = interp_fit_quartic(y, y1, y_mid, f, f1, dt_y)
            else:
                coeffs = interp_fit(tab, y, y1, f, f1, res.k, dt_y)
            if cfg.emit_dense:
                rows.append((t, t1, dt_step, torch.stack(coeffs)))
            sel = torch.nonzero((tau > t) & (tau <= t1)).flatten()
            if sel.numel():
                tq = tau[sel]
                vals = interp_evaluate(coeffs, t, dt_step, tq)
                # Exact endpoint: no interpolation roundoff at the step end.
                at_end = (tq == t1).to(dev).reshape(
                    (-1,) + (1,) * y.ndim)
                out[sel.to(dev)] = torch.where(at_end, y1[None], vals)
            if delta is not None:       # Kahan; the fused step has none
                y, comp = kahan_add(y, comp, delta)
            else:
                y = y1
            f = f1
            t = t1
            n_acc += 1
        else:
            n_rej += 1
        dt = torch.clamp(dt_next, min=0.0)
        nfe += n_evals

    return result(out, SolverStats(nfe, n_acc, n_rej, int(status)))


def _telemetry(tel, time_dtype) -> StepTelemetry:
    """One entry per attempt taken (host tensors)."""
    t0 = torch.tensor([float(a[0]) for a in tel], dtype=time_dtype)
    dt = torch.tensor([float(a[1]) for a in tel], dtype=time_dtype)
    acc = torch.tensor([a[2] for a in tel], dtype=torch.bool)
    return StepTelemetry(t0, dt, acc, torch.ones_like(acc))


def _dense(rows, tau0: Tensor, y0: Tensor, time_dtype) -> DenseOutput:
    """One row per accepted step, the coefficients flat ([S, 5, N], the
    state's ravel order, reference adaptive.py:405-410); before any
    accepted step, the reference's initial cache (t0 = t1 = tau[0], dt = 1,
    the constant y0). The sign is +1: odeint stamps the caller's."""
    if not rows:
        z = torch.zeros_like(y0)
        rows = [(tau0, tau0, torch.ones((), dtype=time_dtype),
                 torch.stack([z, z, z, z, y0]))]
    col = lambda j: torch.stack([r[j].to(time_dtype) for r in rows])  # noqa
    coeffs = torch.stack([r[3] for r in rows])
    return DenseOutput(col(0), col(1), col(2),
                       coeffs.reshape(coeffs.shape[0], 5, -1),
                       torch.ones((), dtype=time_dtype))
